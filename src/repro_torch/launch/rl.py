"""RL fleet launcher: the Ape-X/IMPALA actor–learner loop as a CLI.

The port of the JAX package's ``launch/rl.py``.  Runs
`repro_torch.rl.fleet.run_fleet` on the cluster control plane: N actors
roll out with periodically-pulled (stale) parameters, push prioritized
trajectories to a sharded replay service, and one learner samples
V-trace-corrected batches and publishes new parameter versions —
survey refs 98 (GORILA), 101 (IMPALA), 104 (Ape-X).  The actor and
learner math runs on the CUDA card unless ``--device cpu`` is given.

The shared cluster flags (`repro_torch.launch.cli`) pick the control
plane: ``--transport sim`` (default) replays an optional
``--failure-trace`` on the deterministic simulated clock;
``--transport proc`` runs every actor, replay shard, and the learner as
a real child process — the learner trajectory is the same float for
float either way.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.rl --actors 4 \
      --replay-shards 2 --steps 40
  PYTHONPATH=src python -m repro_torch.launch.rl --device cpu \
      --transport proc --failure-trace trace.json --trace-out rl_trace.json
"""
from __future__ import annotations

import argparse

from repro_torch.launch import cli


def rl(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--actors", type=int, default=4)
    ap.add_argument("--replay-shards", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40,
                    help="fleet rounds (1.0 simulated time unit each)")
    ap.add_argument("--rollout-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16,
                    help="learner sample size per step")
    ap.add_argument("--pull-every", type=int, default=4,
                    help="actor pulls fresh params every N rollouts "
                         "(staleness bound)")
    ap.add_argument("--capacity", type=int, default=1024,
                    help="replay ring capacity per shard")
    ap.add_argument("--alpha", type=float, default=0.6,
                    help="priority exponent (Ape-X)")
    ap.add_argument("--beta", type=float, default=0.4,
                    help="importance-weight exponent")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--gamma", type=float, default=0.97)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the actor and learner math runs: the CUDA "
                         "card unless given (cpu runs the plain versions)")
    cli.add_cluster_args(ap, context="the actor–learner fleet")
    cli.add_trace_args(ap)
    args = ap.parse_args(argv)
    return cli.run_traced(args, lambda: _rl(args))


def _rl(args) -> dict:
    from repro_torch import resolve_device
    from repro_torch.rl.fleet import run_fleet

    device = resolve_device(args.device)
    trace = cli.load_failure_trace(args)
    res = run_fleet(
        actors=args.actors, replay_shards=args.replay_shards,
        steps=args.steps, rollout_len=args.rollout_len, batch=args.batch,
        pull_every=args.pull_every, capacity=args.capacity,
        alpha=args.alpha, beta=args.beta, lr=args.lr, gamma=args.gamma,
        hidden=args.hidden, seed=args.seed, device=device,
        transport=cli.make_transport(args, trace, device))

    print(f"fleet: actors={args.actors} shards={args.replay_shards} "
          f"transport={args.transport} trace="
          f"{args.failure_trace or '<failure-free>'}")
    print(f"  env_steps={res.env_steps} over {res.sim_time:.0f} sim-time "
          f"-> goodput={res.goodput:.2f} steps/time")
    print(f"  learner: {res.learner_steps} steps, published version "
          f"{res.final_version}, final loss "
          f"{res.losses[-1]:.4f}" if res.losses else
          "  learner: 0 steps (replay never filled — raise --steps "
          "or lower --batch)")
    print(f"  staleness: mean={res.staleness_mean:.2f} "
          f"max={res.staleness_max} (pull_every={args.pull_every})")
    print(f"  survivors: actors={list(res.final_actors)} "
          f"shards={list(res.final_shards)}  "
          f"greedy return={res.final_return:.3f}")
    return {"goodput": res.goodput, "losses": res.losses,
            "env_steps": res.env_steps, "learner_steps": res.learner_steps,
            "staleness_mean": res.staleness_mean,
            "staleness_max": res.staleness_max,
            "final_return": res.final_return,
            "transitions": res.transitions}


if __name__ == "__main__":
    from repro_torch.obs import log as _log
    _log.configure()  # CLI runs show [info] progress; library use stays quiet
    rl()
