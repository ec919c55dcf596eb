"""Distributed deep reinforcement learning (survey §Distributed DRL).

The port of the JAX package's ``rl`` package.  Two tiers, one module:

* **The fleet** (`repro_torch.rl.fleet`) — the distributed architectures
  as real distributed systems on the cluster control plane: `Actor` /
  `Learner` / `ReplayService` roles over `SimTransport` (deterministic
  simulated clock) or `ProcTransport` (real child processes), launched
  by `run_fleet` or ``python -m repro_torch.launch.rl``.
* **The single-process rounds** (`repro_torch.rl.agents`) — each
  surveyed architecture's *algorithm* as a vectorized round function,
  where "workers" are a batch axis.

How the survey's architectures map to entry points:

  ref 98   GORILA      parallel Q-learning with a shared param server:
                       `gorila_round` (vectorized); distributed form =
                       `run_fleet` (actors pull stale params, learner
                       publishes versions)
  ref 100  A3C         asynchronous advantage actor-critic:
                       `a3c_round` (the workers' gradients merged)
  ref 101  IMPALA      decoupled acting/learning + V-trace off-policy
                       correction: `impala_round`; the fleet `Learner`
                       applies the same `vtrace.vtrace` to replayed
                       trajectories
  ref 102  DPPO        distributed PPO with synchronized clipped
                       updates: `dppo_round`
  ref 104  Ape-X       distributed prioritized experience replay:
                       `gorila_round(prioritized=True)` (vectorized);
                       distributed form = the fleet's sharded
                       `ReplayService` (priority-stratified shards,
                       requester-seeded sampling)

Everything is re-exported lazily so ``import repro_torch.rl`` does not
import torch until a symbol is touched.
"""
from __future__ import annotations

_EXPORTS = {
    # the distributed fleet (repro_torch.rl.fleet)
    "Actor": "fleet", "Learner": "fleet", "ReplayService": "fleet",
    "FleetResult": "fleet", "run_fleet": "fleet",
    # vectorized architecture rounds (repro_torch.rl.agents)
    "q_init": "agents", "gorila_round": "agents", "a3c_round": "agents",
    "impala_round": "agents", "dppo_round": "agents",
    "ac_init": "agents", "policy_logits": "agents",
    "greedy_q_policy": "agents",
    # environment + evaluation (repro_torch.rl.env)
    "ChainEnv": "env", "rollout": "env", "episode_return": "env",
    # off-policy machinery (repro_torch.rl.vtrace, repro_torch.rl.replay);
    # the V-trace *function* is repro_torch.rl.vtrace.vtrace — the
    # submodule keeps the name at package level
    "nstep_returns": "vtrace",
    "replay_init": "replay", "replay_add": "replay",
    "replay_sample": "replay", "replay_update_priorities": "replay",
}

_SUBMODULES = frozenset({"agents", "env", "fleet", "replay", "vtrace"})

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value     # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
