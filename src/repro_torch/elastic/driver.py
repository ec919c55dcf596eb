"""Elastic run loops: deterministic fault-injection driver + LM trainer.

The port of the JAX package's ``elastic/driver.py``.  Both loops
subscribe to the `repro_torch.cluster.Coordinator` control plane
(membership, epochs, straggler telemetry, commit-step floors), the same
authority the serving fleet uses, fed by a pluggable transport: the
trace-driven simulated clock (default) or real multi-process heartbeat
workers (`--transport=proc`).

* `run_elastic`: a deterministic simulation on a controlled least-squares
  problem.  Wall clock is *simulated*: each synchronous round costs the
  straggler bound max_i(rows_i / rate_i), so goodput and recovery latency
  are exact functions of the trace, not of host noise, and equal to the
  JAX package's on the same trace.  The problem's data is numpy, made as
  the JAX package makes it, so both packages train on the same batches.

* `elastic_lm_loop`: the real training path behind
  `launch/train.py --elastic --failure-trace=...`: logical data-parallel
  workers feed disjoint pipeline shards into the launcher's train step,
  periodic checkpoints bound the blast radius, and a trace-injected death
  restores and rewinds exactly like the simulation's sync policy.

Time model: the membership machine advances on monotonically increasing
*wall steps*; the trainer's *progress step* rewinds on restore.  Recovery
latency for a failure is (simulated) time from the death transition until
progress regains its pre-death step: restore penalty plus redone work.

Both loops run on the CUDA card unless given a CPU device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
# repro_torch.cluster is imported inside the run loops: the coordinator
# imports this package's membership/straggler modules, so a top-level
# import here would cycle when repro_torch.cluster is the entry point
from repro_torch.core import data_parallel as DP
from repro_torch.core import sharding as SH
from repro_torch.elastic.membership import FailureTrace, Transition
from repro_torch.elastic.modes import MODES, ModeContext, host_flat
from repro_torch.elastic.recovery import SyncCheckpointRestore
from repro_torch.models.common import tree_map
from repro_torch.obs import log
from repro_torch.obs import recorder as obs
from repro_torch.optim.optimizers import sgd_momentum

Pytree = Any


def _merge_host_events(rec, transport) -> None:
    """Pull surviving workers' flight rings onto the recorder timeline.
    No-op for transports without per-host event streams (sim), and
    best-effort for proc: post-mortem sugar must never fail a run."""
    pull = getattr(transport, "host_events", None)
    if pull is None:
        return
    try:
        rec.merge(pull())
    except Exception as e:          # noqa: BLE001
        log.warning("[obs] host event pull failed: %s", e)


# ---------------------------------------------------------------------------
# The controlled problem (deterministic, known optimum)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ElasticProblem:
    """Least squares with per-row weights so ragged DBS splits can ride a
    rectangular (W, n_max) stack: padding rows carry weight 0.  The data
    and every batch are numpy, drawn as the JAX package draws them; the
    tensors live on `device` (the card unless the CPU is asked for)."""
    dim: int = 16
    ndata: int = 512
    noise: float = 0.01
    seed: int = 0
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        self.w_true = rng.standard_normal(self.dim).astype(np.float32)
        self.X = rng.standard_normal((self.ndata, self.dim)).astype(np.float32)
        self.y = (self.X @ self.w_true +
                  self.noise * rng.standard_normal(self.ndata)
                  ).astype(np.float32)

    def init_params(self) -> Pytree:
        return {"w": torch.zeros((self.dim,), dtype=torch.float32,
                                 device=self.device)}

    @staticmethod
    def loss_fn(params, batch):
        err = batch["x"] @ params["w"] - batch["y"]
        wt = batch["m"]
        return (wt * err ** 2).sum() / torch.clamp(wt.sum(), min=1.0)

    def full_loss(self, params) -> float:
        batch = {"x": torch.as_tensor(self.X, device=self.device),
                 "y": torch.as_tensor(self.y, device=self.device),
                 "m": torch.ones((self.ndata,), dtype=torch.float32,
                                 device=self.device)}
        return float(self.loss_fn(params, batch))

    def sample(self, worker: int, step: int, n: int, n_max: int
               ) -> Dict[str, np.ndarray]:
        """Deterministic (worker, step)-keyed batch, padded to n_max."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, worker, step]))
        idx = rng.integers(0, self.ndata, n)
        x = np.zeros((n_max, self.dim), np.float32)
        y = np.zeros((n_max,), np.float32)
        m = np.zeros((n_max,), np.float32)
        x[:n], y[:n], m[:n] = self.X[idx], self.y[idx], 1.0
        return {"x": x, "y": y, "m": m}

    def stack(self, ids: Sequence[int], step: int,
              split: Dict[int, int], K: int = 0) -> Dict[str, np.ndarray]:
        """Stacked batches: (W, n_max, ...) or (W, K, n_max, ...) when K>0.
        Ragged splits ride the rectangular stack either way: a worker with
        fewer rows pads to n_max with weight-0 rows."""
        n_max = max(split[w] for w in ids)
        if K:
            per_w = []
            for w in ids:
                ks = [self.sample(w, step * K + k, split[w], n_max)
                      for k in range(K)]
                per_w.append({key: np.stack([b[key] for b in ks])
                              for key in ks[0]})
        else:
            per_w = [self.sample(w, step, split[w], n_max) for w in ids]
        return {key: np.stack([p[key] for p in per_w]) for key in per_w[0]}


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RecoveryRecord:
    wall_step: int
    worker: int
    cause: str             # "fail" | "timeout"
    lost_steps: int        # progress rewound (sync) or 0 (continuation)
    latency: float = 0.0   # sim time from death to regained progress


@dataclasses.dataclass
class ElasticRunResult:
    mode: str
    losses: List[float]
    final_loss: float
    steps: int
    sim_time: float
    samples: int
    recoveries: List[RecoveryRecord]
    transitions: List[Transition]
    final_alive: Tuple[int, ...]
    splits_replanned: int = 0
    # local modes: the final (W', ...)-stacked per-worker params, so the
    # cross-transport suite can compare survivor rows bit-exactly
    stacked_params: Any = None
    # mode-specific observability (PS modes: server params/versions,
    # worker clocks, pushes, blocked rounds, max observed clock gap)
    mode_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def goodput(self) -> float:
        return self.samples / max(self.sim_time, 1e-9)


# ---------------------------------------------------------------------------
# The simulation driver
# ---------------------------------------------------------------------------
def run_elastic(problem: ElasticProblem, *, mode: str = "sync",
                workers: int = 4, steps: int = 120, global_batch: int = 64,
                trace: Optional[FailureTrace] = None, lr: float = 0.05,
                K: int = 4, ckpt_dir: Optional[str] = None,
                ckpt_every: int = 10, keep_last: int = 3,
                heartbeat_timeout: int = 3, restore_penalty: float = 2.0,
                straggle_threshold: float = 0.5,
                easgd_rho: float = 0.5,
                async_ckpt: bool = False,
                transport=None,
                staleness: int = 2,
                num_ps: int = 1,
                spec_slack: Optional[float] = None,
                device: DeviceLike = None) -> ElasticRunResult:
    """Run `steps` elastic training rounds under a failure trace.

    The loop is mode-agnostic: each wall step advances the coordinator,
    hands any membership change to the active `elastic.modes.TrainingMode`,
    then runs the mode's round.  The mode owns round compute, recovery,
    checkpointing, straggler response and goodput accounting; this
    function owns wall time, transitions, recovery-latency close-out and
    lifecycle.

    restore_penalty: simulated restore cost, in units of one nominal
    (failure-free, uniform-split) step time.

    async_ckpt=True moves checkpoint writes onto a background writer;
    recovery waits for the last *committed* step, so the trajectory is
    the same as with blocking saves.

    transport: a `cluster.Transport` supplying membership events (default
    `SimTransport(trace)`).  `ProcTransport(inject=trace)` runs the
    control plane against real worker processes; the trajectory is the
    same because the transition log is.  The transport is closed before
    returning.

    staleness / num_ps: the PS family's knobs (SSP's staleness window and
    the number of ParamServer shard hosts, ids workers..workers+num_ps-1).

    spec_slack: speculative execution (sync and ssp modes); None (the
    default) disables it.

    device: where the problem's tensors live; None keeps the problem's
    own device (the card unless it was made for the CPU).
    """
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.sim import SimTransport
    from repro_torch.elastic.modes import make_mode

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    tm = make_mode(mode, staleness=staleness, num_ps=num_ps)
    if tm.needs_ckpt_dir and ckpt_dir is None:
        raise ValueError(f"{mode} mode needs ckpt_dir for recovery")
    if transport is not None and trace is not None:
        # a transport brings its own event source; silently ignoring the
        # trace would run failure-free and look like valid results
        raise ValueError("pass either trace= or transport= (put the "
                         "trace inside the transport, e.g. "
                         "ProcTransport(inject=trace))")
    if device is not None and torch.device(device) != problem.device:
        problem = dataclasses.replace(problem, device=device)

    coord = Coordinator(transport or SimTransport(trace or FailureTrace()),
                        workers + tm.extra_hosts,
                        heartbeat_timeout=heartbeat_timeout)
    opt = sgd_momentum(lambda s: lr, momentum=0.0)
    ctx = ModeContext(
        problem=problem, coord=coord, opt=opt, workers=workers,
        steps=steps, global_batch=global_batch, lr=lr, K=K,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, keep_last=keep_last,
        restore_penalty=restore_penalty,
        straggle_threshold=straggle_threshold, easgd_rho=easgd_rho,
        async_ckpt=async_ckpt, staleness=staleness, num_ps=num_ps,
        spec_slack=spec_slack, nominal_t=global_batch / workers)

    # observability: spans land on the *simulated* clock, so a replayed
    # trace emits the same timeline
    orec = obs.get()
    if orec.enabled:
        orec.clock = lambda: ctx.sim_time

    # setup failures unwind before the main loop's finally is armed, so
    # close the coordinator (live ProcTransport workers) explicitly
    ids = list(coord.alive())
    try:
        tm.setup(ctx)
    except BaseException:
        tm.close()
        coord.close()
        raise

    all_transitions: List[Transition] = []
    wall = 0

    try:
        while ctx.train_step < steps:
            transitions = coord.advance(wall)
            all_transitions.extend(transitions)
            deaths = [t for t in transitions if t.kind == "death"]
            joins = [t for t in transitions if t.kind == "join"]

            new_ids = list(coord.alive())
            if not new_ids:
                raise RuntimeError(f"wall step {wall}: all workers dead")

            if deaths or joins:
                # the span brackets restore/reshard, so its duration is
                # the simulated recovery cost the mode charged
                with orec.span("recovery", cat="elastic", wall=wall,
                               deaths=[t.worker for t in deaths],
                               joins=[t.worker for t in joins]):
                    tm.on_membership_change(ctx, deaths, joins, ids,
                                            new_ids)
            ids = new_ids

            # run_round advances ctx.sim_time, so dur == this round's
            # simulated step time (straggler bound + overheads)
            with orec.span("round", cat="elastic", step=ctx.train_step,
                           wall=wall, workers=len(ids)):
                tm.run_round(ctx, ids, coord.rates())

            ctx.train_step += 1
            wall += 1

            # close out recovery latency once progress is regained
            still = []
            for rec, goal, t0 in ctx.pending:
                if ctx.train_step >= goal:
                    rec.latency = ctx.sim_time - t0
                else:
                    still.append((rec, goal, t0))
            ctx.pending = still

        for rec, goal, t0 in ctx.pending:  # ended before regaining progress
            rec.latency = ctx.sim_time - t0
        # barrier before reporting: every handed-over save is durable
        tm.wait()
        # the result surface may need the transport (PS modes pull the
        # final server state), so capture it before the teardown below
        final_params = tm.final_params()
        stacked = tm.stacked_params()
        stats = tm.mode_stats()
        if orec.enabled:
            n_samples = tm.samples(ctx)
            orec.gauge("elastic.samples", float(n_samples))
            orec.gauge("elastic.sim_time", ctx.sim_time)
            orec.gauge("elastic.goodput",
                       n_samples / max(ctx.sim_time, 1e-9))
            orec.gauge("elastic.replans", ctx.replans)
            orec.gauge("elastic.recoveries", len(ctx.recoveries))
            _merge_host_events(orec, coord.transport)
    finally:
        # never leak the writer thread (or a save still mutating
        # ckpt_dir) past an exception unwind; these closes never mask it
        tm.close()
        coord.close()  # tears down ProcTransport workers; sim: no-op

    loss_curve = [ctx.losses[s] for s in sorted(ctx.losses)]
    return ElasticRunResult(
        mode=mode, losses=loss_curve,
        final_loss=problem.full_loss(final_params), steps=steps,
        sim_time=ctx.sim_time, samples=tm.samples(ctx),
        recoveries=ctx.recoveries, transitions=all_transitions,
        final_alive=tm.visible_alive(ids), splits_replanned=ctx.replans,
        stacked_params=stacked, mode_stats=stats)


# ---------------------------------------------------------------------------
# The real LM training loops (launch/train.py --elastic --mode=...)
# ---------------------------------------------------------------------------
def _make_lm_coordinator(args, trace: FailureTrace, num_hosts: int, device):
    """The LM loops' control plane: sim replays the failure trace on the
    simulated clock; proc runs real worker processes with the trace
    injected against them (same transitions, real heartbeats)."""
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.launch.cli import make_transport

    return Coordinator(make_transport(args, trace, device), num_hosts)


def _lm_trace(args) -> FailureTrace:
    return (FailureTrace.load(args.failure_trace)
            if args.failure_trace else FailureTrace())


def _on(batch: Dict[str, np.ndarray], device,
        mesh=None) -> Dict[str, torch.Tensor]:
    """numpy -> tensors on `device`; with `mesh`, each whole on every
    rank (a replicated DTensor), as a JAX loop's host batch enters a
    step whose params are sharded."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    if mesh is None:
        return out
    return {k: SH.distribute(t, (None,) * t.dim(), mesh)
            for k, t in out.items()}


def lm_batch(cfg, batch: Dict[str, np.ndarray],
             device) -> Dict[str, torch.Tensor]:
    """The sync loop's numpy batch as its step takes it on `device`, the
    vlm and audio batches with the stub frontends' zeros, as the JAX
    loop's."""
    from repro_torch.launch.steps import make_extra
    out = _on(batch, device)
    extra = make_extra(cfg, out["tokens"].shape[0], device)
    if extra is not None:
        out["extra_embeds"] = extra
    return out


def elastic_lm_loop(*, args, cfg, step_fn, params, opt_state,
                    pipe_factory: Callable[[int, int], Any],
                    step0: int = 0, opt=None,
                    loss_fn: Optional[Callable] = None,
                    device: DeviceLike = None, mesh=None,
                    place: Optional[Callable] = None) -> Dict[str, Any]:
    """Elastic LM training over logical data-parallel workers.

    `args.mode` selects the same strategy family as `run_elastic`:

      sync (default)      global batch assembled from per-worker slices
                          through the launcher's `step_fn` (an in-place
                          update); deaths restore the last checkpoint and
                          rewind
      local_sgd / easgd   per-worker replicas through the generic
                          `core.data_parallel` rounds (needs `opt` +
                          `loss_fn`); deaths drop a replica row, no rewind
      async_ps / ssp      workers push grads / pull params against the
                          transport's ParamServer role (needs `loss_fn`);
                          server-side SGD with momentum, optional bounded
                          staleness (`args.staleness`)

    Each logical worker owns a disjoint pipeline shard.  args.transport
    selects the control plane: "sim" (default) replays the failure trace
    on the simulated clock; "proc" runs real worker processes with the
    trace injected against them.  Batches go to `device` (the card unless
    the CPU is asked for); the vlm and audio batches of the sync mode
    carry the stub frontends' zeros, as the JAX loop's do.

    Under a mesh (`mesh`, and `params` DTensors laid out on it; every
    rank of the mesh runs the loop, with the mesh active) `place` turns
    the sync mode's assembled numpy batch into the step's (the launcher
    splits it on its batch dim, JAX's `bshard`; default `lm_batch`);
    the other modes' batches are whole on every rank, as JAX's loops
    place none, and their worker-stacked rows and pulls are laid out as
    the params.  The control plane is rank 0's (`launch.cli.
    make_transport`), so every rank sees the same transitions.
    """
    device = resolve_device(device)
    mode = getattr(args, "mode", "sync")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if mode != "sync":
        if cfg.arch_type in ("vlm", "audio"):
            raise NotImplementedError(
                f"--mode={mode} supports text archs only (extra_embeds "
                f"stacking is a sync-mode feature so far)")
        if loss_fn is None:
            raise ValueError(f"--mode={mode} needs loss_fn=")
        if mode in ("local_sgd", "easgd"):
            if opt is None:
                raise ValueError(f"--mode={mode} needs opt=")
            return _lm_local_loop(args=args, mode=mode, params=params,
                                  opt=opt, loss_fn=loss_fn,
                                  pipe_factory=pipe_factory, step0=step0,
                                  device=device, mesh=mesh)
        return _lm_ps_loop(args=args, mode=mode, params=params,
                           loss_fn=loss_fn, pipe_factory=pipe_factory,
                           step0=step0, device=device, mesh=mesh)
    if place is None:
        place = lambda b: lm_batch(cfg, b, device)  # noqa: E731

    W0 = args.workers
    coord = _make_lm_coordinator(args, _lm_trace(args), W0, device)
    policy = None
    try:
        policy = SyncCheckpointRestore(args.ckpt_dir,
                                       keep_last=args.keep_last,
                                       async_save=getattr(args,
                                                          "async_ckpt",
                                                          False),
                                       coordinator=coord, host=-1)
        ckpt_every = args.ckpt_every or 20
        policy.checkpoint(step0, params, opt_state, {"arch": args.arch})
        rows_from = _lm_shard_reader(pipe_factory, W0)
    except BaseException:
        # setup failed before the loop's finally was armed: don't leak
        # live ProcTransport workers (or the ckpt writer, if it started)
        if policy is not None:
            policy.close()
        coord.close()
        raise

    losses: Dict[int, float] = {}
    recoveries: List[RecoveryRecord] = []
    train_step, wall = step0, 0

    try:
        while train_step < step0 + args.steps:
            transitions = coord.advance(wall)
            deaths = [t for t in transitions if t.kind == "death"]
            if deaths:
                with obs.get().span("recovery", cat="elastic", wall=wall,
                                    deaths=[t.worker for t in deaths]):
                    params, opt_state, restored = policy.recover(params,
                                                                 opt_state)
                lost = train_step - restored
                for d in deaths:
                    recoveries.append(
                        RecoveryRecord(wall, d.worker, d.cause, lost))
                log.info("[elastic] wall %d: worker(s) %s died (%s); "
                         "restored step %d (lost %d steps), %d survivors",
                         wall, [d.worker for d in deaths], deaths[0].cause,
                         restored, lost, len(coord.alive()))
                train_step = restored

            alive = coord.alive()
            if not alive:
                raise RuntimeError(f"wall step {wall}: all workers dead")
            split, slow = coord.plan_split(args.batch, alive=alive)
            if slow and wall % args.log_every == 0:
                log.info("[elastic] stragglers %s; split %s", list(slow),
                         [split[w] for w in alive])

            parts = [rows_from(w, split[w]) for w in alive if split[w] > 0]
            batch = place({k: np.concatenate([p[k] for p in parts], axis=0)
                           for k in parts[0]})
            # the span ends after the loss is read back, so on the card
            # it holds the whole step
            with obs.get().span("lm.step", cat="elastic", step=train_step,
                                workers=len(alive)):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                losses[train_step] = float(metrics["loss"])
            if train_step % args.log_every == 0:
                log.info("step %5d loss %.4f workers %d", train_step,
                         losses[train_step], len(alive))
            train_step += 1
            wall += 1
            if train_step % ckpt_every == 0:
                policy.checkpoint(train_step, params, opt_state,
                                  {"arch": args.arch})

        policy.checkpoint(train_step, params, opt_state,
                          {"arch": args.arch})
        policy.wait()  # barrier: the final save is durable before we return
        rec = obs.get()
        if rec.enabled:
            _merge_host_events(rec, coord.transport)
    finally:
        policy.close()  # never leak the writer past an exception unwind
        coord.close()   # tears down ProcTransport workers; sim: no-op
    return {"losses": [losses[s] for s in sorted(losses)],
            "recoveries": recoveries, "params": params,
            "opt_state": opt_state, "final_alive": coord.alive(),
            "transitions": coord.transition_log(),
            "captured_trace": coord.transport.captured_trace()}


def _lm_shard_reader(pipe_factory: Callable[[int, int], Any], W0: int):
    """Per-worker pipeline shards with lazy scale-up, shared by the LM
    loops.  Returns rows_from(wid, n) -> first n rows of that worker's
    next batch."""
    max_shards = W0 + 16
    pipes = {w: pipe_factory(w, max_shards) for w in range(W0)}
    iters = {w: iter(p) for w, p in pipes.items()}

    def rows_from(wid: int, n: int) -> Dict[str, np.ndarray]:
        if wid not in iters:
            pipes[wid] = pipe_factory(wid % max_shards, max_shards)
            iters[wid] = iter(pipes[wid])
        b = next(iters[wid])
        return {k: v[:n] for k, v in b.items()}

    return rows_from


def _lm_local_loop(*, args, mode: str, params, opt, loss_fn,
                   pipe_factory: Callable[[int, int], Any],
                   step0: int = 0, device=None,
                   mesh=None) -> Dict[str, Any]:
    """local_sgd / easgd over the real LM: per-worker replicas run the
    generic `core.data_parallel` rounds; deaths drop a replica row
    (`BoundedStalenessContinuation` / `EASGDCenterSurvival`), no rewind."""
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.elastic.modes import _stacked_init
    from repro_torch.elastic.recovery import (BoundedStalenessContinuation,
                                              EASGDCenterSurvival)
    from repro_torch.elastic.reshard import save_stacked

    W0 = args.workers
    K = 4  # local steps per communication round
    coord = _make_lm_coordinator(args, _lm_trace(args), W0, device)
    ckpt = None
    try:
        if args.ckpt_dir and getattr(args, "async_ckpt", False):
            ckpt = AsyncCheckpointer(args.ckpt_dir, keep_last=args.keep_last)
        rows_from = _lm_shard_reader(pipe_factory, W0)
        # the rows are real copies: nothing updates one replica in place
        # through another
        params_w = tree_map(
            lambda p: p.unsqueeze(0).repeat((W0,) + (1,) * p.dim()), params)
        if mode == "local_sgd":
            opt_w = _stacked_init(opt, params_w)
            policy = BoundedStalenessContinuation()
        else:
            center = params
            easgd_cfg = DP.EASGDConfig(lr=args.lr)
            policy = EASGDCenterSurvival()
    except BaseException:
        if ckpt is not None:
            ckpt.close(wait=False)
        coord.close()
        raise

    ckpt_every = args.ckpt_every or 20
    losses: Dict[int, float] = {}
    recoveries: List[RecoveryRecord] = []
    ids: Tuple[int, ...] = coord.alive()
    train_step, wall = step0, 0

    def save(step: int) -> None:
        if not args.ckpt_dir:
            return
        save_stacked(args.ckpt_dir, step, params_w, ids,
                     replicated=(center if mode == "easgd" else None),
                     metadata={"arch": args.arch, "mode": mode},
                     keep_last=args.keep_last, checkpointer=ckpt)

    try:
        while train_step < step0 + args.steps:
            transitions = coord.advance(wall)
            deaths = [t for t in transitions if t.kind == "death"]
            joins = [t for t in transitions if t.kind == "join"]
            new_ids = coord.alive()
            if not new_ids:
                raise RuntimeError(f"wall step {wall}: all workers dead")
            if deaths or joins:
                if mode == "local_sgd":
                    st = policy.apply({"params": params_w, "opt": opt_w},
                                      ids, new_ids)
                    params_w, opt_w = st["params"], st["opt"]
                else:
                    params_w, center = policy.apply(params_w, center,
                                                    ids, new_ids)
                for d in deaths:
                    recoveries.append(
                        RecoveryRecord(wall, d.worker, d.cause, 0))
                    log.info("[elastic/%s] wall %d: worker %d died (%s); "
                             "replica dropped, no rewind; %d survivors",
                             mode, wall, d.worker, d.cause, len(new_ids))
            ids = new_ids

            n = max(1, args.batch // (len(ids) * K))
            per_w = []
            for w in ids:
                ks = [rows_from(w, n) for _ in range(K)]
                per_w.append({k: np.stack([b[k] for b in ks])
                              for k in ks[0]})
            batches_wk = _on({k: np.stack([p[k] for p in per_w])
                              for k in per_w[0]}, device, mesh)
            if mode == "local_sgd":
                params_w, opt_w, metrics = DP.local_sgd_round(
                    loss_fn, params_w, opt, opt_w, batches_wk)
            else:
                params_w, center, metrics = DP.easgd_round(
                    loss_fn, params_w, center, batches_wk, easgd_cfg)
            losses[train_step] = float(SH.whole(metrics["loss"]))
            if train_step % args.log_every == 0:
                log.info("step %5d loss %.4f workers %d mode %s",
                         train_step, losses[train_step], len(ids), mode)
            train_step += 1
            wall += 1
            if train_step % ckpt_every == 0:
                save(train_step)

        save(train_step)
        if ckpt is not None:
            ckpt.wait()
        if mode == "easgd":
            final = center
        else:
            final = tree_map(lambda p: DP.worker_mean(p).to(p.dtype),
                             params_w)
    finally:
        if ckpt is not None:
            ckpt.close()
        coord.close()
    return {"losses": [losses[s] for s in sorted(losses)],
            "recoveries": recoveries, "params": final,
            "opt_state": None, "final_alive": ids,
            "transitions": coord.transition_log(),
            "captured_trace": coord.transport.captured_trace()}


def _lm_ps_loop(*, args, mode: str, params, loss_fn,
                pipe_factory: Callable[[int, int], Any],
                step0: int = 0, device=None,
                mesh=None) -> Dict[str, Any]:
    """async_ps / ssp over the real LM: workers push grads / pull params
    against the transport's ParamServer role (server-side SGD with
    momentum); ssp also bounds the clock gap through the coordinator's
    `clock_gate` (death-aware).  The PS host is membership id
    `args.workers`; its death is fatal (the model lives there).  A pull
    casts the server's fp32 entries to each leaf's dtype on the device,
    rounding to nearest even as numpy's `astype` does.  Under a mesh a
    push's gradients are made whole on every rank (rank 0 alone sends
    them), and a pull's entries, which every rank receives, are laid out
    as the params' leaves, each rank keeping its own shard."""
    from repro_torch.checkpoint import AsyncCheckpointer, save_checkpoint
    from repro_torch.checkpoint.ckpt import _flatten, _unflatten_like

    W0 = args.workers
    ps_id = W0  # one shard; lives on the extra membership slot
    staleness = (None if mode == "async_ps"
                 else int(getattr(args, "staleness", 2)))
    coord = _make_lm_coordinator(args, _lm_trace(args), W0 + 1, device)
    ckpt = None
    try:
        if args.ckpt_dir and getattr(args, "async_ckpt", False):
            ckpt = AsyncCheckpointer(args.ckpt_dir, keep_last=args.keep_last)
        rows_from = _lm_shard_reader(pipe_factory, W0)

        # structure, dtypes and layouts for the pull side
        layouts = {k: (t.dtype, t.device_mesh, t.placements)
                   if SH.is_dtensor(t) else (t.dtype, None, None)
                   for k, t in _flatten(params).items()}
        template = tree_map(lambda p: None, params)
        coord.transport.ps_open(ps_id, args.lr, host_flat(params),
                                momentum=0.9)
        gate = coord.clock_gate(staleness)
        for w in range(W0):
            gate.register(w, 0)
        credit = {w: 0.0 for w in range(W0)}
    except BaseException:
        if ckpt is not None:
            ckpt.close(wait=False)
        coord.close()
        raise

    def pull_leaf(arr, dt, on, pls):
        t = torch.from_numpy(arr).to(device).to(dt)
        if on is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, on, pls, src_data_rank=None)

    def pull_params():
        _, entries = coord.transport.ps_pull(ps_id)
        return _unflatten_like(template, {
            k: pull_leaf(entries[k], *lay) for k, lay in layouts.items()})

    ckpt_every = args.ckpt_every or 20
    n = max(1, args.batch // W0)
    losses: Dict[int, float] = {}
    recoveries: List[RecoveryRecord] = []
    blocked_rounds = 0
    train_step, wall = step0, 0
    prev_loss: Optional[float] = None

    def save(step: int, ptree) -> None:
        if not args.ckpt_dir:
            return
        meta = {"arch": args.arch, "mode": mode, "step": step}
        if ckpt is not None:
            ckpt.save(step, {"params": ptree}, meta)
        else:
            save_checkpoint(args.ckpt_dir, step, {"params": ptree}, meta,
                            keep_last=args.keep_last)

    try:
        while train_step < step0 + args.steps:
            transitions = coord.advance(wall)
            for t in transitions:
                if t.kind == "death":
                    if t.worker == ps_id:
                        raise RuntimeError(
                            f"wall step {wall}: parameter server {ps_id} "
                            f"died ({t.cause}): PS state is unreplicated")
                    credit.pop(t.worker, None)
                    recoveries.append(
                        RecoveryRecord(wall, t.worker, t.cause, 0))
                    log.info("[elastic/%s] wall %d: worker %d died (%s); "
                             "PS keeps the model, throughput drops",
                             mode, wall, t.worker, t.cause)
                elif t.kind == "join" and t.worker != ps_id:
                    gate.register(t.worker, gate.min_clock())
                    credit[t.worker] = 0.0
            workers = [w for w in coord.alive() if w != ps_id]
            if not workers:
                raise RuntimeError(f"wall step {wall}: all workers dead")

            rates = coord.rates()
            round_losses = []
            for w in sorted(workers):
                credit[w] = min(credit.get(w, 0.0) + rates.get(w, 1.0), 1.0)
                if credit[w] < 1.0:
                    continue
                if not gate.can_advance(w):
                    blocked_rounds += 1
                    continue
                credit[w] -= 1.0
                ptree = pull_params()
                loss, grads = DP.value_and_grad(
                    loss_fn, ptree, _on(rows_from(w, n), device, mesh))
                del ptree
                gflat = host_flat(grads)
                del grads
                clock = gate.advance(w)
                coord.transport.ps_push(ps_id, w, clock, gflat)
                del gflat
                round_losses.append(float(SH.whole(loss)))
            if round_losses:
                prev_loss = float(np.mean(round_losses))
            if prev_loss is not None:
                losses[train_step] = prev_loss
            if train_step % args.log_every == 0 and prev_loss is not None:
                log.info("step %5d loss %.4f workers %d mode %s",
                         train_step, prev_loss, len(workers), mode)
            train_step += 1
            wall += 1
            if train_step % ckpt_every == 0:
                save(train_step, pull_params())

        final = pull_params()
        save(train_step, final)
        if ckpt is not None:
            ckpt.wait()
        final_alive = tuple(w for w in coord.alive() if w != ps_id)
        transitions_log = coord.transition_log()
        captured = coord.transport.captured_trace()
    finally:
        if ckpt is not None:
            ckpt.close()
        coord.close()
    return {"losses": [losses[s] for s in sorted(losses)],
            "recoveries": recoveries, "params": final,
            "opt_state": None, "final_alive": final_alive,
            "transitions": transitions_log,
            "captured_trace": captured,
            "blocked_rounds": blocked_rounds}
