"""TrainingMode: the strategy layer behind `run_elastic`.

The port of the JAX package's ``elastic/modes.py``.  `run_elastic` is a
mode-agnostic event loop (advance the coordinator, hand membership
changes and rounds to the mode); each `TrainingMode` owns

  * its per-round step (`run_round`): what compute happens, how the loss
    is recorded and how much simulated time the round costs (the mode's
    goodput accounting IS its time model);
  * its recovery policy (`on_membership_change`): rewind to checkpoint
    (sync), survivor continuation (local modes), or lost throughput only
    (the parameter-server modes);
  * its checkpoint surface: replicated tree + `SyncCheckpointRestore`,
    (W, ...)-stacked `save_stacked`, or pull from the server;
  * its straggler response: DBS resplit at the barrier (sync), resplit of
    local rows (local modes), or no barrier at all (PS family).

The five registered modes map onto the survey's taxonomy:

  decentralized / all-reduce:   sync, local_sgd, easgd
  centralized / param server:   async_ps (no barrier: workers push
                                gradients and pull parameters against
                                the transport's `ParamServer` role),
                                ssp (bounded staleness: a fast worker
                                blocks while my_clock - slowest > s)

The simulated clock (`sim_time`, goodput, recovery latency) is plain
Python float arithmetic in the JAX package's operation order, so it comes
out equal to the JAX package's on the same trace.  Means over the worker
axis go through `data_parallel.worker_mean` (XLA's sum times 1/W), so
survivor rows round as the JAX package's do.

State shared with the driver lives in `ModeContext`: the mutable counters
(train_step, sim_time, losses, ...) stay in one place so the sync mode's
rewind and latency accounting see one truth.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import data_parallel as DP
from repro_torch.elastic.recovery import (BoundedStalenessContinuation,
                                          EASGDCenterSurvival,
                                          SyncCheckpointRestore)
from repro_torch.elastic.reshard import save_stacked
from repro_torch.elastic.straggler import BackupDecision, step_time
from repro_torch.models.common import tree_map
from repro_torch.obs import recorder as obs

Pytree = Any


@dataclasses.dataclass
class ModeContext:
    """Everything a mode needs from the driver: immutable run config +
    the mutable counters the event loop and the mode co-own."""
    problem: Any
    coord: Any
    opt: Any
    # run config
    workers: int                 # initial worker count
    steps: int
    global_batch: int
    lr: float
    K: int
    ckpt_dir: Optional[str]
    ckpt_every: int
    keep_last: int
    restore_penalty: float
    straggle_threshold: float
    easgd_rho: float
    async_ckpt: bool
    staleness: Optional[int]
    num_ps: int
    # speculative execution: ETA slack over the fleet median past which
    # the slowest shard gets a backup run (None = disabled, the default)
    spec_slack: Optional[float] = None
    nominal_t: float = 0.0       # one uniform worker's step work
    # mutable run state
    train_step: int = 0
    sim_time: float = 0.0
    samples_done: int = 0
    replans: int = 0
    losses: Dict[int, float] = dataclasses.field(default_factory=dict)
    recoveries: List[Any] = dataclasses.field(default_factory=list)
    # (record, goal step, t0): latency closes when progress regains goal
    pending: List[Tuple[Any, int, float]] = dataclasses.field(
        default_factory=list)

    def add_samples(self, n: int) -> None:
        """Count useful rows (the goodput numerator), also on the
        recorder's registry (a no-op when recording is off)."""
        self.samples_done += n
        obs.get().count("elastic.samples_done", n)

    def tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch on the problem's device."""
        return {k: torch.as_tensor(v, device=self.problem.device)
                for k, v in batch.items()}


def _stacked_init(opt, params_w: Pytree) -> Pytree:
    """`jax.vmap(opt.init)` over the worker axis: each row's state,
    stacked."""
    W = DP._num_workers(params_w)
    return DP._stack([opt.init(DP._row(params_w, w)) for w in range(W)])


class TrainingMode(abc.ABC):
    """One training strategy: round step + recovery + checkpoint surface
    + straggler response + goodput accounting.

    Lifecycle (driven by `run_elastic`):
      setup(ctx) -> [on_membership_change | run_round]* -> wait()
      -> finally close(); then final_params()/samples()/... for the
      result.  `close()` must be safe after a failed/partial setup."""

    name: str = "?"
    needs_ckpt_dir = False
    extra_hosts = 0   # memberships beyond the workers (e.g. PS shards)

    @abc.abstractmethod
    def setup(self, ctx: ModeContext) -> None: ...

    def on_membership_change(self, ctx: ModeContext, deaths, joins,
                             old_ids: Sequence[int],
                             new_ids: Sequence[int]) -> None:
        """React to deaths/joins (called only when there are any)."""

    @abc.abstractmethod
    def run_round(self, ctx: ModeContext, ids: Sequence[int],
                  rates: Dict[int, float]) -> None: ...

    @abc.abstractmethod
    def final_params(self) -> Pytree:
        """The single model the run delivers (for `problem.full_loss`)."""

    def samples(self, ctx: ModeContext) -> int:
        """Useful rows processed: the numerator of goodput."""
        return ctx.samples_done

    def stacked_params(self) -> Any:
        """(W', ...)-stacked per-worker params for survivor-row
        comparisons (None for modes without per-worker replicas)."""
        return None

    def mode_stats(self) -> Dict[str, Any]:
        """Mode-specific observability (PS clocks, staleness, ...)."""
        return {}

    def visible_alive(self, ids: Sequence[int]) -> Tuple[int, ...]:
        """The result's final_alive view (PS modes hide server hosts)."""
        return tuple(ids)

    def wait(self) -> None:
        """Barrier before reporting: handed-over saves are durable."""

    def close(self) -> None:
        """Release writers/resources; never masks an in-flight error."""


# ---------------------------------------------------------------------------
# Decentralized / all-reduce family
# ---------------------------------------------------------------------------
class SyncAllReduce(TrainingMode):
    """Synchronous data-parallel all-reduce.

    Recovery: a mid-step death kills the in-flight collective: restore
    the last committed checkpoint and rewind (`SyncCheckpointRestore`).
    Straggler response: DBS batch resplit at the barrier.  Time: each
    round costs the straggler bound max_i(rows_i / rate_i); goodput
    counts exactly steps * global_batch useful rows (redone work after a
    restore is not useful and not counted again)."""

    name = "sync"
    needs_ckpt_dir = True

    def __init__(self):
        self.policy: Optional[SyncCheckpointRestore] = None
        self.spec = None          # Speculator when ctx.spec_slack is set
        # the last round's fired decision: while its straggler stays
        # silent, the helper's redundant copy of that shard is standing
        # coverage for the in-flight barrier
        self._cover = None

    def setup(self, ctx: ModeContext) -> None:
        self.params = ctx.problem.init_params()
        self.opt_state = ctx.opt.init(self.params)
        # host=-1: the driver's replicated-state saver is a logical host
        # outside the worker id space, so a worker death never drops its
        # commit floor from the coordinator aggregate
        self.policy = SyncCheckpointRestore(ctx.ckpt_dir,
                                            keep_last=ctx.keep_last,
                                            async_save=ctx.async_ckpt,
                                            coordinator=ctx.coord, host=-1)
        self.policy.checkpoint(0, self.params, self.opt_state)
        if ctx.spec_slack is not None:
            from repro_torch.cluster.coordinator import Speculator
            self.spec = Speculator(ctx.coord)

    def on_membership_change(self, ctx, deaths, joins, old_ids, new_ids):
        from repro_torch.elastic.driver import RecoveryRecord

        if not deaths:
            return  # joins just widen the next split
        cover, self._cover = self._cover, None
        if cover is not None:
            dec, dec_step = cover
            if {d.worker for d in deaths} == {dec.straggler}:
                # covered death: the straggled shard's last result landed
                # from its backup (first result wins at the barrier), so
                # nothing in flight is lost with the corpse: no restore,
                # no rewind, lost_steps=0
                self.spec.covered_deaths += 1
                rec = obs.get()
                if rec.enabled:
                    rec.event("backup.cover", cat="cluster",
                              host=dec.helper, shard=dec.straggler,
                              step=dec_step)
                for d in deaths:
                    ctx.recoveries.append(
                        RecoveryRecord(d.step, d.worker, d.cause, 0))
                return
            # the helper died (its own shard was in the collective) or an
            # uninvolved worker did: the coverage is void either way
        # the in-flight collective died: restore + rewind.  The span's
        # duration is the simulated restore pause it charges.
        with obs.get().span("restore", cat="elastic",
                            wall=ctx.train_step):
            self.params, self.opt_state, restored = self.policy.recover(
                self.params, self.opt_state)
            lost = ctx.train_step - restored
            pause = ctx.restore_penalty * ctx.nominal_t
            ctx.sim_time += pause
        for d in deaths:
            rec = RecoveryRecord(d.step, d.worker, d.cause, lost)
            ctx.recoveries.append(rec)
            ctx.pending.append((rec, ctx.train_step, ctx.sim_time - pause))
        ctx.train_step = restored

    def run_round(self, ctx, ids, rates):
        # straggler mitigation: DBS split on the sync barrier
        split, slow = ctx.coord.plan_split(ctx.global_batch, alive=ids,
                                           threshold=ctx.straggle_threshold)
        if slow:
            ctx.replans += 1
        # speculation: if one shard's ETA blows the slack over the fleet
        # median (or its worker is SUSPECT), launch a redundant copy on
        # the least-loaded healthy host before the barrier
        dec = None
        if self.spec is not None:
            dec = ctx.coord.plan_backup(split, slack=ctx.spec_slack,
                                        rates=rates)
            if dec is not None and not self.spec.launch(dec,
                                                        ctx.train_step):
                dec = None        # helper refused or died: no backup
        batch = ctx.problem.stack(ids, ctx.train_step, split)
        losses_w, grads_w = DP.per_worker_grads(
            ctx.problem.loss_fn, self.params, ctx.tensors(batch))
        wts = torch.tensor([split[w] for w in ids], dtype=torch.float32,
                           device=ctx.problem.device)
        wts = wts / wts.sum()
        g = tree_map(lambda gw: torch.tensordot(wts, gw.float(), 1), grads_w)
        self.params, self.opt_state = ctx.opt.update(g, self.opt_state,
                                                     self.params)
        ctx.losses[ctx.train_step] = float(torch.dot(wts, losses_w))
        if dec is None:
            self._cover = None
            ctx.sim_time += step_time(split, rates)
        else:
            # first-result-wins barrier: every healthy shard must land,
            # but the straggled shard only costs the EARLIER of its two
            # copies.  The helper's double duty is inside eta_backup, so
            # backup compute extends the barrier exactly when the backup
            # is on the critical path.  The gradient math above never
            # looked at the winner: both copies are the same bytes.
            winner_eta = min(dec.eta_primary, dec.eta_backup)
            others = max((split[w] / max(rates.get(w, 1.0), 1e-9)
                          for w in split if w != dec.straggler),
                         default=0.0)
            ctx.sim_time += max(others, winner_eta)
            self.spec.resolve(dec, ctx.train_step, winner=dec.winner)
            self._cover = (dec, ctx.train_step)
        if ctx.ckpt_every and (ctx.train_step + 1) % ctx.ckpt_every == 0:
            self.policy.checkpoint(ctx.train_step + 1, self.params,
                                   self.opt_state)

    def samples(self, ctx):
        return ctx.steps * ctx.global_batch

    def final_params(self):
        return self.params

    def mode_stats(self):
        return {"speculation": self.spec.stats()} if self.spec else {}

    def wait(self):
        self.policy.wait()

    def close(self):
        if self.policy is not None:
            self.policy.close()


class _StackedReplicaMode(TrainingMode):
    """Shared machinery of the local modes: (W, ...)-stacked per-worker
    replicas, survivor continuation on death, `save_stacked` cadence,
    ragged DBS local rows once the monitor flags a straggler."""

    def __init__(self):
        self._ckpt = None

    def setup(self, ctx: ModeContext) -> None:
        if ctx.async_ckpt and ctx.ckpt_dir:
            from repro_torch.checkpoint import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer(ctx.ckpt_dir,
                                           keep_last=ctx.keep_last)
        p0 = ctx.problem.init_params()
        # real rows, not a broadcast view: each worker's replica is its own
        self.params_w = tree_map(
            lambda p: p.unsqueeze(0).repeat((ctx.workers,) + (1,) * p.dim()),
            p0)
        self._setup_state(ctx, p0)

    @abc.abstractmethod
    def _setup_state(self, ctx: ModeContext, p0: Pytree) -> None: ...

    @abc.abstractmethod
    def _round_compute(self, ctx: ModeContext, batches_wk) -> Any: ...

    @abc.abstractmethod
    def _save_payload(self) -> Tuple[Dict[str, Pytree], Optional[Dict]]: ...

    def run_round(self, ctx, ids, rates):
        # ragged local rounds: once the monitor flags a straggler the
        # per-local-step rows go through the same DBS split as the sync
        # barrier, over the SAME round total; the healthy path stays
        # uniform.  Rounded (not floored) so a death doesn't step the
        # allocation and conflate quantization with failure cost.
        n = max(1, round(ctx.global_batch / (len(ids) * ctx.K)))
        slow = ctx.coord.monitor.stragglers(ids, ctx.straggle_threshold)
        if slow:
            ctx.replans += 1
            split, _ = ctx.coord.plan_split(n * len(ids), alive=ids,
                                            threshold=ctx.straggle_threshold)
        else:
            split = {w: n for w in ids}
        ctx.add_samples(ctx.K * sum(split.values()))
        batch = ctx.problem.stack(ids, ctx.train_step, split, K=ctx.K)
        m = self._round_compute(ctx, ctx.tensors(batch))
        ctx.losses[ctx.train_step] = float(m["loss"])
        ctx.sim_time += step_time({w: split[w] * ctx.K for w in ids}, rates)
        if ctx.ckpt_dir and ctx.ckpt_every and \
                (ctx.train_step + 1) % ctx.ckpt_every == 0:
            stacked, rep = self._save_payload()
            save_stacked(ctx.ckpt_dir, ctx.train_step + 1, stacked, ids,
                         replicated=rep, keep_last=ctx.keep_last,
                         checkpointer=self._ckpt)

    def stacked_params(self):
        return self.params_w

    def wait(self):
        if self._ckpt is not None:
            self._ckpt.wait()

    def close(self):
        if self._ckpt is not None:
            self._ckpt.close(wait=False)


class LocalSGD(_StackedReplicaMode):
    """Local SGD: K local steps per round, then parameter averaging.

    Recovery: survivor continuation (`BoundedStalenessContinuation`): a
    death drops the dead worker's replica row, no rewind; a joiner starts
    at the survivor mean.  All processed rows are useful work."""

    name = "local_sgd"

    def _setup_state(self, ctx, p0):
        self.opt_w = _stacked_init(ctx.opt, self.params_w)
        self.policy = BoundedStalenessContinuation()

    def on_membership_change(self, ctx, deaths, joins, old_ids, new_ids):
        from repro_torch.elastic.driver import RecoveryRecord

        with obs.get().span("reshard", cat="elastic",
                            old=list(old_ids), new=list(new_ids)):
            st = self.policy.apply({"params": self.params_w,
                                    "opt": self.opt_w}, old_ids, new_ids)
            # survivor rows land on their host's device (identity under
            # simulated transports)
            self.params_w = ctx.coord.place_rows(st["params"], new_ids)
            self.opt_w = ctx.coord.place_rows(st["opt"], new_ids)
        for d in deaths:
            ctx.recoveries.append(
                RecoveryRecord(d.step, d.worker, d.cause, 0))

    def _round_compute(self, ctx, batches_wk):
        self.params_w, self.opt_w, m = DP.local_sgd_round(
            ctx.problem.loss_fn, self.params_w, ctx.opt, self.opt_w,
            batches_wk)
        return m

    def _save_payload(self):
        return {"params": self.params_w, "opt": self.opt_w}, None

    def final_params(self):
        return tree_map(DP.worker_mean, self.params_w)


class EASGD(_StackedReplicaMode):
    """Elastic Averaging SGD: replicas pulled toward a center variable.

    Recovery: the center x~ lives outside any worker and survives by
    construction (`EASGDCenterSurvival`); a joiner clones the center."""

    name = "easgd"

    def _setup_state(self, ctx, p0):
        self.center = p0
        self.policy = EASGDCenterSurvival()
        self.easgd_cfg = DP.EASGDConfig(lr=ctx.lr, rho=ctx.easgd_rho)

    def on_membership_change(self, ctx, deaths, joins, old_ids, new_ids):
        from repro_torch.elastic.driver import RecoveryRecord

        with obs.get().span("reshard", cat="elastic",
                            old=list(old_ids), new=list(new_ids)):
            self.params_w, self.center = self.policy.apply(
                self.params_w, self.center, old_ids, new_ids)
            self.params_w = ctx.coord.place_rows(self.params_w, new_ids)
        for d in deaths:
            ctx.recoveries.append(
                RecoveryRecord(d.step, d.worker, d.cause, 0))

    def _round_compute(self, ctx, batches_wk):
        self.params_w, self.center, m = DP.easgd_round(
            ctx.problem.loss_fn, self.params_w, self.center, batches_wk,
            self.easgd_cfg)
        return m

    def _save_payload(self):
        return {"params": self.params_w}, {"center": self.center}

    def final_params(self):
        return self.center


# ---------------------------------------------------------------------------
# Centralized / parameter-server family
# ---------------------------------------------------------------------------
def host_flat(tree: Pytree) -> Dict[str, np.ndarray]:
    """A tree's leaves as float32 host arrays, by checkpoint key: what a
    worker pushes to (or seeds) a parameter server.  A DTensor leaf is
    made whole first, on every rank (each must call this)."""
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.core.sharding import whole
    return {k: whole(v).detach().float().cpu().numpy()
            for k, v in _flatten(tree).items()}


class _ParamServerMode(TrainingMode):
    """Shared machinery of the PS modes.

    Topology: `num_ps` ParamServer hosts take membership ids directly
    above the worker ids and are tracked by the coordinator like any
    host; parameters are partitioned over their versioned KV shards
    round-robin by key (`core.param_server.shard_keys`).  Each worker
    step pulls the current params, computes a gradient on its own
    (worker, clock)-keyed batch and pushes; the shard applies server-side
    SGD immediately, with no barrier.

    Time model: every wall round costs n rows of simulated time (the
    nominal duration of one worker step) and each worker accrues `rate`
    step credit per round, completing a step whenever its credit reaches
    1, so a 0.25-rate straggler completes every 4th round and nobody
    waits for it: the PS family's straggler response is the absence of a
    barrier (`splits_replanned` stays 0).

    Recovery: a worker death is lost throughput only (lost_steps=0); a
    joiner registers at the fleet's minimum clock.  A ParamServer death
    is FATAL: a centralized shard holds the only copy of its
    parameters."""

    needs_ckpt_dir = False

    def __init__(self, staleness: Optional[int], num_ps: int = 1):
        self.staleness = staleness
        self.num_ps = num_ps
        self.extra_hosts = num_ps
        self._ckpt = None
        self.gate = None
        self.spec = None          # Speculator when ctx.spec_slack is set

    def setup(self, ctx: ModeContext) -> None:
        from repro_torch.checkpoint.ckpt import _unflatten_like
        from repro_torch.core.param_server import shard_keys

        if ctx.async_ckpt and ctx.ckpt_dir:
            from repro_torch.checkpoint import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer(ctx.ckpt_dir,
                                           keep_last=ctx.keep_last)
        self.ps_ids = tuple(range(ctx.workers, ctx.workers + self.num_ps))
        p0 = ctx.problem.init_params()
        self._template = p0               # structure for the pull side
        self._device = ctx.problem.device
        self._unflatten = _unflatten_like
        flat = host_flat(p0)
        self._assign = {}
        for ps_id, keys in zip(self.ps_ids,
                               shard_keys(list(flat), self.num_ps)):
            ctx.coord.transport.ps_open(ps_id, ctx.lr,
                                        {k: flat[k] for k in keys})
            for k in keys:
                self._assign[k] = ps_id
        # clocks: the SSP gate tracks every worker even in async mode
        # (staleness=None never blocks but still audits the gap)
        self.gate = ctx.coord.clock_gate(self.staleness)
        for w in range(ctx.workers):
            self.gate.register(w, 0)
        self.credit = {w: 0.0 for w in range(ctx.workers)}
        self.pushes = {w: 0 for w in range(ctx.workers)}
        self.blocked_rounds = 0
        self.max_gap = 0
        self.n = max(1, round(ctx.global_batch / ctx.workers))
        self._transport = ctx.coord.transport
        # only a finite staleness window can be blocked by a straggler,
        # so async_ps (staleness None) never speculates
        if ctx.spec_slack is not None and self.staleness is not None:
            from repro_torch.cluster.coordinator import Speculator
            self.spec = Speculator(ctx.coord)

    # -- membership ----------------------------------------------------
    def on_membership_change(self, ctx, deaths, joins, old_ids, new_ids):
        from repro_torch.elastic.driver import RecoveryRecord

        dead_ps = [d for d in deaths if d.worker in self.ps_ids]
        if dead_ps:
            raise RuntimeError(
                f"parameter server host(s) "
                f"{[d.worker for d in dead_ps]} died: centralized shards "
                f"hold the only copy of their parameters (survey: the PS "
                f"topology's single point of failure)")
        for d in deaths:
            # lost throughput, nothing to rewind: the dead worker's
            # in-flight gradient just never pushes
            self.credit.pop(d.worker, None)
            self.pushes.pop(d.worker, None)
            ctx.recoveries.append(
                RecoveryRecord(d.step, d.worker, d.cause, 0))
        for j in joins:
            floor = self.gate.min_clock()
            self.gate.register(j.worker, floor)
            self.credit[j.worker] = 0.0
            self.pushes[j.worker] = 0

    # -- the round -----------------------------------------------------
    def run_round(self, ctx, ids, rates):
        workers = [w for w in ids if w not in self.ps_ids]
        if not workers:
            raise RuntimeError("all PS-mode workers dead")
        round_losses = []
        for w in workers:
            # at most one step per worker per round: a blocked or idle
            # worker does not bank capacity it never had time to spend
            self.credit[w] = min(self.credit.get(w, 0.0)
                                 + rates.get(w, 1.0), 1.0)
            if self.credit[w] < 1.0:
                continue
            if not self.gate.can_advance(w):
                self.blocked_rounds += 1
                continue
            self.credit[w] -= 1.0
            round_losses.append(self._worker_step(ctx, w))
            ctx.add_samples(self.n)
        if self.spec is not None:
            blocked_now = [w for w in workers
                           if self.credit.get(w, 0.0) >= 1.0
                           and not self.gate.can_advance(w)]
            if blocked_now:
                self._backup_slowest(ctx, workers, rates, blocked_now,
                                     round_losses)
        for w in workers:
            self.max_gap = max(self.max_gap, self.gate.gap(w))
        if round_losses:
            ctx.losses[ctx.train_step] = float(np.mean(round_losses))
        elif ctx.train_step > 0:
            # every worker was blocked or accruing: the model did not
            # move, carry the curve forward
            ctx.losses[ctx.train_step] = ctx.losses[ctx.train_step - 1]
        else:
            ctx.losses[ctx.train_step] = float(
                ctx.problem.full_loss(self.final_params()))
        ctx.sim_time += float(self.n)  # fixed time quantum: no barrier
        if ctx.ckpt_dir and ctx.ckpt_every and \
                (ctx.train_step + 1) % ctx.ckpt_every == 0:
            self._checkpoint(ctx, ctx.train_step + 1)

    def _backup_slowest(self, ctx, workers, rates, blocked,
                        round_losses) -> None:
        """SSP speculation: a gate-blocked fast worker has idle capacity
        by definition; spend it re-executing the slowest worker's next
        step so the staleness window reopens for everyone.  The backup
        computes the identical (worker, clock)-keyed batch the straggler
        would have and pushes under the straggler's advanced clock; the
        straggler's banked credit drops to zero and the duplicated rows
        are billed as wasted compute."""
        s = min(workers, key=lambda w: (self.gate.clocks[w], w))
        suspects = set(ctx.coord.suspects())
        rate_s = rates.get(s, 1.0)
        if s not in suspects and rate_s * ctx.spec_slack >= 1.0:
            return      # the straggler lands within the slack anyway
        helpers = [w for w in blocked if w != s and w not in suspects]
        if not helpers:
            return
        helper = min(helpers, key=lambda w: (-rates.get(w, 1.0), w))
        dec = BackupDecision(
            straggler=s, helper=helper, rows=self.n,
            eta_primary=(math.inf if s in suspects
                         else self.n / max(rate_s, 1e-9)),
            eta_backup=float(self.n))
        if dec.winner != "backup":
            return
        if not self.spec.launch(dec, ctx.train_step):
            return
        round_losses.append(self._worker_step(ctx, s))
        ctx.add_samples(self.n)
        self.credit[s] = 0.0
        self.spec.resolve(dec, ctx.train_step, winner="backup")

    def _worker_step(self, ctx, w: int) -> float:
        params = self.final_params()            # pull
        clock = self.gate.clocks[w]
        batch = ctx.problem.sample(w, clock, self.n, self.n)
        loss, grads = DP.value_and_grad(ctx.problem.loss_fn, params,
                                        ctx.tensors(batch))
        flat_g = host_flat(grads)
        new_clock = self.gate.advance(w)
        by_ps: Dict[int, Dict[str, np.ndarray]] = {}
        for k, g in flat_g.items():
            by_ps.setdefault(self._assign[k], {})[k] = g
        for ps_id in sorted(by_ps):
            self._transport.ps_push(ps_id, w, new_clock, by_ps[ps_id])
        self.pushes[w] += 1
        return float(loss)

    def _pull_flat(self) -> Dict[str, np.ndarray]:
        flat: Dict[str, np.ndarray] = {}
        self._versions = {}
        for ps_id in self.ps_ids:
            version, entries = self._transport.ps_pull(ps_id)
            self._versions[ps_id] = version
            flat.update(entries)
        return flat

    def _checkpoint(self, ctx, step: int) -> None:
        tree = {"params": self.final_params()}
        if self._ckpt is not None:
            self._ckpt.save(step, tree)
        else:
            from repro_torch.checkpoint import save_checkpoint
            save_checkpoint(ctx.ckpt_dir, step, tree,
                            keep_last=ctx.keep_last)

    # -- result surface ------------------------------------------------
    def final_params(self) -> Pytree:
        flat = self._pull_flat()
        return self._unflatten(
            self._template, {k: torch.as_tensor(v, device=self._device)
                             for k, v in flat.items()})

    def visible_alive(self, ids):
        return tuple(w for w in ids if w not in self.ps_ids)

    def mode_stats(self):
        stats = {"ps_ids": self.ps_ids,
                 "ps_params": self._pull_flat(),
                 "versions": dict(self._versions),
                 "clocks": dict(self.gate.clocks),
                 "pushes": dict(self.pushes),
                 "blocked_rounds": self.blocked_rounds,
                 "max_clock_gap": self.max_gap,
                 "staleness": self.staleness}
        if self.spec is not None:
            stats["speculation"] = self.spec.stats()
        return stats

    def wait(self):
        if self._ckpt is not None:
            self._ckpt.wait()

    def close(self):
        if self._ckpt is not None:
            self._ckpt.close(wait=False)


class AsyncParamServer(_ParamServerMode):
    """Fully asynchronous parameter server (Downpour/A3C style): no
    barrier, no staleness bound; the gate tracks clocks but never blocks.
    Worker death costs only the dead worker's throughput."""

    name = "async_ps"

    def __init__(self, num_ps: int = 1):
        super().__init__(staleness=None, num_ps=num_ps)


class StaleSynchronous(_ParamServerMode):
    """Stale-synchronous parallel (SSP): async push/pull under a bounded
    staleness window: a worker may start the step taking it to clock c+1
    only while c+1 - min_clock <= s, so no observed clock gap ever
    exceeds s."""

    name = "ssp"

    def __init__(self, staleness: int = 2, num_ps: int = 1):
        if staleness is None:
            raise ValueError("ssp needs a finite staleness bound "
                             "(use async_ps for unbounded)")
        super().__init__(staleness=staleness, num_ps=num_ps)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
MODES = ("sync", "local_sgd", "easgd", "async_ps", "ssp")


def make_mode(mode: str, *, staleness: Optional[int] = 2,
              num_ps: int = 1) -> TrainingMode:
    """Instantiate the named strategy (driver entry point)."""
    if mode == "sync":
        return SyncAllReduce()
    if mode == "local_sgd":
        return LocalSGD()
    if mode == "easgd":
        return EASGD()
    if mode == "async_ps":
        return AsyncParamServer(num_ps=num_ps)
    if mode == "ssp":
        return StaleSynchronous(staleness=staleness, num_ps=num_ps)
    raise ValueError(f"mode must be one of {MODES}")
