"""Coordinator: the single membership/synchronization authority shared
by elastic training and elastic serving.

The port of the JAX package's ``cluster/coordinator.py``, recording the
same events on the port's ``obs`` spine.

Before this subsystem existed, `elastic.driver` and `serving.fleet` each
ran a private copy of the same loop — advance the membership machine,
bucket the transitions, feed the straggler monitor, forget the dead.
The coordinator defines that loop once:

  * **Membership authority** — owns the one `elastic.Membership` state
    machine; `advance(wall)` pulls events from the pluggable `Transport`
    (simulated trace or real multi-process heartbeats) and applies them.
    Consumers either use the returned transitions or `subscribe` per
    kind ("death" / "join" / "rate" / "suspect") — the serving fleet's
    drain/spawn reactions are subscriptions, so fail/hang/join/slow
    semantics are identical across training and serving.
  * **Epochs / generations** — `epoch` bumps once per membership-changing
    advance (any death or join); `generation` is the finer-grained
    membership counter (one bump per death + per join) used to fence
    stale per-worker state.
  * **Straggler telemetry** — the shared `ThroughputMonitor`: rate
    transitions feed it, deaths forget it, and `plan_split` turns it
    into a DBS batch split (`replan_on_straggle`) for any consumer.
  * **Commit-step aggregation** — hosts report their
    `AsyncCheckpointer.last_committed_step()` (directly via
    `report_commit`, or piggybacked on transport heartbeats); the
    fleet-wide safe recovery point is `rewind_step()` = the MINIMUM over
    surviving hosts, because a checkpoint step only exists cluster-wide
    once every host has committed it.  Dead hosts drop out of the
    aggregate — their shards are being rebuilt from the survivors'
    floor anyway.
  * **Placement** — `place_rows` moves worker-stacked state rows onto
    the transport's host -> device map after a reshard (`.to(device)`;
    dense host ranks over the cards; a no-op under simulated
    transports).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.elastic.membership import (DEAD, SUSPECT, FailureTrace,
                                            Membership, Transition)
from repro_torch.elastic.straggler import (BackupDecision,
                                           ThroughputMonitor, plan_backup,
                                           replan_on_straggle)
from repro_torch.models.common import tree_map
from repro_torch.obs import recorder as obs

from repro_torch.cluster.sim import SimTransport
from repro_torch.cluster.transport import RoleHostDied, Transport

Pytree = Any


class Coordinator:
    def __init__(self, transport: Optional[Transport] = None,
                 num_workers: int = 1, *, heartbeat_timeout: int = 3,
                 suspect_after: int = 1, monitor_decay: float = 0.5,
                 keep_transition_log: bool = True):
        """keep_transition_log=False drops the cumulative history (the
        cross-transport equivalence artifact) — for indefinitely-lived
        consumers like a serving fleet, where it would grow without
        bound; subscriptions and all live views are unaffected."""
        self.transport = transport or SimTransport(FailureTrace())
        self.membership = Membership(num_workers, trace=None,
                                     heartbeat_timeout=heartbeat_timeout,
                                     suspect_after=suspect_after)
        self.monitor = ThroughputMonitor(decay=monitor_decay)
        self.epoch = 0
        self.keep_transition_log = keep_transition_log
        self.transitions: List[Transition] = []
        self._subs: Dict[str, List[Callable[[Transition], None]]] = {}
        self._commits: Dict[int, int] = {}
        self._epoch_t0: Optional[float] = None  # obs: current epoch start
        try:
            self.transport.start(num_workers)
        except BaseException:
            # a partial start (some workers spawned, one failed to beat)
            # must not leak the live ones: the caller never receives the
            # coordinator, so nobody else can close them
            self.transport.close()
            raise

    # -- views ---------------------------------------------------------
    @property
    def generation(self) -> int:
        return self.membership.generation

    def alive(self) -> Tuple[int, ...]:
        return self.membership.alive()

    def rates(self) -> Dict[int, float]:
        return self.membership.rates()

    def suspects(self) -> Tuple[int, ...]:
        """Workers the failure detector currently holds SUSPECT (silent
        past `suspect_after` but not yet past the heartbeat timeout) —
        the ETA model treats their arrival as unbounded."""
        return tuple(sorted(w for w, s in self.membership.workers.items()
                            if s.status == SUSPECT))

    def transition_log(self) -> List[Tuple]:
        """The full membership history in canonical serializable form —
        the artifact the cross-transport equivalence suite compares
        (empty when keep_transition_log=False)."""
        return [t.as_tuple() for t in self.transitions]

    # -- subscriptions -------------------------------------------------
    def subscribe(self, kind: str,
                  fn: Callable[[Transition], None]) -> None:
        """Register fn(transition) for one transition kind ("death",
        "join", "rate", "suspect").  Called during `advance`, in
        transition order, after membership and telemetry are updated —
        a subscriber always sees the post-transition cluster view."""
        if kind not in ("death", "join", "rate", "suspect"):
            raise ValueError(f"unknown transition kind {kind!r}")
        self._subs.setdefault(kind, []).append(fn)

    # -- the control loop ----------------------------------------------
    def advance(self, wall: int) -> List[Transition]:
        """One wall step: poll the transport, apply events, update
        epoch/telemetry/commits, notify subscribers."""
        events = self.transport.poll(wall)
        transitions = self.membership.apply(wall, events)
        rec = obs.get()
        if rec.enabled and self._epoch_t0 is None:
            self._epoch_t0 = rec.clock()
        changed = False
        for t in transitions:
            if t.kind == "rate":
                # telemetry: the trace-reported rate is authoritative —
                # it fires once per change, so it pins (no EMA blend)
                self.monitor.set_rate(t.worker, t.rate)
            elif t.kind == "death":
                changed = True
                self.monitor.forget(t.worker)
                self._commits.pop(t.worker, None)
            elif t.kind == "join":
                changed = True
            if rec.enabled:
                rec.event("membership." + t.kind, host=t.worker,
                          cat="cluster", cause=t.cause, rate=t.rate,
                          wall=wall)
        if changed:
            self.epoch += 1
            if rec.enabled:
                self._close_epoch_span(rec)
                rec.gauge("cluster.epoch", self.epoch)
        if self.keep_transition_log:
            self.transitions.extend(transitions)
        for host, step in self.transport.commit_reports():
            self.report_commit(host, step)
        for t in transitions:
            for fn in self._subs.get(t.kind, ()):
                fn(t)
        return transitions

    def _close_epoch_span(self, rec) -> None:
        """Emit the just-ended epoch as a span [epoch start, now)."""
        now = rec.clock()
        t0 = self._epoch_t0 if self._epoch_t0 is not None else now
        rec.complete("epoch", t0, now - t0, cat="cluster",
                     epoch=self.epoch - 1,
                     alive=list(self.membership.alive()))
        self._epoch_t0 = now

    # -- straggler-aware work planning ---------------------------------
    def plan_split(self, global_batch: int, *,
                   alive: Optional[Sequence[int]] = None,
                   threshold: float = 0.5, multiple: int = 1
                   ) -> Tuple[Dict[int, int], Tuple[int, ...]]:
        """DBS batch split over the (given or current) alive set:
        uniform while nobody lags, throughput-proportional once the
        monitor flags a straggler.  Returns (split, flagged)."""
        ids = tuple(alive) if alive is not None else self.alive()
        return replan_on_straggle(self.monitor, ids, global_batch,
                                  threshold=threshold, multiple=multiple)

    # -- speculative execution (ETA prediction) ------------------------
    def plan_backup(self, split: Dict[int, int], *, slack: float,
                    rates: Optional[Dict[int, float]] = None
                    ) -> Optional[BackupDecision]:
        """ETA-predict the split's barrier arrivals and decide whether
        the slowest shard deserves a backup execution on the
        least-loaded healthy host (`elastic.straggler.plan_backup`).
        Rates default to the monitor's telemetry (what `plan_split`
        uses); SUSPECT workers come from the membership machine, so the
        decision reflects the same failure-detector state on every
        transport."""
        return plan_backup(split,
                           rates if rates is not None
                           else self.monitor.rates(list(split)),
                           slack=slack, suspects=self.suspects())

    # -- multi-host checkpoint consistency -----------------------------
    def report_commit(self, host: int, step: Optional[int]) -> None:
        """Record a host's last durably committed checkpoint step.  A
        report from a host the membership already declared dead is
        dropped (a stale heartbeat can arrive in the same poll as the
        death — it must not resurrect the corpse's floor)."""
        if step is None:
            return
        ws = self.membership.workers.get(host)
        if ws is not None and ws.status == DEAD:
            return
        rec = obs.get()
        if rec.enabled and self._commits.get(host) != int(step):
            rec.event("commit.report", host=host, cat="cluster",
                      step=int(step))
        self._commits[host] = int(step)
        if rec.enabled:
            floor = self.rewind_step()
            if floor is not None:
                rec.gauge("cluster.rewind_floor", floor)

    def rewind_step(self, *, exclude: Optional[int] = None) -> Optional[int]:
        """The fleet-wide safe recovery step: the minimum committed step
        over surviving reporting hosts (None until any host reports).
        Restoring newer than this would leave some host without its
        shard of the checkpoint; a death drops the host's report (its
        shards are rebuilt from the survivors' floor).

        exclude: compute the floor over the OTHER hosts — what a saver
        asks before GC'ing its own checkpoints ("what might the rest of
        the fleet still rewind me to?").  Excluding self keeps the
        single-reporting-host case floor-free (None), so per-host
        retention only changes when another host is actually behind."""
        vals = [s for h, s in self._commits.items() if h != exclude]
        return min(vals) if vals else None

    def committed_steps(self) -> Dict[int, int]:
        return dict(self._commits)

    # -- bounded-staleness clocks --------------------------------------
    def clock_gate(self, staleness: Optional[int]):
        """An `SSPClockGate` wired to this coordinator's membership: a
        death transition drops the worker's clock, so a dead straggler
        releases blocked fast workers instead of freezing the fleet at
        its last clock.  staleness=None never blocks (fully async) but
        still tracks clocks for staleness accounting."""
        from repro_torch.core.param_server import SSPClockGate
        gate = SSPClockGate(staleness)
        self.subscribe("death", lambda t: gate.drop(t.worker))
        return gate

    # -- placement -----------------------------------------------------
    def place_rows(self, tree_w: Pytree,
                   worker_ids: Sequence[int]) -> Pytree:
        """Move a (W, ...)-stacked tree onto the surviving hosts' device
        after a reshard (`.to(device)`, values unchanged).

        A single stacked array has ONE placement, so this is meaningful
        exactly when the transport maps every surviving host to the same
        device (always true on a 1-device CI/laptop; also true whenever
        a fleet shares an accelerator).  When survivors map to several
        devices, per-row placement is a data-plane concern this driver
        doesn't own yet — the stacked compute runs on the driver host —
        so the tree is returned unchanged (ROADMAP.md queue 1, slice 5:
        the mesh).  Identity when the transport has no host -> device map
        (simulated transports)."""
        devmap = self.transport.host_devices()
        devices = {devmap[w] for w in worker_ids if w in devmap}
        if len(devices) != 1 or len(devmap) == 0:
            return tree_w
        dev = devices.pop()
        return tree_map(lambda t: t.to(dev), tree_w)

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        rec = obs.get()
        if rec.enabled and self._epoch_t0 is not None:
            self._close_epoch_span(rec)
            self._epoch_t0 = None
        self.transport.close()

    def __enter__(self) -> "Coordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Speculator:
    """Backup-execution lifecycle against the transport's "backup" role.

    The coordinator decides WHETHER to back a shard up (`plan_backup`)
    and WHICH copy wins (the deterministic ETA compare in
    `BackupDecision.winner`); this object carries that decision through
    the helper host's `BackupLedger` — launch / commit / cancel verbs
    through the role registry, so sim and proc dispatch identically —
    and keeps the wasted-compute accounting.  The ledger is the
    exactly-once authority: a commit that loses the race (or lands on a
    dead helper) simply reports the backup lost, and the primary's
    result stands.  A helper death mid-RPC (`RoleHostDied`) is never
    fatal here — losing the redundant copy costs nothing but the
    compute already billed."""

    def __init__(self, coord: Coordinator):
        self.coord = coord
        self.launched = 0
        self.won = 0
        self.discarded = 0
        self.wasted_rows = 0
        self.covered_deaths = 0
        self._open_hosts: set = set()

    def task_key(self, decision: BackupDecision, step: int) -> str:
        """generation:step:shard — the generation fences out a stale
        decision that outlives a membership change (its commit/cancel
        can never collide with a post-rewind relaunch of the shard)."""
        return f"{self.coord.generation}:{step}:{decision.straggler}"

    def launch(self, decision: BackupDecision, step: int) -> bool:
        """Start the redundant execution on the helper host.  False if
        the helper refused (duplicate task) or died first — the caller
        must then treat the round as having no backup."""
        host, task = decision.helper, self.task_key(decision, step)
        t = self.coord.transport
        try:
            if host not in self._open_hosts:
                t.role_open(host, "backup")
                self._open_hosts.add(host)
            reply = t.role_call(host, "backup_launch",
                                {"task": task, "shard": decision.straggler,
                                 "rows": decision.rows})
        except RoleHostDied:
            return False
        if not reply.get("accepted"):
            return False
        self.launched += 1
        rec = obs.get()
        if rec.enabled:
            rec.event("backup.launch", cat="cluster", host=host,
                      task=task, shard=decision.straggler,
                      rows=decision.rows)
        return True

    def resolve(self, decision: BackupDecision, step: int, *,
                winner: str) -> bool:
        """First-result-wins commit at the barrier.  True iff the
        backup's copy is the one committed — which requires both the
        driver's arbitration to name it AND the helper's ledger to
        confirm the task was still in flight (exactly-once under proc
        races).  Either way the losing copy is discarded idempotently
        and its rows are billed as wasted compute."""
        host, task = decision.helper, self.task_key(decision, step)
        if winner == "backup":
            try:
                reply = self.coord.transport.role_call(
                    host, "backup_commit", {"task": task})
            except RoleHostDied:
                reply = {"won": False}
            if reply.get("won"):
                self.won += 1
                self.wasted_rows += decision.rows  # the primary's copy
                rec = obs.get()
                if rec.enabled:
                    rec.event("backup.win", cat="cluster", host=host,
                              task=task, shard=decision.straggler)
                    rec.count("speculation.wasted_rows", decision.rows)
                return True
        self.cancel(decision, step)
        return False

    def cancel(self, decision: BackupDecision, step: int) -> None:
        """Discard the backup (idempotent: safe on already-resolved
        tasks and on dead helpers)."""
        host, task = decision.helper, self.task_key(decision, step)
        try:
            self.coord.transport.role_call(host, "backup_cancel",
                                           {"task": task})
        except RoleHostDied:
            pass                      # the ledger died with its host
        self.discarded += 1
        self.wasted_rows += decision.rows     # the backup's copy
        rec = obs.get()
        if rec.enabled:
            rec.event("backup.discard", cat="cluster", host=host,
                      task=task, shard=decision.straggler)
            rec.count("speculation.wasted_rows", decision.rows)

    def stats(self) -> Dict[str, int]:
        return {"launched": self.launched, "won": self.won,
                "discarded": self.discarded,
                "wasted_rows": self.wasted_rows,
                "covered_deaths": self.covered_deaths}
