"""Elastic multi-replica serving: the training-side fault model applied
to a fleet of `ServeEngine` slot pools.

The port of the JAX package's ``serving/fleet.py``.  The replicas share
one parameter set and one `ServeProgram` on one device (the card unless
the CPU is asked for); a paged fleet's drain migrates each live slot's
KV pages to the replica that re-admits it.

Every replica is one continuous-batching engine; the fleet subscribes to
the SAME `cluster.Coordinator` control plane that powers elastic
training — one membership authority, one failure detector — so every
serving fault scenario — crash, hang that escalates through the
heartbeat timeout, scale-up join, straggler — is a replayable
`FailureTrace` and the whole run is a deterministic function of it:

  suspect                the failure detector stops trusting a silent
                         replica BEFORE declaring it dead; the fleet
                         **preemptively drains** its in-flight requests
                         into prefix continuations immediately, instead
                         of letting that work wait out the heartbeat
                         timeout.  A false positive (the replica
                         recovers) costs only the continuations'
                         re-prefill; a true positive saves the whole
                         SUSPECT->DEAD window.
  fail / hang->timeout   the dead replica is **drained**: host-harvested
                         tokens are preserved (they were streamed), the
                         remaining budget is requeued at the router as a
                         prefix continuation (`ServingDrainReadmit`) and
                         re-admitted FIFO-fairly across survivors.  Greedy
                         decoding is slot-local, so completed outputs are
                         bit-identical to the failure-free run.
  join                   a fresh replica spins up sharing the fleet's
                         compiled `ServeProgram` (no recompile) and its
                         nominal-rate routing score immediately absorbs
                         queue backlog.
  slow                   the replica executes fewer engine ticks per wall
                         tick; the router's throughput EMA observes the
                         slowdown and weights admission away from it (the
                         serving analogue of the DBS batch replan).

Time is *simulated*, as in `elastic.driver.run_elastic`: the membership
machine advances one wall tick per fleet step, and each replica earns
`rate` execution credits per wall tick (an engine op costs its device
ticks: prefill 1, a fused k-tick decode chunk k).  Goodput — delivered
tokens per wall tick — is therefore exact and trace-deterministic, which
is what makes recovery cost a deterministic, comparable number.

Under a mesh every rank runs its own fleet on its shards of the same
params.  Drains, suspects, hedges, joins and rates all follow the
coordinator's transitions and the wall tick, never a clock of the
rank's own; with `launch.cli.make_transport`'s `RankZeroTransport` the
transitions, and the backup role's replies, are rank 0's on every rank,
so every rank's fleet takes the same decisions and calls the same
collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.cluster.coordinator import Coordinator
from repro_torch.cluster.sim import SimTransport
from repro_torch.cluster.transport import RoleHostDied
from repro_torch.elastic.membership import ALIVE, FailureTrace
from repro_torch.elastic.recovery import ServingDrainReadmit
from repro_torch.models.model import n_prefix
from repro_torch.obs import recorder as obs
from repro_torch.serving.engine import CHUNK_CAP, ServeEngine, ServeProgram
from repro_torch.serving.request import (FinishedRequest, Request,
                                         validate_budget)
from repro_torch.serving.router import ThroughputRouter


@dataclasses.dataclass
class Replica:
    """One serving replica: an engine plus its simulated-time ledger."""
    rid: int
    engine: ServeEngine
    credits: float = 0.0
    fin_cursor: int = 0  # engine.finished entries already collected

    @property
    def load(self) -> int:
        return self.engine.pool.num_active + self.engine.scheduler.pending


@dataclasses.dataclass
class Hedge:
    """One speculative continuation racing its SUSPECT primary.

    `prefix` is what the primary had emitted at launch time; the backup's
    copy starts from that point, so whichever copy wins, the stitched
    output is the same byte sequence (greedy decode is deterministic).
    `primary_mark` snapshots the primary's emitted count at launch —
    first-token-wins arbitration compares growth past this mark against
    the backup's first emission."""
    rid: int                  # request id
    original: Request
    prefix: List[int]
    primary: int              # replica ids
    helper: int
    primary_mark: int


class ServeFleet:
    def __init__(self, params, cfg, *, replicas: int, num_slots: int,
                 cache_len: int, trace: Optional[FailureTrace] = None,
                 heartbeat_timeout: int = 3, chunk_cap: int = CHUNK_CAP,
                 router_decay: float = 0.5, transport=None,
                 preemptive_drain: bool = True,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 migrate_kv: bool = True,
                 hedged_decode: bool = False,
                 device: DeviceLike = None):
        if replicas < 1:
            raise ValueError("need at least one replica")
        if transport is not None and trace is not None:
            # a transport brings its own event source; silently ignoring
            # the trace would serve failure-free and look like valid
            # results
            raise ValueError("pass either trace= or transport= (put the "
                             "trace inside the transport, e.g. "
                             "ProcTransport(inject=trace))")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.chunk_cap = chunk_cap
        self.page_size = page_size
        self.num_pages = num_pages
        # paged fleets migrate harvested KV with each drain by default:
        # continuations re-admit by installing pages instead of
        # re-prefilling their prefix (bit-identical either way)
        self.migrate_kv = migrate_kv and page_size is not None
        self.hedged_decode = hedged_decode
        # one compiled program shared by every replica, present and future
        self.program = ServeProgram(cfg, cache_len=cache_len,
                                    page_size=page_size)
        # the shared control plane: fail/hang/join/slow semantics live in
        # the coordinator's membership machine, identical to training's;
        # the fleet only subscribes to the transitions it must enact (no
        # cumulative log: a fleet may run indefinitely)
        self.coordinator = Coordinator(
            transport or SimTransport(trace or FailureTrace()),
            replicas, heartbeat_timeout=heartbeat_timeout,
            keep_transition_log=False)
        try:
            self.coordinator.subscribe("death", self._on_death)
            self.coordinator.subscribe("join", self._on_join)
            if hedged_decode:
                # hedging replaces preemptive drain: the suspect KEEPS its
                # work and a speculative copy races it on a healthy replica
                self.coordinator.subscribe("suspect", self._on_hedge)
            elif preemptive_drain:
                self.coordinator.subscribe("suspect", self._on_suspect)
            self.router = ThroughputRouter(decay=router_decay)
            self.policy = ServingDrainReadmit()
            self.replicas: Dict[int, Replica] = {
                r: self._spawn(r) for r in range(replicas)}
        except BaseException:
            # the coordinator already started the transport (live
            # ProcTransport workers): a failed replica spawn must not
            # leak them past a construction that never returned
            self.coordinator.close()
            raise
        self.finished: List[FinishedRequest] = []
        self.wall = 0
        # obs: fleet time is the simulated wall tick, so recorded
        # request lifecycles are trace-deterministic (like run_elastic)
        rec = obs.get()
        if rec.enabled:
            rec.clock = lambda: float(self.wall)
        self.drains = 0
        self.preemptive_drains = 0
        self.submitted = 0
        self._n_prefix = n_prefix(cfg)
        # in-flight hedges (rid -> Hedge) + lifetime arbitration counters
        self._hedges: Dict[int, Hedge] = {}
        # rid -> prefix the winning BACKUP copy must be stitched behind
        # (a primary win needs no stitch: its tokens already include it)
        self._hedge_prefix: Dict[int, List[int]] = {}
        self._backup_hosts: set = set()  # hosts with the role opened
        self.hedges_launched = 0
        self.hedges_won_backup = 0
        self.hedges_won_primary = 0
        # engine counters (prefill_tokens etc.) die with a drained
        # replica; fold them into this accumulator so fleet stats cover
        # the whole run, not just the survivors
        self._retired = {"prefill_tokens": 0, "migrated_admits": 0,
                         "migrated_tokens_saved": 0, "preemptions": 0,
                         "page_steps": 0, "decode_ticks": 0,
                         "prefill_ticks": 0}

    @property
    def membership(self):
        """The coordinator's membership view (read-only convenience)."""
        return self.coordinator.membership

    def _spawn(self, rid: int) -> Replica:
        return Replica(rid, ServeEngine(
            self.params, self.cfg, num_slots=self.num_slots,
            cache_len=self.cache_len, chunk_cap=self.chunk_cap,
            page_size=self.page_size, num_pages=self.num_pages,
            program=self.program, device=self.device, host=rid))

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        validate_budget(req, self._n_prefix, self.cache_len)
        self.router.submit(req)
        self.submitted += 1

    # ------------------------------------------------------------------
    def _collect(self, rep: Replica) -> None:
        """Pull newly finished requests off a replica, stitching drained
        prefixes back on."""
        fins = rep.engine.finished
        for fin in fins[rep.fin_cursor:]:
            h = self._hedges.get(fin.rid)
            if h is not None:
                # one copy of a live hedge finished: it wins on the spot
                # (waiting for the step-end arbitration could let the
                # other copy finish too and deliver the request twice)
                fin = self._resolve_hedge_finish(rep.rid, h, fin)
            prefix = self._hedge_prefix.pop(fin.rid, None)
            if prefix is not None:
                # a backup copy promoted by its primary's death: its
                # tokens start at the hedge point, prepend what the
                # primary had streamed
                fin = dataclasses.replace(fin, tokens=prefix + fin.tokens)
            self.finished.append(self.policy.stitch(fin))
        rep.fin_cursor = len(fins)

    def _resolve_hedge_finish(self, from_rid: int, h: "Hedge",
                              fin: FinishedRequest) -> FinishedRequest:
        del self._hedges[h.rid]
        if from_rid == h.primary:
            self._ledger_call(h.helper, "backup_cancel", f"serve:{h.rid}")
            loser = self.replicas.get(h.helper)
            self.hedges_won_primary += 1
        else:
            self._ledger_call(h.helper, "backup_commit", f"serve:{h.rid}")
            loser = self.replicas.get(h.primary)
            self.hedges_won_backup += 1
            fin = dataclasses.replace(fin, tokens=h.prefix + fin.tokens)
        if loser is not None:
            loser.engine.cancel(h.rid)
        obs.get().event("fleet.hedge_win", cat="serving", rid=h.rid,
                        winner="primary" if from_rid == h.primary
                        else "backup", wall=self.wall)
        return fin

    def _retire_counters(self, engine: ServeEngine) -> None:
        self._retired["prefill_tokens"] += engine.prefill_tokens
        self._retired["decode_ticks"] += engine.decode_ticks
        self._retired["prefill_ticks"] += engine.prefill_ticks
        if engine.paged:
            self._retired["migrated_admits"] += engine.migrated_admits
            self._retired["migrated_tokens_saved"] += \
                engine.migrated_tokens_saved
            self._retired["preemptions"] += engine.preemptions
            self._retired["page_steps"] += engine._page_steps

    def _drain_dead(self, rid: int) -> None:
        rep = self.replicas.pop(rid)
        self._collect(rep)  # finished-before-death outputs were delivered
        drained = rep.engine.drain(self.migrate_kv)
        drained = [d for d in drained
                   if not self._absorb_hedged_drain(d, rid)]
        conts = self.policy.readmit(drained)
        self._retire_counters(rep.engine)
        self.router.requeue_front(conts)
        self.router.forget(rid)
        self.drains += 1
        obs.get().event("fleet.drain", host=rid, cat="serving",
                        requeued=len(conts), wall=self.wall)

    # -- coordinator subscriptions -------------------------------------
    def _on_death(self, t) -> None:
        if t.worker in self.replicas:
            self._drain_dead(t.worker)

    def _on_join(self, t) -> None:
        self.replicas[t.worker] = self._spawn(t.worker)

    def _on_suspect(self, t) -> None:
        """Preemptive drain: the moment the detector stops trusting a
        replica, its in-flight requests become prefix continuations and
        requeue at the router — they do NOT wait out the heartbeat
        timeout on a replica that is probably dead.  The replica itself
        stays up (a false positive may still recover; it rejoins empty
        and routable).  Already-streamed tokens are preserved and the
        continuations are deterministic, so completed outputs remain
        bit-identical to the failure-free run."""
        rep = self.replicas.get(t.worker)
        if rep is None or rep.load == 0:
            return
        self._collect(rep)
        conts = self.policy.readmit(rep.engine.drain(self.migrate_kv))
        if conts:
            self.router.requeue_front(conts)
            self.preemptive_drains += 1
            obs.get().event("fleet.preemptive_drain", host=t.worker,
                            cat="serving", requeued=len(conts),
                            wall=self.wall)

    # -- hedged decode (speculative continuations for SUSPECT replicas) --
    def _emitted_for(self, rep: Replica, rid: int):
        """(tokens emitted by this replica's copy of rid, finished?) —
        the replica-local view arbitration and hedge launch read."""
        for fin in rep.engine.finished:
            if fin.rid == rid:
                return fin.tokens, True
        pool = rep.engine.pool
        for slot in np.flatnonzero(pool.active):
            slot = int(slot)
            if pool.request[slot].rid == rid:
                return list(pool.generated[slot]), False
        return None, False  # queued (nothing emitted) or unknown

    def _ledger_call(self, host: int, verb: str, task: str) -> Dict:
        t = self.coordinator.transport
        try:
            if (verb == "backup_launch"
                    and host not in self._backup_hosts):
                t.role_open(host, "backup")
                self._backup_hosts.add(host)
            return t.role_call(host, verb, {"task": task})
        except RoleHostDied:
            return {}

    def _on_hedge(self, t) -> None:
        """SUSPECT with hedging on: every in-flight request on the suspect
        keeps running there, and a speculative continuation launches on
        the healthiest routable replica through the cluster's `backup`
        role ledger (the serving analogue of straggler backup execution).
        First token past the hedge point wins — ties go to the primary —
        and the loser's copy is cancelled, freeing its slot and pages.
        A false-positive suspect therefore costs one redundant prefill
        instead of a drain + re-admit round trip."""
        rep = self.replicas.get(t.worker)
        if rep is None or rep.engine.pool.num_active == 0:
            return
        helpers = {r: h for r, h in self._routable().items()
                   if r != t.worker}
        if not helpers:
            return
        # deterministic helper: least loaded, lowest id breaks ties
        helper_id = min(helpers, key=lambda r: (helpers[r].load, r))
        helper = helpers[helper_id]
        pool = rep.engine.pool
        for slot in np.flatnonzero(pool.active):
            req = pool.request[int(slot)]
            if req.rid in self._hedges or req.rid in self._hedge_prefix:
                continue
            reply = self._ledger_call(helper_id, "backup_launch",
                                      f"serve:{req.rid}")
            if not reply.get("accepted"):
                continue  # duplicate task or helper died first
            prefix = list(pool.generated[int(slot)])
            remaining = req.max_new_tokens - len(prefix)
            if remaining <= 0:
                continue
            if prefix:
                prompt = np.concatenate([np.asarray(req.prompt, np.int32),
                                         np.asarray(prefix, np.int32)])
                cont = Request(rid=req.rid, prompt=prompt,
                               max_new_tokens=remaining,
                               eos_id=req.eos_id,
                               extra_embeds=req.extra_embeds)
            else:
                cont = req
            helper.engine.submit(cont)
            self._hedges[req.rid] = Hedge(req.rid, req, prefix, t.worker,
                                          helper_id, len(prefix))
            self.hedges_launched += 1
            obs.get().event("fleet.hedge_launch", host=t.worker,
                            cat="serving", rid=req.rid, helper=helper_id,
                            hedge_point=len(prefix), wall=self.wall)

    def _absorb_hedged_drain(self, d, dead_rid: int) -> bool:
        """A drained request that is mid-hedge does not readmit: the
        surviving copy owns it.  Returns True to drop `d` from the drain.
        Primary died -> promote the backup (its output stitches behind
        the hedge-point prefix; tokens the primary emitted PAST that
        point are recomputed identically by the backup).  Helper died ->
        the primary simply keeps going."""
        h = self._hedges.get(d.request.rid)
        if h is None:
            return False
        if dead_rid == h.primary:
            self._ledger_call(h.helper, "backup_commit",
                              f"serve:{h.rid}")
            self._hedge_prefix[h.rid] = h.prefix
            self.hedges_won_backup += 1
            del self._hedges[h.rid]
            obs.get().event("fleet.hedge_promote", host=h.helper,
                            cat="serving", rid=h.rid, wall=self.wall)
            return True
        if dead_rid == h.helper:
            self._ledger_call(h.helper, "backup_cancel", f"serve:{h.rid}")
            del self._hedges[h.rid]
            return True
        return False

    def _arbitrate_hedges(self) -> None:
        """First-token-wins, primary priority: the copy that produced a
        token past the hedge point keeps the request; the other is
        cancelled and its slot/pages freed.  Both copies compute the same
        byte sequence, so arbitration affects latency only."""
        for rid in list(self._hedges):
            h = self._hedges[rid]
            prim = self.replicas.get(h.primary)
            back = self.replicas.get(h.helper)
            if prim is None or back is None:
                continue  # a death this tick resolves it via drain
            p_toks, p_fin = self._emitted_for(prim, rid)
            b_toks, b_fin = self._emitted_for(back, rid)
            p_new = p_fin or (p_toks is not None
                              and len(p_toks) > h.primary_mark)
            b_new = b_fin or (b_toks is not None and len(b_toks) > 0)
            if p_new:
                winner, loser_rep = "primary", back
                self._ledger_call(h.helper, "backup_cancel",
                                  f"serve:{rid}")
                self.hedges_won_primary += 1
            elif b_new:
                winner, loser_rep = "backup", prim
                self._ledger_call(h.helper, "backup_commit",
                                  f"serve:{rid}")
                self._hedge_prefix[rid] = h.prefix
                self.hedges_won_backup += 1
            else:
                continue  # neither copy has its first token yet
            loser_rep.engine.cancel(rid)
            del self._hedges[rid]
            obs.get().event("fleet.hedge_win", cat="serving", rid=rid,
                            winner=winner, wall=self.wall)

    def _routable(self) -> Dict[int, Replica]:
        """Replicas the failure detector still trusts with NEW work: ALIVE
        and not suspected.  (A hung-but-undetected replica stays routable —
        exactly the window a real detector has — and anything routed there
        is drained when the timeout declares it dead.)"""
        out = {}
        for rid, rep in self.replicas.items():
            ws = self.membership.workers[rid]
            if ws.status == ALIVE:
                out[rid] = rep
        return out

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One wall tick: coordinator transitions (enacted through the
        subscriptions above), routing, execution.  "rate" transitions
        need no subscription: the slowdown is enacted by the credit
        schedule below and the router's EMA observes its effect on
        actual progress."""
        self.coordinator.advance(self.wall)

        if not self.replicas and (self.router.pending or
                                  self.policy.originals):
            raise RuntimeError(
                f"wall {self.wall}: all replicas dead with work pending")

        # route backlog onto routable replicas (joiners included: they
        # score nominal-rate with zero load and soak up the queue)
        routable = self._routable()
        assignments = self.router.route(
            {r: rep.engine.free_capacity for r, rep in routable.items()},
            {r: rep.load for r, rep in routable.items()})
        for req, rid in assignments:
            routable[rid].engine.submit(req)

        # execute: each replica earns `rate` credits; a hung replica makes
        # no progress at all (its heartbeat silence is what the membership
        # machine escalates).  Ops bill their true device cost so a fused
        # k-tick chunk spends k credits — a rate-0.25 straggler therefore
        # runs one pool tick every 4 wall ticks.
        rates = self.membership.rates()
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            ws = self.membership.workers[rid]
            if ws.hung:
                self.router.observe(rid, 0.0)
                continue
            rep.credits = min(rep.credits + rates.get(rid, 1.0),
                              float(self.chunk_cap))
            had_work = rep.load > 0
            executed = 0
            while rep.credits >= 1.0:
                before = rep.engine.decode_ticks
                kind = rep.engine.tick()
                if kind == "idle":
                    rep.credits = min(rep.credits, 1.0)
                    break
                cost = max(1, rep.engine.decode_ticks - before)
                rep.credits -= cost
                executed += cost
            # idle != slow: an empty replica's EMA must not decay toward
            # zero (it would lose routing to LOADED survivors when a drain
            # requeues work), so only ticks where the replica had work —
            # or was hung above — feed the monitor
            if had_work:
                self.router.observe(rid, float(executed))
            self._collect(rep)

        if self._hedges:
            self._arbitrate_hedges()
        self.wall += 1

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return (not self.router.pending
                and all(rep.engine.scheduler.done
                        for rep in self.replicas.values()))

    def run(self, requests: Optional[Sequence[Request]] = None,
            max_wall: int = 100_000) -> List[FinishedRequest]:
        """Drain `requests` (plus queued backlog) to completion under the
        trace; returns stitched finished requests sorted by request id."""
        for req in requests or ():
            self.submit(req)
        while not self.done:
            if self.wall >= max_wall:
                raise RuntimeError(f"fleet did not drain in {max_wall} "
                                   f"wall ticks")
            self.step()
        return sorted(self.finished, key=lambda f: f.rid)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        toks = sum(len(f.tokens) for f in self.finished)
        engines = [rep.engine for rep in self.replicas.values()]
        prefill_tokens = (self._retired["prefill_tokens"]
                          + sum(e.prefill_tokens for e in engines))
        rec = obs.get()
        if rec.enabled:
            rec.gauge("serving.delivered_tokens", float(toks))
            rec.gauge("serving.goodput", toks / max(self.wall, 1))
            rec.gauge("serving.drains", float(self.drains))
            rec.gauge("serving.preemptive_drains",
                      float(self.preemptive_drains))
        out = {
            "wall": self.wall,
            "delivered_tokens": toks,
            "goodput": toks / max(self.wall, 1),
            "finished": len(self.finished),
            "submitted": self.submitted,
            "drains": self.drains,
            "preemptive_drains": self.preemptive_drains,
            "readmitted": self.policy.readmitted,
            "replicas": len(self.replicas),
            "epoch": self.coordinator.epoch,
            "routed": dict(self.router.routed),
            "prefill_tokens": prefill_tokens,
        }
        if self.page_size is not None:
            page_steps = (self._retired["page_steps"]
                          + sum(e._page_steps for e in engines))
            tick_pages = (self._retired["decode_ticks"]
                          + sum(e.decode_ticks for e in engines))
            tick_pages *= engines[0].num_pages if engines else 1
            out.update({
                "migrated_admits": self._retired["migrated_admits"]
                + sum(e.migrated_admits for e in engines),
                "migrated_tokens_saved":
                self._retired["migrated_tokens_saved"]
                + sum(e.migrated_tokens_saved for e in engines),
                "preemptions": self._retired["preemptions"]
                + sum(e.preemptions for e in engines),
                "pool_occupancy": page_steps / max(tick_pages, 1),
            })
            if rec.enabled:
                rec.gauge("serving.pool_occupancy",
                          out["pool_occupancy"])
        if self.hedged_decode:
            out.update({"hedges_launched": self.hedges_launched,
                        "hedges_won_primary": self.hedges_won_primary,
                        "hedges_won_backup": self.hedges_won_backup})
        return out

    def engine_stats(self) -> Dict[str, int]:
        """The engines' work summed over the run, drained (retired)
        replicas included: admits that prefilled (`prefill_ticks`) and
        pool decode ticks (`decode_ticks`), the counts that a kernel's
        launches follow (one flash launch an attention layer an admit, one
        paged launch an attention layer a decode tick), and the migrated
        admits, which launch neither."""
        engines = [rep.engine for rep in self.replicas.values()]
        out = {k: self._retired[k] + sum(getattr(e, k) for e in engines)
               for k in ("prefill_ticks", "decode_ticks", "prefill_tokens")}
        out["migrated_admits"] = self._retired["migrated_admits"] + sum(
            e.migrated_admits for e in engines)
        return out

    def close(self) -> None:
        """Tear down the control plane (ProcTransport workers; no-op for
        the simulated clock)."""
        self.coordinator.close()
