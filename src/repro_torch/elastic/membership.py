"""Cluster membership as a deterministic, trace-driven state machine.

The port's copy of the JAX package's ``elastic/membership.py`` (stdlib
only, so the proc transport's worker children import it without torch).

Real elastic training reacts to an unreliable failure detector: heartbeats
stop, a worker is suspected, then declared dead; new workers join; slow
workers are flagged by throughput telemetry.  None of that is reproducible
if it comes from wall clocks and real processes, so the entire detector is
driven by a **replayable trace**: a sorted list of (step, kind, worker)
events.  Every fault scenario — a crash, a hang that escalates through the
heartbeat timeout, a scale-up, a straggler — is a trace file, and every
trace replays to the identical sequence of membership transitions
(`tests/test_torch_elastic_core.py` holds them against the JAX package).

Event kinds (the trace vocabulary):
  fail    worker dies instantly (process crash; detector sees a closed
          connection — death is declared the same step)
  hang    worker stops heartbeating but is not known dead; it is SUSPECT
          after `suspect_after` silent steps and DEAD after
          `heartbeat_timeout` (the survey's fail-stop-by-timeout model)
  recover a hung worker resumes heartbeating (false-positive path: if it
          was already declared dead it stays dead — declarations are final,
          the worker must re-`join` with a fresh id)
  join    a new worker enters at full rate (scale-up)
  slow    telemetry marks the worker's relative throughput (rate < 1.0 is
          a straggler; recovery replans batch splits with `dbs_partition`)

The machine separates *wall steps* (monotonic, what `advance` consumes)
from the trainer's *progress steps* (which rewind on checkpoint restore) —
membership never rewinds, matching real clusters where failures happen in
wall time regardless of how far training rolled back.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"
EVENT_KINDS = ("fail", "hang", "recover", "join", "slow")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    step: int
    kind: str
    worker: int
    rate: float = 1.0  # only meaningful for kind == "slow"

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")
        if self.step < 0 or self.rate <= 0:
            raise ValueError(f"bad event {self!r}")


@dataclasses.dataclass(frozen=True)
class Transition:
    """An observed membership change (what recovery policies react to).

    "suspect" fires exactly once on the ALIVE -> SUSPECT edge of the
    heartbeat scan — the earliest moment a consumer may act on a likely
    (but not yet declared) failure, e.g. the serving fleet's preemptive
    drain.  It never bumps the generation: suspicion is reversible."""
    step: int
    kind: str          # "death" | "join" | "rate" | "suspect"
    worker: int
    cause: str = ""    # death: "fail" | "timeout"
    rate: float = 1.0  # new relative throughput for "rate"

    def as_tuple(self) -> Tuple:
        """Canonical serializable form — the unit of the cross-transport
        equivalence log (cluster.Coordinator.transition_log)."""
        return (self.step, self.kind, self.worker, self.cause, self.rate)


class FailureTrace:
    """Immutable, step-sorted event list with JSON round-trip."""

    def __init__(self, events: Iterable[TraceEvent] = ()):
        self.events: Tuple[TraceEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.worker, e.kind)))

    @classmethod
    def single_failure(cls, step: int, worker: int = 0) -> "FailureTrace":
        return cls([TraceEvent(step, "fail", worker)])

    @classmethod
    def load(cls, path: str) -> "FailureTrace":
        raw = json.loads(pathlib.Path(path).read_text())
        return cls(TraceEvent(int(e["step"]), e["kind"], int(e["worker"]),
                              float(e.get("rate", 1.0))) for e in raw)

    def save(self, path: str) -> None:
        pathlib.Path(path).write_text(json.dumps(
            [dataclasses.asdict(e) for e in self.events], indent=1))

    def at(self, step: int) -> List[TraceEvent]:
        return [e for e in self.events if e.step == step]

    def __len__(self) -> int:
        return len(self.events)


@dataclasses.dataclass
class WorkerState:
    wid: int
    status: str = ALIVE
    last_heartbeat: int = -1
    rate: float = 1.0
    hung: bool = False


class Membership:
    """The failure detector + membership view.

    `advance(step)` must be called with strictly increasing wall steps; it
    applies the trace events for that step, runs the heartbeat scan, and
    returns the transitions in a deterministic order (deaths, then joins,
    then rate changes — recovery policies rely on seeing a death before the
    join that replaces it).  `generation` bumps on every death/join so
    stale per-worker state can be fenced by comparing generations.
    """

    def __init__(self, num_workers: int, trace: Optional[FailureTrace] = None,
                 *, heartbeat_timeout: int = 3, suspect_after: int = 1):
        if num_workers < 1:
            raise ValueError("need at least one worker")
        if suspect_after > heartbeat_timeout:
            raise ValueError("suspect_after must be <= heartbeat_timeout")
        self.trace = trace or FailureTrace()
        self.heartbeat_timeout = heartbeat_timeout
        self.suspect_after = suspect_after
        self.workers: Dict[int, WorkerState] = {
            w: WorkerState(w) for w in range(num_workers)}
        self.generation = 0
        self._next_id = num_workers
        self._last_step = -1

    # -- views ---------------------------------------------------------
    def alive(self) -> Tuple[int, ...]:
        return tuple(sorted(w for w, s in self.workers.items()
                            if s.status != DEAD))

    def rates(self) -> Dict[int, float]:
        return {w: self.workers[w].rate for w in self.alive()}

    def spawn_id(self) -> int:
        """Fresh worker id for a scale-up event (ids are never reused)."""
        wid = self._next_id
        self._next_id += 1
        return wid

    # -- the state machine --------------------------------------------
    def advance(self, step: int) -> List[Transition]:
        """Trace-driven stepping: apply this wall step's trace events."""
        return self.apply(step, self.trace.at(step))

    def apply(self, step: int,
              events: Iterable[TraceEvent]) -> List[Transition]:
        """Apply externally observed detector events for one wall step.

        This is the transport-agnostic core: `advance` feeds it from the
        replayable trace, while `cluster.Coordinator` feeds it whatever
        its Transport observed (simulated events or real multi-process
        heartbeat telemetry).  Either way the policy — event ordering,
        SUSPECT/DEAD escalation, generation fencing — is defined once,
        here."""
        if step <= self._last_step:
            raise ValueError(f"advance() must move forward "
                             f"({step} <= {self._last_step})")
        self._last_step = step
        deaths: List[Transition] = []
        joins: List[Transition] = []
        rates: List[Transition] = []
        suspects: List[Transition] = []

        for ev in events:
            if ev.kind == "join":
                wid = ev.worker if ev.worker not in self.workers \
                    else self.spawn_id()
                self._next_id = max(self._next_id, wid + 1)
                self.workers[wid] = WorkerState(wid, last_heartbeat=step)
                joins.append(Transition(step, "join", wid))
                continue
            ws = self.workers.get(ev.worker)
            if ws is None or ws.status == DEAD:
                continue  # events against unknown/dead workers are no-ops
            if ev.kind == "fail":
                ws.status = DEAD
                deaths.append(Transition(step, "death", ws.wid, cause="fail"))
            elif ev.kind == "hang":
                ws.hung = True
            elif ev.kind == "recover":
                ws.hung = False
                ws.status = ALIVE
                ws.rate = 1.0
                rates.append(Transition(step, "rate", ws.wid, rate=1.0))
            elif ev.kind == "slow":
                ws.rate = ev.rate
                rates.append(Transition(step, "rate", ws.wid, rate=ev.rate))

        # heartbeat scan: healthy workers beat this step; hung ones go
        # silent and escalate SUSPECT -> DEAD on the trace-free timeline
        for wid in sorted(self.workers):
            ws = self.workers[wid]
            if ws.status == DEAD:
                continue
            if not ws.hung:
                ws.last_heartbeat = step
                continue
            silent = step - ws.last_heartbeat
            if silent >= self.heartbeat_timeout:
                ws.status = DEAD
                deaths.append(Transition(step, "death", wid, cause="timeout"))
            elif silent >= self.suspect_after:
                if ws.status != SUSPECT:
                    suspects.append(Transition(step, "suspect", wid))
                ws.status = SUSPECT

        self.generation += len(deaths) + len(joins)
        return deaths + joins + rates + suspects
