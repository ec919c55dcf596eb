"""Straggler-aware request routing across serving replicas.

The port of the JAX package's ``serving/router.py`` (host-only Python,
the same code).

The fleet-level FIFO queue lives here; the router decides WHICH replica
each head-of-line request lands on.  It is the serving analogue of the
training stack's DBS replan (`elastic.straggler`): the same
`ThroughputMonitor` EMA, fed with each replica's *observed* progress
(engine ticks executed per wall tick), weights admission toward fast,
lightly-loaded replicas and away from stragglers — a replica slowed by a
trace `slow` event executes fewer ticks, its EMA decays, and new requests
stop landing on it long before any membership transition fires.  A hung
replica's EMA decays toward zero the same way, so routing reacts to the
*symptom* immediately while the failure detector (`elastic.membership`)
takes its heartbeat-timeout course.

Admission policy (deterministic, host-only):

  score(r) = ema_rate(r) / (1 + load(r))

over replicas the membership still marks routable (ALIVE, not suspected)
with free capacity; highest score wins, ties broken by lowest replica id.
Fresh joiners have no EMA history and are assumed nominal-rate
(`ThroughputMonitor.rates`), so a `join` replica — empty pool, nominal
score — immediately absorbs queue backlog.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.elastic.straggler import ThroughputMonitor
from repro_torch.serving.request import Request


@dataclasses.dataclass
class ThroughputRouter:
    """EMA-weighted, least-loaded admission over a replica set."""
    decay: float = 0.5
    monitor: ThroughputMonitor = None

    def __post_init__(self):
        if self.monitor is None:
            self.monitor = ThroughputMonitor(decay=self.decay)
        self.queue: Deque[Request] = collections.deque()
        self.routed: Dict[int, int] = {}  # replica id -> requests admitted

    # -- queue ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def requeue_front(self, reqs: Sequence[Request]) -> None:
        """Re-admit drained continuations ahead of fresh backlog, keeping
        their relative (rid = submission) order: extendleft reverses, so
        feed it the reversed list."""
        self.queue.extendleft(reversed(list(reqs)))

    @property
    def pending(self) -> int:
        return len(self.queue)

    # -- telemetry -----------------------------------------------------
    def observe(self, replica: int, ticks: float) -> None:
        """Feed one wall tick of observed progress (engine ticks run)."""
        self.monitor.observe(replica, ticks, 1.0)

    def forget(self, replica: int) -> None:
        """Drop the dead replica's EMA (membership never reuses ids, and a
        joiner must start at the nominal assumption, not a corpse's rate).
        `routed` is pure accounting and is kept: stats must still
        reconcile admissions against submitted + readmitted."""
        self.monitor.forget(replica)

    # -- admission -----------------------------------------------------
    def pick(self, free: Dict[int, int], load: Dict[int, int]
             ) -> Optional[int]:
        """Choose a replica for the head-of-line request.  `free` maps
        routable replica id -> free capacity (only >0 entries considered);
        `load` maps replica id -> requests currently on it."""
        candidates = [r for r, f in free.items() if f > 0]
        if not candidates:
            return None
        rates = self.monitor.rates(candidates)
        return max(candidates,
                   key=lambda r: (rates[r] / (1.0 + load.get(r, 0)), -r))

    def route(self, free: Dict[int, int], load: Dict[int, int]
              ) -> List[Tuple[Request, int]]:
        """Drain as much of the queue as current capacity allows; returns
        (request, replica id) assignments in admission order."""
        free = dict(free)
        load = dict(load)
        out = []
        while self.queue:
            r = self.pick(free, load)
            if r is None:
                break
            req = self.queue.popleft()
            out.append((req, r))
            free[r] -= 1
            load[r] = load.get(r, 0) + 1
            self.routed[r] = self.routed.get(r, 0) + 1
        return out
