"""Slot pool + FIFO admission scheduler (host-side bookkeeping; a copy of
the JAX package's ``serving/scheduler.py``).

The scheduler decides WHICH request enters WHICH slot and when; all device
work (prefill, batched decode) stays in the engine.  Policy here is plain
FIFO with immediate backfill — a freed slot is re-offered to the head of
the queue on the very next tick, so the pool never drains to admit work
(the slot-level version of asynchronous worker scheduling: no barrier
between "this request finished" and "that request starts").
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request


class SlotPool:
    """Per-slot host state for a pool of `num_slots` cache rows."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.request: List[Optional[Request]] = [None] * num_slots
        self.pos = np.zeros(num_slots, np.int32)       # next decode position
        self.active = np.zeros(num_slots, bool)
        self.generated: List[List[int]] = [[] for _ in range(num_slots)]
        self.admitted_tick = np.zeros(num_slots, np.int64)

    def free_slot(self) -> Optional[int]:
        idle = np.flatnonzero(~self.active)
        return int(idle[0]) if idle.size else None

    def occupy(self, slot: int, req: Request, pos: int, tick: int) -> None:
        assert not self.active[slot]
        self.request[slot] = req
        self.pos[slot] = pos
        self.active[slot] = True
        self.generated[slot] = []
        self.admitted_tick[slot] = tick

    def release(self, slot: int) -> None:
        self.request[slot] = None
        self.active[slot] = False

    @property
    def num_active(self) -> int:
        return int(self.active.sum())


class PagePool:
    """Host-side allocator for the shared paged KV pool.

    Free pages are handed out lowest-id-first and returned to sorted
    order, so the page layout is a pure function of the admit/release
    history — what keeps paged runs replayable and the migration tests
    byte-exact.  Pages are owned by slots; `owned[slot]` is in POSITION
    order (entry j backs logical positions [j*P, (j+1)*P))."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free: List[int] = list(range(num_pages))
        self.owned: Dict[int, List[int]] = {}

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    def alloc(self, slot: int, n: int) -> Optional[List[int]]:
        """Extend `slot`'s table by n pages; None if the pool is short."""
        if n > len(self.free):
            return None
        got, self.free = self.free[:n], self.free[n:]
        self.owned.setdefault(slot, []).extend(got)
        return got

    def release(self, slot: int) -> List[int]:
        pages = self.owned.pop(slot, [])
        self.free = sorted(self.free + pages)
        return pages


class FifoScheduler:
    """FIFO queue over a SlotPool: `next_admission` pairs the head-of-line
    request with the lowest free slot, or returns None when either side is
    empty (then the engine runs a decode tick instead)."""

    def __init__(self, pool: SlotPool):
        self.pool = pool
        self.queue: Deque[Request] = collections.deque()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def next_admission(self) -> Optional[tuple]:
        if not self.queue:
            return None
        slot = self.pool.free_slot()
        if slot is None:
            return None
        return self.queue.popleft(), slot

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def done(self) -> bool:
        return not self.queue and self.pool.num_active == 0
