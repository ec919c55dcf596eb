"""Parameter-server update math and bounded-staleness clocks.

The survey's taxonomy splits distributed training along two axes:
*centralized* (parameter server) vs. *decentralized* (all-reduce)
topology, and *asynchronous* vs. *(stale-)synchronous* consistency.
`core.data_parallel` implements the all-reduce family; this module is
its centralized counterpart — the server-side state a `ParamServer`
host owns, shared verbatim by the in-process `SimTransport` shards and
the real `ProcTransport` PS child processes.

The port's copy of the JAX package's ``core/param_server.py``.
Deliberately numpy-only (no torch): the proc-transport PS child must be
able to import this without paying the torch startup tax, and server-side
SGD in float32 numpy is bit-identical whether the shard lives in the
driver process (sim) or behind a pipe (proc), and in either package.

Three pieces:

* `PSShard` — a versioned key->array store with Downpour-style server
  SGD (optionally with server-side momentum): workers *push* gradients,
  the shard folds them in and bumps its version; workers *pull* the
  current parameters.  Per-worker push clocks ride along so SSP
  consistency can be audited server-side.
* `SSPClockGate` — the stale-synchronous-parallel admission rule: a
  worker may advance to clock c+1 only while `c+1 - min_clock <= s`.
  With `staleness=None` the gate never blocks (fully async).  The
  coordinator wires death transitions to `drop`, so a dead straggler
  releases the fleet instead of freezing it.
* `encode_entries` / `decode_entries` — exact float32 wire codec
  (base64 of raw bytes) for the proc transport's line-JSON pipes; exact
  round-trip is what makes sim/proc training bit-identical.
"""
from __future__ import annotations

import base64
from typing import Dict, List, Optional, Tuple

import numpy as np

Entries = Dict[str, np.ndarray]


class PSShard:
    """One versioned key-value shard of the parameter server.

    ``push`` applies plain SGD (`w -= lr * g`, float32, optional heavy
    momentum buffer) immediately — there is no barrier and no gradient
    bucket; interleaving IS the async-PS semantics.  ``version`` counts
    applied pushes so clients can observe how stale a pull was.
    """

    def __init__(self, lr: float, momentum: float = 0.0):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.store: Entries = {}
        self._vel: Entries = {}
        self.version = 0
        self.clocks: Dict[int, int] = {}  # worker -> last pushed clock

    def init(self, entries: Entries) -> None:
        for k, v in entries.items():
            self.store[k] = np.array(v, np.float32)

    def push(self, worker: int, clock: int, grads: Entries) -> int:
        # in place on the shard's own arrays, in the JAX package's order
        # of float32 operations (m * vel + g, then w - lr * g): the same
        # bits, without a model-sized temporary per operation
        for k, g in grads.items():
            g = np.asarray(g, np.float32)
            if self.momentum:
                vel = self._vel.get(k)
                if vel is None:
                    vel = g.copy()
                else:
                    vel *= np.float32(self.momentum)
                    vel += g
                self._vel[k] = vel
                g = vel
            self.store[k] -= g * np.float32(self.lr)
        self.version += 1
        self.clocks[int(worker)] = int(clock)
        return self.version

    def pull(self) -> Tuple[int, Entries]:
        return self.version, {k: v.copy() for k, v in self.store.items()}

    def forget(self, worker: int) -> None:
        self.clocks.pop(int(worker), None)


class SSPClockGate:
    """Bounded-staleness admission over per-worker clocks.

    A worker at clock c may start the step taking it to c+1 only if
    ``c + 1 - min_clock <= staleness`` — so the observed clock gap
    never exceeds `s`, and a worker blocked at exactly gap `s` is
    released the moment the slowest registered worker advances (or
    dies and is dropped).
    """

    def __init__(self, staleness: Optional[int] = None):
        if staleness is not None and staleness < 0:
            raise ValueError("staleness must be >= 0 (or None for async)")
        self.staleness = staleness
        self.clocks: Dict[int, int] = {}

    def register(self, worker: int, clock: int = 0) -> None:
        self.clocks[int(worker)] = int(clock)

    def drop(self, worker: int) -> None:
        self.clocks.pop(int(worker), None)

    def min_clock(self) -> int:
        return min(self.clocks.values()) if self.clocks else 0

    def gap(self, worker: int) -> int:
        return self.clocks[worker] - self.min_clock()

    def can_advance(self, worker: int) -> bool:
        if self.staleness is None or len(self.clocks) <= 1:
            return True
        return self.clocks[worker] + 1 - self.min_clock() <= self.staleness

    def advance(self, worker: int) -> int:
        self.clocks[worker] += 1
        return self.clocks[worker]


def shard_keys(keys: List[str], num_shards: int) -> List[List[str]]:
    """Deterministic round-robin partition of sorted keys over shards."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    out: List[List[str]] = [[] for _ in range(num_shards)]
    for i, k in enumerate(sorted(keys)):
        out[i % num_shards].append(k)
    return out


# ---------------------------------------------------------------------------
# float32 wire codec for the proc transport's line-JSON pipes
# ---------------------------------------------------------------------------
def encode_entries(entries: Entries) -> Dict[str, Dict]:
    wire = {}
    for k, v in entries.items():
        arr = np.ascontiguousarray(np.asarray(v, np.float32))
        wire[k] = {"shape": list(arr.shape),
                   "b64": base64.b64encode(arr.tobytes()).decode("ascii")}
    return wire


def decode_entries(wire: Dict[str, Dict]) -> Entries:
    out = {}
    for k, spec in wire.items():
        buf = base64.b64decode(spec["b64"])
        out[k] = np.frombuffer(buf, np.float32).reshape(spec["shape"]).copy()
    return out
