"""Sharded prioritized trajectory replay + published-params store.

The port's copy of the JAX package's ``core/replay_shard.py``.

The server-side state of the actor–learner fleet's two new cluster
roles (`cluster.roles`: "replay" and "learner"), mirroring
`core.param_server`'s conventions exactly:

* deliberately numpy-only (no torch) — the proc transport's replay/learner
  children must import this without the torch startup tax, and float32
  numpy server math is bit-identical whether the shard lives in the
  driver process (sim) or behind a pipe (proc);
* versioned stores, so clients can observe how stale a pull/sample was;
* all wire traffic rides the exact `param_server.encode_entries` codec.

Three pieces:

* `ReplayShard` — one shard of the Ape-X-style prioritized replay
  service (survey ref 104): actors *push* whole trajectories (leaves
  keyed by name, leading item axis) with initial priorities; learners
  *sample* proportional to priority^alpha with importance weights
  (beta-annealing left to the client) and *update* priorities from
  fresh TD errors.  Sampling is seeded BY THE REQUESTER, so a replayed
  command stream reproduces the identical sample — determinism lives in
  the protocol, not the process.
* `ParamStore` — the learner role's versioned published-parameters
  store: the learner computes its own updates (unlike `PSShard`, there
  is no server-side SGD) and *publishes*, bumping the version actors
  watch; actors *pull* the current snapshot.
* `stratified_assign` — the priority-stratified sharding key: rank
  items by priority and deal them round-robin across shards, so every
  shard holds a cross-section of the priority spectrum and a killed
  shard costs coverage, not a priority band (the fleet degrades
  unbiased to the survivors).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Entries = Dict[str, np.ndarray]

_EPS = 1e-6  # priority floor: a written slot is never unsampleable


class ReplayShard:
    """One versioned shard of the prioritized trajectory replay.

    Storage is a fixed-capacity ring per leaf, allocated lazily on the
    first push (the shard learns the trajectory schema from the data).
    Unwritten slots keep priority 0.0 and can never be sampled — the
    proportional draw's support is exactly the written region.
    """

    def __init__(self, capacity: int, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.seed = int(seed)
        self.store: Entries = {}
        self.prios = np.zeros(self.capacity, np.float64)
        self.cursor = 0
        self.size = 0
        self.version = 0
        self.pushes = 0          # items ever written
        self.sampled = 0         # items ever served

    def push(self, actor: int, clock: int, items: Entries,
             priorities: np.ndarray) -> int:
        """Ring-write `n` items (leaves shaped (n, ...)) with their
        initial priorities; returns the bumped shard version.  `actor`/
        `clock` ride along for parity with `PSShard.push` telemetry."""
        del actor, clock
        priorities = np.asarray(priorities, np.float64).reshape(-1)
        n = priorities.shape[0]
        if n == 0:
            return self.version
        if n > self.capacity:
            raise ValueError(f"push of {n} items exceeds shard capacity "
                             f"{self.capacity}")
        idx = (self.cursor + np.arange(n)) % self.capacity
        for key, arr in items.items():
            arr = np.asarray(arr, np.float32)
            if arr.shape[0] != n:
                raise ValueError(f"leaf {key!r} has {arr.shape[0]} items, "
                                 f"priorities have {n}")
            if key not in self.store:
                self.store[key] = np.zeros((self.capacity,) + arr.shape[1:],
                                           np.float32)
            self.store[key][idx] = arr
        self.prios[idx] = (np.abs(priorities) + _EPS) ** self.alpha
        self.cursor = int((self.cursor + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)
        self.version += 1
        self.pushes += n
        return self.version

    def sample(self, batch: int, seed: int
               ) -> Tuple[np.ndarray, Entries, np.ndarray]:
        """Draw `batch` items (with replacement) proportional to
        priority; returns (slot indices, items, float32 importance
        weights normalized by their max).  `seed` comes from the
        requester so replaying the command stream replays the draw."""
        if self.size == 0:
            raise ValueError("sample from an empty shard")
        p = self.prios / self.prios.sum()
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, int(seed))))
        idx = rng.choice(self.capacity, size=int(batch), replace=True, p=p)
        w = (self.size * p[idx]) ** -self.beta
        w = (w / w.max()).astype(np.float32)
        items = {k: v[idx] for k, v in self.store.items()}
        self.sampled += int(batch)
        return idx, items, w

    def update(self, idx: np.ndarray, priorities: np.ndarray) -> None:
        """Re-prioritize previously sampled slots from fresh TD errors
        (the learner's half of the Ape-X loop)."""
        idx = np.asarray(idx, np.int64)
        priorities = np.asarray(priorities, np.float64).reshape(-1)
        self.prios[idx] = (np.abs(priorities) + _EPS) ** self.alpha
        self.version += 1

    def stats(self) -> Dict[str, float]:
        return {"size": self.size, "capacity": self.capacity,
                "version": self.version, "pushes": self.pushes,
                "sampled": self.sampled}


class ParamStore:
    """Versioned published-parameters store — the learner role's state.

    Mirrors `PSShard`'s versioned-KV surface minus the server-side SGD:
    the learner owns its optimizer and publishes finished parameters;
    `version` counts publishes, which is the staleness unit actors
    report (pulled version vs. the learner's latest)."""

    def __init__(self):
        self.store: Entries = {}
        self.version = 0

    def publish(self, entries: Entries) -> int:
        for k, v in entries.items():
            self.store[k] = np.array(v, np.float32)
        self.version += 1
        return self.version

    def pull(self) -> Tuple[int, Entries]:
        return self.version, {k: v.copy() for k, v in self.store.items()}


def stratified_assign(priorities: np.ndarray, num_shards: int) -> np.ndarray:
    """Shard index per item, stratified by priority rank: sort items by
    descending priority (stable) and deal round-robin, so each shard's
    holdings span the full priority spectrum.  Deterministic, and the
    reason shard death degrades coverage instead of deleting the
    high-priority band."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    priorities = np.asarray(priorities, np.float64).reshape(-1)
    order = np.argsort(-priorities, kind="stable")
    assign = np.empty(priorities.shape[0], np.int64)
    assign[order] = np.arange(priorities.shape[0]) % num_shards
    return assign
