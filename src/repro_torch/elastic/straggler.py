"""Straggler detection + mitigation.

The port of the JAX package's ``elastic/straggler.py`` (numpy; the batch
split comes from the port's ``plan_split``).

Synchronous data parallelism runs at the speed of its slowest worker (the
survey's straggler cost; `dbs_epoch_time`).  Mitigation here is the DBS
move (ref 71): keep an EMA of each worker's observed throughput, flag
workers that fall below a fraction of the cluster median, and re-plan the
global batch split proportionally to throughput so the slow worker gets
less work and the barrier arrives sooner.

The monitor consumes (worker, samples, seconds) observations — in the
simulated driver these come from the trace's `slow` events; on a real
cluster they would come from per-host step timers.  Everything downstream
(`plan_split` -> `dbs_partition`) is identical either way.

Next to the EMA lives the ETA model for speculative execution (the
survey's backup-task move, Verbraeken et al.): `predict_etas` turns a
batch split + the monitored rates into per-worker barrier ETAs, and
`plan_backup` decides whether the slowest shard is worth re-executing on
the least-loaded healthy host.  DBS and speculation are complements, not
alternatives: a flagged straggler gets its shard shrunk (ETAs
re-balance, no backup fires), while the DBS blind spots — a SUSPECT
worker whose rate telemetry is stale by definition, or a fresh slowdown
the split hasn't absorbed yet — are exactly where a backup can land
before the primary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.elastic.reshard import plan_split


@dataclasses.dataclass
class ThroughputMonitor:
    """EMA throughput per worker, in samples/sec relative units."""
    decay: float = 0.5
    nominal: float = 1.0
    ema: Dict[int, float] = dataclasses.field(default_factory=dict)

    def observe(self, worker: int, samples: float, seconds: float) -> None:
        """Fold one measured (samples, seconds) interval into the EMA.

        A cold worker's EMA seeds from `nominal` and blends, never from
        the first raw rate: a join replica's first observation is
        compile-inflated (warmup `seconds`), and seeding from it pinned
        the EMA low for several rounds, starving the joiner of work.
        """
        rate = samples / max(seconds, 1e-9)
        prev = self.ema.get(worker, self.nominal)
        self.ema[worker] = self.decay * prev + (1 - self.decay) * rate

    def set_rate(self, worker: int, rate: float) -> None:
        """Authoritatively pin a worker's rate (no EMA blend). Used for
        trace-reported rate transitions, which fire once per change and
        are ground truth, not noisy measurements."""
        self.ema[worker] = rate

    def forget(self, worker: int) -> None:
        self.ema.pop(worker, None)

    def rates(self, alive_ids: Sequence[int]) -> Dict[int, float]:
        """Unobserved workers (fresh joiners) are assumed nominal."""
        return {w: self.ema.get(w, self.nominal) for w in alive_ids}

    def stragglers(self, alive_ids: Sequence[int],
                   threshold: float = 0.5) -> Tuple[int, ...]:
        """Workers below `threshold` x median throughput."""
        rates = self.rates(alive_ids)
        if not rates:
            return ()
        med = float(np.median(list(rates.values())))
        return tuple(sorted(w for w, r in rates.items()
                            if r < threshold * med))


def replan_on_straggle(monitor: ThroughputMonitor,
                       alive_ids: Sequence[int], global_batch: int,
                       *, threshold: float = 0.5, multiple: int = 1
                       ) -> Tuple[Dict[int, int], Tuple[int, ...]]:
    """Batch split for the current membership: uniform while nobody lags,
    throughput-proportional (DBS) once the monitor flags a straggler.

    Uniform-by-default keeps the failure-free path byte-identical to the
    non-elastic trainer; the DBS split only kicks in on real telemetry.
    """
    slow = monitor.stragglers(alive_ids, threshold)
    if not slow:
        flat = {w: 1.0 for w in alive_ids}
        return plan_split(global_batch, flat, multiple), ()
    return plan_split(global_batch, monitor.rates(alive_ids), multiple), slow


def step_time(split: Dict[int, int], rates: Dict[int, float],
              overhead: float = 0.0) -> float:
    """Simulated synchronous step latency: the straggler bound
    max_i(rows_i / rate_i) plus a fixed barrier overhead."""
    if not split:
        return overhead
    return overhead + max(
        split[w] / max(rates.get(w, 1.0), 1e-9) for w in split)


# ---------------------------------------------------------------------------
# Speculative execution: the ETA model next to the EMA
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BackupDecision:
    """One planned backup execution: re-run `straggler`'s `rows`-row
    shard on `helper` and commit whichever copy lands first.

    `eta_primary` is the straggler's own predicted barrier arrival
    (infinite for SUSPECT workers); `eta_backup` is when the helper's
    redundant copy would land (its own shard plus the re-run, back to
    back on one host)."""
    straggler: int
    helper: int
    rows: int
    eta_primary: float
    eta_backup: float

    @property
    def winner(self) -> str:
        """Deterministic first-result-wins arbitration on the simulated
        clock: whichever predicted arrival is earlier, ties to the
        primary (the backup is the redundant copy)."""
        return "primary" if self.eta_primary <= self.eta_backup else "backup"


def predict_etas(split: Dict[int, int], rates: Dict[int, float],
                 suspects: Sequence[int] = ()) -> Dict[int, float]:
    """Per-worker ETA to the sync barrier: rows / observed rate.

    SUSPECT workers get an infinite ETA: a silent worker's rate EMA is
    stale by definition, so the failure detector — not the throughput
    monitor — is the authority on whether its shard arrives at all."""
    sus = frozenset(suspects)
    return {w: (math.inf if w in sus
                else split[w] / max(rates.get(w, 1.0), 1e-9))
            for w in split}


def plan_backup(split: Dict[int, int], rates: Dict[int, float], *,
                slack: float, suspects: Sequence[int] = ()
                ) -> Optional[BackupDecision]:
    """Decide whether the slowest shard deserves a backup execution.

    Fires only when BOTH hold:
      * the slowest worker's ETA exceeds `slack` x the fleet median of
        the finite ETAs (SUSPECT => infinite, always past any slack);
      * the backup could actually win — the least-loaded healthy host
        finishing its own shard and then the re-run still beats the
        primary's ETA.  A hopeless backup is never launched: it would
        bill wasted compute without ever moving the barrier.

    All tie-breaks are by lowest worker id, so the decision is a pure
    function of (split, rates, suspects) — deterministic under the
    simulated clock and identical on every transport."""
    if len(split) < 2:
        return None
    etas = predict_etas(split, rates, suspects)
    finite = [e for e in etas.values() if math.isfinite(e)]
    if not finite:
        return None
    straggler = min(etas, key=lambda w: (-etas[w], w))
    if not etas[straggler] > slack * float(np.median(finite)):
        return None
    healthy = [w for w in etas
               if w != straggler and math.isfinite(etas[w])]
    if not healthy:
        return None
    helper = min(healthy, key=lambda w: (etas[w], w))
    rows = split[straggler]
    eta_backup = etas[helper] + rows / max(rates.get(helper, 1.0), 1e-9)
    if eta_backup >= etas[straggler]:
        return None
    return BackupDecision(straggler=straggler, helper=helper, rows=rows,
                          eta_primary=etas[straggler],
                          eta_backup=eta_backup)
