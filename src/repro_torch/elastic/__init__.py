"""Elastic fault-tolerant training: membership, resharding, recovery.

The port of the JAX package's ``elastic`` package, so far (ROADMAP.md
queue 1):
  membership   FailureTrace, Membership, TraceEvent, Transition
  reshard      take_rows, reshard_stacked, assign_shards, plan_split,
               save_stacked, restore_stacked
  straggler    ThroughputMonitor, replan_on_straggle, step_time
  recovery     ServingDrainReadmit

Exports are lazy (PEP 562): the proc transport's worker children import
`repro_torch.elastic.membership`, which must not pull torch in through
this package's namespace (reshard, straggler and recovery import it).
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "FailureTrace": "repro_torch.elastic.membership",
    "Membership": "repro_torch.elastic.membership",
    "TraceEvent": "repro_torch.elastic.membership",
    "Transition": "repro_torch.elastic.membership",
    "assign_shards": "repro_torch.elastic.reshard",
    "plan_split": "repro_torch.elastic.reshard",
    "reshard_stacked": "repro_torch.elastic.reshard",
    "restore_stacked": "repro_torch.elastic.reshard",
    "save_stacked": "repro_torch.elastic.reshard",
    "take_rows": "repro_torch.elastic.reshard",
    "ServingDrainReadmit": "repro_torch.elastic.recovery",
    "ThroughputMonitor": "repro_torch.elastic.straggler",
    "replan_on_straggle": "repro_torch.elastic.straggler",
    "step_time": "repro_torch.elastic.straggler",
}

__all__ = list(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover - type checkers only
    from repro_torch.elastic.membership import (FailureTrace, Membership,
                                                TraceEvent, Transition)
    from repro_torch.elastic.recovery import ServingDrainReadmit
    from repro_torch.elastic.reshard import (assign_shards, plan_split,
                                             reshard_stacked,
                                             restore_stacked, save_stacked,
                                             take_rows)
    from repro_torch.elastic.straggler import (ThroughputMonitor,
                                               replan_on_straggle, step_time)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)
