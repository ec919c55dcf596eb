"""Elastic fault-tolerant training: membership, resharding, recovery.

The port of the JAX package's ``elastic`` package.  Replayable failure
traces drive a membership state machine, a resharding engine remaps
worker-stacked state W -> W', and per-mode recovery policies keep
training converging through worker death, scale-up and slowdown.  See
`repro_torch.elastic.driver` for the two run loops (simulation + real LM
training) and `repro_torch.elastic.modes` for the strategy layer:

  sync      all-reduce barrier; `SyncCheckpointRestore` rewind recovery
  local_sgd K local steps + average; `BoundedStalenessContinuation`
  easgd     elastic force around a surviving center; `EASGDCenterSurvival`
  async_ps  push-grads/pull-params against ParamServer hosts on the
            cluster transport: no barrier, death costs only throughput
  ssp       async_ps under a bounded staleness window enforced by the
            coordinator's death-aware clock gate

Exports are lazy (PEP 562): the proc transport's worker children import
`repro_torch.elastic.membership`, which must not pull torch in through
this package's namespace (the other modules import it).
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
    "BoundedStalenessContinuation": "repro_torch.elastic.recovery",
    "EASGDCenterSurvival": "repro_torch.elastic.recovery",
    "ServingDrainReadmit": "repro_torch.elastic.recovery",
    "SyncCheckpointRestore": "repro_torch.elastic.recovery",
    "ThroughputMonitor": "repro_torch.elastic.straggler",
    "replan_on_straggle": "repro_torch.elastic.straggler",
    "step_time": "repro_torch.elastic.straggler",
    "MODES": "repro_torch.elastic.modes",
    "TrainingMode": "repro_torch.elastic.modes",
    "make_mode": "repro_torch.elastic.modes",
    "ElasticProblem": "repro_torch.elastic.driver",
    "ElasticRunResult": "repro_torch.elastic.driver",
    "RecoveryRecord": "repro_torch.elastic.driver",
    "elastic_lm_loop": "repro_torch.elastic.driver",
    "run_elastic": "repro_torch.elastic.driver",
}

__all__ = list(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover - type checkers only
    from repro_torch.elastic.driver import (ElasticProblem,
                                            ElasticRunResult,
                                            RecoveryRecord, elastic_lm_loop,
                                            run_elastic)
    from repro_torch.elastic.membership import (FailureTrace, Membership,
                                                TraceEvent, Transition)
    from repro_torch.elastic.modes import MODES, TrainingMode, make_mode
    from repro_torch.elastic.recovery import (BoundedStalenessContinuation,
                                              EASGDCenterSurvival,
                                              ServingDrainReadmit,
                                              SyncCheckpointRestore)
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
