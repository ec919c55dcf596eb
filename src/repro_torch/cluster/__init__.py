"""Unified cluster control plane: one coordinator for training + serving.

The port of the JAX package's ``cluster`` package: the same coordinator,
transports and role registry, recording on the port's ``obs`` spine.
The coordinator imports torch (through `elastic.straggler`'s batch
split); the transports and the role registry do not, so the proc
transport's worker children run without it.

Architecture (the survey's coordination layer, made a subsystem):

    FailureTrace ----\\                         /--> elastic.driver
                      v                        |    (run_elastic,
    Transport ABC -> Coordinator -- epochs ----+     elastic_lm_loop)
    | SimTransport    | Membership (1 machine) |
    | ProcTransport   | ThroughputMonitor      \\--> serving.fleet
         |            | commit-step aggregation      (ServeFleet)
         v            v
     captured     rewind_step() = min over hosts'
     FailureTrace AsyncCheckpointer.last_committed_step()

* **Coordinator** (`coordinator.py`) — the single membership authority:
  epoch/generation numbers, the one failure-detector state machine,
  straggler telemetry -> DBS split planning, and multi-host checkpoint
  consistency (recovery rewinds to the fleet-wide minimum committed
  step).  Training and serving both subscribe to its transitions, so
  fail / hang->timeout / join / slow semantics are defined exactly once.
* **Transport ABC** (`transport.py`) — where membership events come
  from.  `SimTransport` (`sim.py`) replays a `FailureTrace` on the
  simulated clock, preserving bit-exact determinism of every test and
  benchmark.  `ProcTransport` (`proc.py`) runs real worker processes
  (subprocess children speaking line-JSON heartbeat RPC over pipes),
  actuates injected traces against them, detects organic
  crashes/silence, and captures everything it observed back into the
  same `FailureTrace` JSON — so a live incident replays
  deterministically under sim.  Under a mesh's ranks
  `RankZeroTransport` (`transport.py`) wraps rank 0's transport and
  broadcasts its every result, or error, to the others over a gloo
  group, so each rank's coordinator sees one control plane.
* **Role registry** (`roles.py`) — hosts can serve stateful roles
  (parameter-server shard, replay shard, RL learner, ...) registered
  as verb->handler tables that speak the JSON-safe wire format on
  BOTH transports: sim dispatches in-process under role-named spans,
  proc dispatches inside worker children over the heartbeat pipe —
  identical handler, identical bytes, so role traffic is bit-identical
  by construction.  `Transport.role_open`/`role_call` is the client
  surface (`ps_*` are now thin compat wrappers); a host death during
  an RPC raises `RoleHostDied` and the CLIENT decides fatality (a PS
  or learner holds the only copy of its state; a replay shard
  degrades to survivors).  Out-of-tree roles reach proc children via
  `ProcTransport(role_modules=[...])`.

* **Speculative execution** (`coordinator.py` `Speculator` +
  `elastic.straggler.plan_backup`) — tail-latency mitigation beyond
  DBS re-splitting: when one shard's predicted barrier ETA (rows /
  monitored rate; SUSPECT workers are unbounded) blows a configurable
  slack over the fleet median, the driver launches a redundant copy on
  the least-loaded healthy host via the `backup` role and takes the
  first result.  Arbitration is decided deterministically by the
  driver (ETA compare) and made race-safe by the helper-side
  `BackupLedger` (a task resolves exactly once; late/duplicate
  commit/cancel are refused no-ops), so a discarded loser can never
  double-apply — both copies are the same bytes, which is why
  speculation never changes committed numerics, only the clock.
  Opt-in per mode via `run_elastic(spec_slack=...)`: sync covers
  straggler deaths at the barrier (no rewind), ssp spends gate-blocked
  fast workers on the straggler's step, async_ps has no barrier and
  ignores the knob.

The cross-transport contract (held against the JAX package by
`tests/test_torch_cluster.py`): the same trace driven through either
transport yields the identical membership transition log.

The consumers in the diagram are `elastic.driver` (with `run_elastic`)
and `serving.fleet`.

Imports here are lazy (PEP 562): `ProcTransport` worker processes
import `repro_torch.cluster.proc`, which must not pull torch in via this
package's namespace.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "Coordinator": "repro_torch.cluster.coordinator",
    "Transport": "repro_torch.cluster.transport",
    "RankZeroTransport": "repro_torch.cluster.transport",
    "SimTransport": "repro_torch.cluster.sim",
    "ProcTransport": "repro_torch.cluster.proc",
}

__all__ = list(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover - type checkers only
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.proc import ProcTransport
    from repro_torch.cluster.sim import SimTransport
    from repro_torch.cluster.transport import RankZeroTransport, Transport


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)
