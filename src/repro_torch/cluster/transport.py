"""Transport ABC: where the coordinator's membership events come from.

The port of the JAX package's ``cluster/transport.py``.

A transport is an **observation source**, not a policy: each `poll(step)`
returns the raw failure-detector events it observed since the previous
poll, already translated into the replayable trace vocabulary
(`elastic.membership.TraceEvent`: fail / hang / recover / join / slow).
The `cluster.Coordinator` feeds those events into the one shared
`Membership` state machine, so SUSPECT/DEAD escalation, event ordering,
and generation fencing behave identically no matter where the events
came from:

  * `sim.SimTransport`  — events come from a `FailureTrace` keyed by the
    simulated wall step.  Bit-exact determinism: replaying a trace gives
    the identical transition log every time.
  * `proc.ProcTransport` — events are observed from real OS processes
    (subprocess workers heartbeating line-JSON over pipes): a worker
    process exiting is a `fail`, heartbeat silence is a `hang`, resumed
    beats are a `recover`, a newly spawned process is a `join`, and a
    self-reported rate change is a `slow`.

Every transport also *captures* the events it emitted (`captured_trace`)
in the same `FailureTrace` JSON format, so a live ProcTransport incident
replays deterministically under SimTransport — one trace format drives
simulation, real processes, and the test suite.

This module is intentionally stdlib-only: `ProcTransport` worker
processes are spawned with this package on their import path, and they
must not pay (or depend on) the torch import.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Tuple


class RoleHostDied(RuntimeError):
    """A host died mid-role-RPC.  Whether that is fatal is the CLIENT's
    call: a parameter server or learner holds the only copy of its state
    (requesters must raise), while a replay shard's loss just degrades
    sampling to the surviving shards (requesters drop it and move on)."""

    def __init__(self, host: int, verb: str):
        super().__init__(f"role host {host} died during {verb!r} "
                         f"(its role state is gone)")
        self.host = host
        self.verb = verb


class Transport(abc.ABC):
    """Event source driven by the coordinator's wall clock.

    Lifecycle: `start(num_workers)` once, then `poll(step)` with strictly
    increasing wall steps, then `close()`.  `poll` must return the events
    to apply AT that step — the coordinator stamps nothing; transports
    own the mapping from observation time to wall step."""

    def start(self, num_workers: int) -> None:
        """Bring up the initial worker set (no-op for simulated time).
        Must be idempotent: callers may pre-start a transport before
        handing it to the coordinator."""

    @abc.abstractmethod
    def poll(self, step: int) -> List[Any]:
        """Detector events (TraceEvents) observed for this wall step."""

    def commit_reports(self) -> List[Tuple[int, int]]:
        """Drained (host id, last committed checkpoint step) reports that
        arrived since the previous poll (heartbeat piggyback).  Hosts may
        also report directly via `Coordinator.report_commit`."""
        return []

    def host_devices(self) -> Dict[int, Any]:
        """Worker id -> the `torch.device` its resharded state rows
        should be moved onto (empty: leave the rows where they are)."""
        return {}

    @abc.abstractmethod
    def captured_trace(self):
        """Everything this transport observed, as a replayable
        `FailureTrace` (the trace-capture path: live incident ->
        deterministic SimTransport test case)."""

    # -- roles ---------------------------------------------------------
    # A role host is just a member (the coordinator tracks its liveness
    # like any worker) that additionally serves registered verbs — a
    # parameter-server shard, a replay shard, a learner's published
    # params (`cluster.roles`).  Payloads/replies are line-JSON-safe
    # dicts with arrays pre-encoded via the exact float32 wire codec
    # (`core.param_server.encode_entries`), so the identical handler
    # bytes flow whether the role runs in-process (sim) or behind a
    # worker pipe (proc) — that is what keeps sim and proc bit-identical.
    def role_open(self, host: int, role: str, **kwargs: Any) -> None:
        """Activate a registered role on member `host`, building its
        server-side state from `kwargs` (the open command's payload)."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot host roles")

    def role_call(self, host: int, verb: str,
                  payload: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        """One role-verb round-trip to `host`; returns the handler's
        reply.  Raises `RoleHostDied` if the host died mid-call."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot host roles")

    # -- ParamServer role (compatibility wrappers over the registry) ---
    def ps_open(self, ps_id: int, lr: float, entries: Dict[str, Any],
                momentum: float = 0.0) -> None:
        """Activate the ParamServer role on member `ps_id`, seeding its
        shard with `entries` and the server-side SGD step size."""
        from repro_torch.core.param_server import encode_entries
        self.role_open(ps_id, "ps", lr=lr, momentum=momentum,
                       entries=encode_entries(entries))

    def ps_push(self, ps_id: int, worker: int, clock: int,
                grads: Dict[str, Any]) -> int:
        """Apply a worker's gradient push; returns the shard version.
        A PS death mid-push is fatal: the shard held the only copy."""
        from repro_torch.core.param_server import encode_entries
        return self.role_call(ps_id, "ps_push",
                              {"worker": worker, "clock": clock,
                               "grads": encode_entries(grads)})["version"]

    def ps_pull(self, ps_id: int) -> Tuple[int, Dict[str, Any]]:
        """Fetch (version, entries) from the shard."""
        from repro_torch.core.param_server import decode_entries
        reply = self.role_call(ps_id, "ps_pull")
        return reply["version"], decode_entries(reply["entries"])

    def close(self) -> None:
        """Tear down workers/queues (idempotent)."""

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "Transport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
