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
from typing import Any, Callable, Dict, List, Optional, Tuple


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

    def __reduce__(self):
        # rebuilt from (host, verb): `RankZeroTransport` ships it to the
        # other ranks of a mesh
        return type(self), (self.host, self.verb)


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

    def on_rank0(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` as the control plane's host computes it.  One process
        holds the whole control plane here; under a mesh's ranks
        (`RankZeroTransport`) every rank gets rank 0's result."""
        return fn()

    def close(self) -> None:
        """Tear down workers/queues (idempotent)."""

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "Transport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RankZeroTransport(Transport):
    """One control plane for the ranks of a mesh: rank 0's transport, each
    of its results broadcast to every rank.

    The JAX package runs a mesh from a single controller: one process
    holds the one transport, the one membership and the one parameter
    server, and needs no such wrapper.  The port runs a mesh as one
    process a rank, each running the same loop and calling every
    collective, so each rank builds its own `Coordinator`.  Were each to
    build its own transport, a `ProcTransport` a rank would start its own
    worker processes and parameter server and judge a hang by its own
    clock; memberships a heartbeat apart would send one rank to a restore
    while the others step, and the collectives would hang.  Here rank 0
    alone holds the real transport (`inner`; None on the other ranks)
    and every call runs there; its result, or its exception, is broadcast
    over `group`, a gloo group of every rank, so each rank applies the
    same events, commits and replies in the same order, and an error on
    rank 0 is raised on every rank instead of leaving the others in a
    collective.  Host objects never ride the card's NCCL stream.

    Every rank must make the same calls in the same order, as with any
    collective; `host_events` is rank 0's alone (its recorder merges the
    flight rings) and `worker_pids` is each rank's own."""

    def __init__(self, inner: Optional[Transport], group):
        import torch.distributed as dist
        self.inner = inner
        self.group = group
        self.rank = dist.get_rank()
        self._closed = False

    @classmethod
    def build(cls, make: Callable[[], Transport],
              group) -> "RankZeroTransport":
        """The wrapper around ``make()``, run on rank 0 only; an error in
        it is raised on every rank."""
        t = cls(None, group)
        t.inner = t._rank0(make, share=False)
        return t

    def _rank0(self, fn: Callable[[], Any], share: bool = True) -> Any:
        """fn() on rank 0, then its result (`share`) or its exception on
        every rank."""
        import torch.distributed as dist
        msg = [None]
        if self.rank == 0:
            try:
                out = fn()
                msg[0] = ("ok", out if share else None)
            except Exception as e:      # noqa: BLE001 - every rank raises
                msg[0] = ("err", _portable(e))
                dist.broadcast_object_list(msg, src=0, group=self.group)
                raise
        dist.broadcast_object_list(msg, src=0, group=self.group)
        kind, val = msg[0]
        if kind == "err":
            raise val
        return out if self.rank == 0 else val

    def on_rank0(self, fn: Callable[[], Any]) -> Any:
        return self._rank0(fn)

    def start(self, num_workers: int) -> None:
        self._rank0(lambda: self.inner.start(num_workers))

    def poll(self, step: int) -> List[Any]:
        return self._rank0(lambda: self.inner.poll(step))

    def commit_reports(self) -> List[Tuple[int, int]]:
        return self._rank0(lambda: self.inner.commit_reports())

    def host_devices(self) -> Dict[int, Any]:
        return self._rank0(lambda: self.inner.host_devices())

    def captured_trace(self):
        return self._rank0(lambda: self.inner.captured_trace())

    def role_open(self, host: int, role: str, **kwargs: Any) -> None:
        self._rank0(lambda: self.inner.role_open(host, role, **kwargs))

    def role_call(self, host: int, verb: str,
                  payload: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        return self._rank0(lambda: self.inner.role_call(host, verb, payload))

    # the ParamServer wrappers: only rank 0 encodes what it sends
    def ps_open(self, ps_id: int, lr: float, entries: Dict[str, Any],
                momentum: float = 0.0) -> None:
        self._rank0(lambda: self.inner.ps_open(ps_id, lr, entries,
                                               momentum=momentum))

    def ps_push(self, ps_id: int, worker: int, clock: int,
                grads: Dict[str, Any]) -> int:
        return self._rank0(lambda: self.inner.ps_push(ps_id, worker, clock,
                                                      grads))

    def ps_pull(self, ps_id: int) -> Tuple[int, Dict[str, Any]]:
        return self._rank0(lambda: self.inner.ps_pull(ps_id))

    def host_events(self) -> List[Any]:
        """Rank 0's workers' flight rings (no broadcast); none elsewhere."""
        pull = getattr(self.inner, "host_events", None)
        return pull() if pull is not None else []

    def worker_pids(self) -> List[int]:
        """The worker processes this rank's transport started (none off
        rank 0)."""
        pids = getattr(self.inner, "worker_pids", None)
        return pids() if pids is not None else []

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._rank0(lambda: self.inner is not None and self.inner.close())


def _portable(e: BaseException) -> BaseException:
    """`e` if it survives pickling, else a RuntimeError that names it."""
    import pickle
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:                  # noqa: BLE001
        return RuntimeError(f"on rank 0: {type(e).__name__}: {e}")
