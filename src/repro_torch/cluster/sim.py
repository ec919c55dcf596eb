"""SimTransport: the trace-driven simulated clock as a Transport.

The port of the JAX package's ``cluster/sim.py``.

The original elastic/serving stack drove `Membership.advance(step)`
directly from a `FailureTrace`; this transport is that exact event
source behind the `Transport` interface — `poll(step)` returns
`trace.at(step)` and nothing else, so every pre-existing test,
benchmark, and goodput number is bit-identical under the coordinator
refactor (`Membership.apply(step, trace.at(step))` is by construction
the same computation `advance(step)` always did).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.elastic.membership import FailureTrace, TraceEvent

from repro_torch.cluster import roles
from repro_torch.cluster.transport import Transport
from repro_torch.obs import recorder as obs


class SimTransport(Transport):
    def __init__(self, trace: Optional[FailureTrace] = None):
        self.trace = trace or FailureTrace()
        # simulated hosts can still report commit steps (the multi-host
        # checkpoint rewind path is transport-agnostic): queued here by
        # `report_commit`, drained by the coordinator each poll
        self._commits: List = []
        # role states keyed (host, role name): the same registered
        # handlers the proc transport's children run behind a pipe,
        # executed in-process here (`cluster.roles`)
        self._roles: Dict[Tuple[int, str], Any] = {}

    def poll(self, step: int) -> List[TraceEvent]:
        return list(self.trace.at(step))

    def report_commit(self, host: int, step: int) -> None:
        """Simulated heartbeat piggyback for tests/drivers that model
        several hosts on one process."""
        self._commits.append((host, step))

    def commit_reports(self):
        out, self._commits = self._commits, []
        return out

    def host_devices(self) -> Dict[int, Any]:
        return {}

    # -- roles ---------------------------------------------------------
    # role ops are spans (not instants) for uniformity with
    # ProcTransport: under the simulated clock they have zero duration,
    # but the trace still shows each push/pull/sample on the role
    # host's lane in order.  Scalar payload fields become span args
    # (e.g. ps.push carries worker/clock), array payloads do not.
    def role_open(self, host: int, role: str, **kwargs: Any) -> None:
        spec = roles.get(role)
        if spec.open_verb is None:
            raise ValueError(f"role {role!r} has no open verb")
        with obs.get().span(f"{spec.name}.open", host=f"{spec.name}{host}",
                            cat=spec.name):
            roles.dispatch(self._role_states(host),
                           {"v": spec.open_verb, **kwargs})

    def role_call(self, host: int, verb: str, payload=None):
        hit = roles.lookup(verb)
        if hit is None:
            raise ValueError(f"unknown role verb {verb!r}")
        spec = hit[0]
        cmd = {"v": verb, **(payload or {})}
        span_args = {k: v for k, v in cmd.items()
                     if k != "v" and isinstance(v, (int, float, str))}
        with obs.get().span(verb.replace("_", ".", 1),
                            host=f"{spec.name}{host}", cat=spec.name,
                            **span_args):
            reply = roles.dispatch(self._role_states(host), cmd)
        if "err" in reply:
            raise KeyError(f"host {host}: {reply['err']}")
        return reply

    # -- the parameter-server verbs, in process -------------------------
    # The float32 wire codec is exact, so the in-process shard takes the
    # arrays themselves: the same shard state, values, versions and spans
    # as the round trip through `encode_entries` that `Transport` makes,
    # without pushing a model's worth of bytes through base64 at every
    # push and pull (a full-width LM's 3 GB of fp32 entries a call).
    def ps_open(self, ps_id: int, lr: float, entries: Dict[str, Any],
                momentum: float = 0.0) -> None:
        from repro_torch.core.param_server import PSShard
        with obs.get().span("ps.open", host=f"ps{ps_id}", cat="ps"):
            shard = PSShard(lr, momentum=momentum)
            shard.init(entries)
            self._roles[(ps_id, "ps")] = shard

    def _shard(self, ps_id: int):
        shard = self._roles.get((ps_id, "ps"))
        if shard is None:
            raise KeyError(f"host {ps_id}: role 'ps' not open on this host")
        return shard

    def ps_push(self, ps_id: int, worker: int, clock: int,
                grads: Dict[str, Any]) -> int:
        with obs.get().span("ps.push", host=f"ps{ps_id}", cat="ps",
                            worker=worker, clock=clock):
            return self._shard(ps_id).push(worker, clock, grads)

    def ps_pull(self, ps_id: int) -> Tuple[int, Dict[str, Any]]:
        with obs.get().span("ps.pull", host=f"ps{ps_id}", cat="ps"):
            return self._shard(ps_id).pull()

    def _role_states(self, host: int) -> Dict[str, Any]:
        """View of one host's role states as the name->state dict the
        shared `roles.dispatch` expects (state is still stored flat,
        keyed (host, role), so `_HostStates` is just an adapter)."""
        return _HostStates(self._roles, host)

    def captured_trace(self) -> FailureTrace:
        """A simulated run observes exactly its input trace."""
        return self.trace


class _HostStates(dict):
    """`roles.dispatch` speaks {role name: state} per host; SimTransport
    keeps one flat (host, role)-keyed dict for all hosts.  This adapter
    reads/writes through to the flat dict for a fixed host."""

    def __init__(self, flat: Dict[Tuple[int, str], Any], host: int):
        super().__init__()
        self._flat = flat
        self._host = host

    def get(self, role, default=None):
        return self._flat.get((self._host, role), default)

    def __setitem__(self, role, state) -> None:
        self._flat[(self._host, role)] = state
