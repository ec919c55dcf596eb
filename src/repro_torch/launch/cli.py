"""Shared launcher plumbing for the ``repro_torch.launch`` entry points.

The port's counterpart of the JAX package's ``launch/cli.py``.  The train
and serve launchers grow the same cluster surface — which transport backs
the control plane (``--transport``), where injected failures come from
(``--failure-trace``), where dying workers flush their flight rings
(``--flight-dir``) — plus the same "record the run and write a Perfetto
trace" wrapper (``--trace-out``).  They live here once, so a flag's
spelling, default and semantics cannot drift between entry points:

* `add_cluster_args(ap, ...)`   — the cluster flag group
* `add_trace_args(ap)`          — the observability flag group
* `load_failure_trace(args)`    — ``--failure-trace`` JSON -> FailureTrace
* `make_transport(args, trace)` — flags -> SimTransport / ProcTransport
  (rank 0's, in a RankZeroTransport, under a mesh's ranks)
* `run_traced(args, fn)`        — run under a Recorder, write trace.json

Every port import is lazy: parsing ``--help`` does not import torch.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Optional


def add_cluster_args(ap: argparse.ArgumentParser, *,
                     context: str = "the fleet",
                     workers: Optional[int] = None,
                     workers_help: Optional[str] = None):
    """Add the shared cluster control-plane flags.

    ``context`` names the launcher's fleet in help text (``"--elastic"``,
    ``"--replicas"``).  ``--workers`` is added only when a default is
    given: serve sizes its fleet with ``--replicas`` instead.
    """
    g = ap.add_argument_group(
        "cluster", "control plane shared by every launcher "
        "(repro_torch.cluster; see repro_torch.launch.cli)")
    g.add_argument("--transport", default="sim", choices=["sim", "proc"],
                   help=f"{context} control plane: 'sim' replays the "
                        "failure trace on the simulated clock; 'proc' "
                        "runs real worker processes with per-host "
                        "heartbeat RPC and injects the trace against "
                        "them (repro_torch.cluster.ProcTransport)")
    g.add_argument("--failure-trace", default=None,
                   help="JSON trace of fail/hang/recover/join/slow "
                        "events to inject "
                        "(repro_torch.elastic.membership.FailureTrace)")
    g.add_argument("--flight-dir", default=None,
                   help="--transport=proc: directory where dying/"
                        "stopped workers flush their flight-recorder "
                        "ring (flight_host<id>.json)")
    if workers is not None:
        g.add_argument("--workers", type=int, default=workers,
                       help=workers_help
                       or f"logical workers in {context}")
    return g


def add_trace_args(ap: argparse.ArgumentParser):
    """Add the shared observability flags."""
    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--trace-out", default=None,
                   help="record the run and write a Chrome/Perfetto "
                        "trace.json here (open in ui.perfetto.dev); "
                        "see repro_torch.obs")
    return g


def load_failure_trace(args, default=None):
    """``--failure-trace`` JSON -> FailureTrace (``default`` if the flag
    was absent or the launcher never added the group)."""
    path = getattr(args, "failure_trace", None)
    if not path:
        return default
    from repro_torch.elastic.membership import FailureTrace
    return FailureTrace.load(path)


def make_transport(args, trace=None, device=None):
    """Transport from the shared cluster flags: sim replays ``trace`` on
    the simulated clock, proc injects it against real worker processes
    (flight rings land in ``--flight-dir``) whose state rows live on
    ``device``, the launcher's (``ProcTransport``'s own rule: the card
    unless the CPU is asked for).  Under a process group of more than
    one rank (a mesh's ranks; every rank calls this at the same point)
    rank 0 alone builds it, inside a `RankZeroTransport` over a gloo
    group made for the control plane."""
    if _world() > 1:
        import torch.distributed as dist
        from repro_torch.cluster.transport import RankZeroTransport
        return RankZeroTransport.build(
            lambda: _transport(args, trace, device),
            dist.new_group(backend="gloo"))
    return _transport(args, trace, device)


def _transport(args, trace, device):
    if getattr(args, "transport", "sim") == "proc":
        from repro_torch.cluster.proc import ProcTransport
        return ProcTransport(inject=trace,
                             flight_dir=getattr(args, "flight_dir", None),
                             device=device)
    from repro_torch.cluster.sim import SimTransport
    from repro_torch.elastic.membership import FailureTrace
    return SimTransport(trace or FailureTrace())


def run_traced(args, fn: Callable[[], Any]) -> Any:
    """Run ``fn()`` and, when ``--trace-out`` was given, record it and
    write the Chrome/Perfetto trace on the way out, also when ``fn``
    raises (a trace of a failed run is the one you want most); the
    exception then propagates.  Under a process group (a mesh's ranks)
    rank 0 records and writes; the others run with no recorder."""
    if not getattr(args, "trace_out", None) or _rank() != 0:
        return fn()
    from repro_torch.obs import recorder as obs
    from repro_torch.obs.trace import write_trace
    with obs.recording(obs.Recorder()) as rec:
        try:
            return fn()
        finally:
            write_trace(args.trace_out, rec.events)
            print(f"wrote trace: {args.trace_out} "
                  f"({len(rec.events)} events)", flush=True)


def _rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    """The default process group's size, 1 without one."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1
