"""Shared launcher plumbing for the ``repro_torch.launch`` entry points.

The port's counterpart of the JAX package's ``launch/cli.py``, so far its
observability half: the "record the run and write a Perfetto trace"
wrapper (``--trace-out``) that the train and serve launchers share, so
the flag's spelling and semantics cannot drift between them.

* `add_trace_args(ap)`   — the observability flag group
* `run_traced(args, fn)` — run under a Recorder, write trace.json

The cluster flags (``--transport``, ``--failure-trace``, ``--flight-dir``)
come with the cluster control plane (ROADMAP.md).
"""
from __future__ import annotations

import argparse
from typing import Any, Callable


def add_trace_args(ap: argparse.ArgumentParser):
    """Add the shared observability flags."""
    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--trace-out", default=None,
                   help="record the run and write a Chrome/Perfetto "
                        "trace.json here (open in ui.perfetto.dev); "
                        "see repro_torch.obs")
    return g


def run_traced(args, fn: Callable[[], Any]) -> Any:
    """Run ``fn()`` and, when ``--trace-out`` was given, record it and
    write the Chrome/Perfetto trace on the way out, also when ``fn``
    raises (a trace of a failed run is the one you want most); the
    exception then propagates."""
    if not getattr(args, "trace_out", None):
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
