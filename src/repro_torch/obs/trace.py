"""Chrome/Perfetto trace export.

The port's copy of the JAX package's ``obs/trace.py``: the same event
stream gives the same bytes.  The recorder's events map onto the Chrome
trace-event JSON format (load `trace.json` at https://ui.perfetto.dev or
chrome://tracing): one process, one thread lane per host — the
coordinator/driver (and any other named host, such as the engine's
"serve") on tid 0, worker hosts on tid host+1, parameter-server shards
on tid 1000+s, named lanes via "M" metadata events.  Span/instant/counter
phases pass through as "X"/"i"/"C".

Timestamps: recorder clocks are seconds; Chrome wants microseconds.  The
stream minimum is subtracted so traces start at t=0, which also makes the
output a pure function of the event stream.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Iterable, List, Union

from repro_torch.obs.recorder import Event


def _tid(host: Any) -> int:
    if isinstance(host, int):
        return host + 1
    if isinstance(host, str) and host.startswith("ps"):
        try:
            return 1000 + int(host[2:])
        except ValueError:
            return 1000
    return 0  # "driver", "coord", anything coordinator-side


def _lane_name(host: Any) -> str:
    if isinstance(host, int):
        return f"host {host}"
    return str(host)


def chrome_trace(events: Iterable[Event]) -> Dict[str, Any]:
    """Build the Chrome trace-event dict for an event stream."""
    evs = sorted(events, key=lambda e: (e.ts, _tid(e.host), e.name))
    t0 = evs[0].ts if evs else 0.0
    out: List[Dict[str, Any]] = []
    lanes: Dict[int, str] = {}
    for e in evs:
        tid = _tid(e.host)
        lanes.setdefault(tid, _lane_name(e.host))
        rec: Dict[str, Any] = {
            "name": e.name, "ph": e.ph, "pid": 1, "tid": tid,
            "ts": round((e.ts - t0) * 1e6, 3),
        }
        if e.cat:
            rec["cat"] = e.cat
        if e.ph == "X":
            rec["dur"] = round(e.dur * 1e6, 3)
        if e.ph == "i":
            rec["s"] = "t"  # thread-scoped instant
        if e.args:
            rec["args"] = e.args
        out.append(rec)
    # the process keeps the reference's name, so both packages' traces of
    # one event stream are the same bytes
    meta = [{"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "repro"}}]
    for tid in sorted(lanes):
        meta.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                     "args": {"name": lanes[tid]}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def trace_json(events: Iterable[Event]) -> str:
    return json.dumps(chrome_trace(events), indent=1, sort_keys=True)


def write_trace(path: Union[str, "pathlib.Path"],
                events: Iterable[Event]) -> str:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(trace_json(events))
    return str(p)
