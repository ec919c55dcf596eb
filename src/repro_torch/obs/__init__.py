"""repro_torch.obs — the observability spine: structured tracing, a
metrics registry and a flight recorder, shared by every layer.

The port's copy of the JAX package's ``obs`` package, with the same event
model, export formats and defaults, so that a trace of either package
reads the same.

Event model
-----------
Three phases, mirroring Chrome trace semantics (`recorder.Event`):

* span ("X")   — an interval with a duration: a train step, a request
  from admit to finish, a checkpoint snapshot or fsync.  Produced by
  `Recorder.span(name)` (context manager) or `Recorder.complete(...)`
  (retroactive).
* instant ("i") — a point event: a request admission, a first token, a
  preemption, a drain.
* counter ("C") — a sampled registry value on the timeline.

Alongside the timeline sits a flat metrics **registry** (dotted name ->
value) fed by `count()`/`gauge()` and the `Counter`/`Gauge` handles;
`repro_torch.obs.registry.bench_report` writes benchmark JSON as a view
over it.

`Recorder.clock` is pluggable: real runs use `time.monotonic` (the
default); a test may pass a counter to get a deterministic timeline.

Export surfaces
---------------
* `repro_torch.obs.trace.write_trace(path, rec.events)` — Chrome/Perfetto
  `trace.json`, one thread lane per host (driver tid 0, worker w tid
  w+1, parameter-server shard s tid 1000+s).  Load at
  https://ui.perfetto.dev.
* `repro_torch.obs.flight.FlightRecorder` — the bounded ring a worker
  keeps and flushes to `flight_host<id>.json` on die/stop/SIGTERM.
* `repro_torch.obs.registry.bench_report` — bench JSON from the registry.
* `repro_torch.obs.log` — the stdlib logger (`repro_torch.*`) library
  code uses instead of print; WARNING-quiet until `configure()`.

The default recorder is a `NullRecorder`: every producer call is a no-op
returning shared objects, so un-instrumented hot paths allocate nothing
(pinned by a counting-shim test).  Enable with
`obs.install(obs.Recorder())`, `with obs.recording(...)`, or
`--trace-out=PATH` on the launchers.  Everything in this package is
stdlib-only: worker subprocesses import it without torch.
"""
from repro_torch.obs.recorder import (Counter, Event, Gauge, NullRecorder,
                                      Recorder, Span, get, install,
                                      recording)
from repro_torch.obs.registry import bench_report, emit_metrics, registry_view
from repro_torch.obs.trace import chrome_trace, trace_json, write_trace
from repro_torch.obs.flight import FlightRecorder, load_flight
from repro_torch.obs import log

__all__ = [
    "Counter", "Event", "Gauge", "NullRecorder", "Recorder", "Span",
    "get", "install", "recording",
    "bench_report", "emit_metrics", "registry_view",
    "chrome_trace", "trace_json", "write_trace",
    "FlightRecorder", "load_flight", "log",
]
