"""Structured event recorder: spans, instants, counters, gauges.

The port's copy of the JAX package's ``obs/recorder.py``, the same
classes, phases and registry.  One `Recorder` per process.  Producers
never format or write anything: they append `Event`s (the single
allocation point is `Recorder._record`, which the zero-overhead test
shims) and bump registry values.  Export is someone else's job
(`repro_torch.obs.trace` for Perfetto, `repro_torch.obs.flight` for crash
dumps, benchmark JSON as a registry view).

The clock is pluggable so that a simulated run can emit a deterministic
timeline; real launches keep `time.monotonic`.  Everything here is
stdlib-only: worker subprocesses import it and must not need torch.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional


@dataclasses.dataclass
class Event:
    """One timeline entry. `ph` follows the Chrome trace phase codes we
    use: "X" complete span (has `dur`), "i" instant, "C" counter sample."""

    ts: float
    host: Any            # "driver", worker id int, "ps0", "serve", ...
    ph: str
    name: str
    cat: str = ""
    dur: float = 0.0
    args: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"ts": self.ts, "host": self.host,
                             "ph": self.ph, "name": self.name}
        if self.cat:
            d["cat"] = self.cat
        if self.dur:
            d["dur"] = self.dur
        if self.args:
            d["args"] = self.args
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Event":
        return cls(ts=d["ts"], host=d["host"], ph=d["ph"], name=d["name"],
                   cat=d.get("cat", ""), dur=d.get("dur", 0.0),
                   args=d.get("args"))


class Span:
    """Context manager: measures [enter, exit) on the recorder clock and
    records one "X" event on exit (also when the body raises)."""

    __slots__ = ("_rec", "name", "cat", "host", "args", "_t0")

    def __init__(self, rec: "Recorder", name: str, cat: str, host: Any,
                 args: Optional[Dict[str, Any]]):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.host = host
        self.args = args

    def __enter__(self) -> "Span":
        self._t0 = self._rec.clock()
        return self

    def __exit__(self, *exc: Any) -> bool:
        rec = self._rec
        rec._record(Event(self._t0, self.host, "X", self.name, self.cat,
                          rec.clock() - self._t0, self.args))
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Counter:
    """Monotonic handle bound to a recorder registry entry."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str, rec: Optional["Recorder"] = None):
        self.name = name
        self._rec = rec

    def inc(self, delta: float = 1.0) -> None:
        (self._rec or get()).count(self.name, delta)

    @property
    def value(self) -> float:
        return (self._rec or get()).registry.get(self.name, 0.0)


class Gauge:
    """Last-value handle bound to a recorder registry entry."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str, rec: Optional["Recorder"] = None):
        self.name = name
        self._rec = rec

    def set(self, value: Any) -> None:
        (self._rec or get()).gauge(self.name, value)

    @property
    def value(self) -> Any:
        return (self._rec or get()).registry.get(self.name)


class Recorder:
    """Process-local event sink + metrics registry.

    `events` is the full timeline (unbounded; runs here are short),
    `ring` the bounded tail used for flight dumps, `registry` the flat
    name->value metrics map.  Appends are GIL-atomic; only counter
    read-modify-write takes the lock (the async-checkpoint writer thread
    records concurrently with the train loop).
    """

    enabled = True

    def __init__(self, *, host: Any = "driver",
                 clock: Optional[Callable[[], float]] = None,
                 ring: int = 256):
        self.host = host
        self.clock: Callable[[], float] = clock or time.monotonic
        self.events: List[Event] = []
        self.ring: Deque[Event] = collections.deque(maxlen=ring)
        self.registry: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # -- the single allocation/append point (shimmed by the overhead test)
    def _record(self, ev: Event) -> None:
        self.events.append(ev)
        self.ring.append(ev)

    def event(self, name: str, *, host: Any = None, cat: str = "",
              **args: Any) -> None:
        self._record(Event(self.clock(), self.host if host is None else host,
                           "i", name, cat, 0.0, args or None))

    def span(self, name: str, *, host: Any = None, cat: str = "",
             **args: Any) -> Span:
        return Span(self, name, cat, self.host if host is None else host,
                    args or None)

    def complete(self, name: str, ts: float, dur: float, *, host: Any = None,
                 cat: str = "", **args: Any) -> None:
        """Record a span retroactively (caller measured [ts, ts+dur))."""
        self._record(Event(ts, self.host if host is None else host, "X",
                           name, cat, dur, args or None))

    def count(self, name: str, delta: float = 1.0, *, host: Any = None,
              timeline: bool = False) -> None:
        with self._lock:
            v = self.registry.get(name, 0.0) + delta
            self.registry[name] = v
        if timeline:
            self._record(Event(self.clock(),
                               self.host if host is None else host,
                               "C", name, "counter", 0.0, {"value": v}))

    def gauge(self, name: str, value: Any, *, host: Any = None,
              timeline: bool = False) -> None:
        self.registry[name] = value
        if timeline:
            self._record(Event(self.clock(),
                               self.host if host is None else host,
                               "C", name, "gauge", 0.0, {"value": value}))

    def counter(self, name: str) -> Counter:
        return Counter(name, self)

    def gauge_handle(self, name: str) -> Gauge:
        return Gauge(name, self)

    def merge(self, events: List[Event]) -> None:
        """Adopt events recorded elsewhere (e.g. pulled worker rings)."""
        with self._lock:
            self.events.extend(events)

    def metrics(self) -> Dict[str, Any]:
        return dict(self.registry)

    def flight_dump(self, path: str, *, reason: str = "") -> str:
        """Write the bounded ring tail as a flight-recorder JSON dump."""
        payload = {"host": self.host, "reason": reason,
                   "events": [e.as_dict() for e in self.ring]}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path


class NullRecorder(Recorder):
    """Disabled sink: every producer call is a no-op that allocates
    nothing — `span` returns one shared null context manager, `event`/
    `count`/`gauge` return immediately.  This is the default, so
    un-instrumented runs pay only a method call per site."""

    enabled = False

    def _record(self, ev: Event) -> None:  # pragma: no cover - never called
        pass

    def event(self, name: str, *, host: Any = None, cat: str = "",
              **args: Any) -> None:
        pass

    def span(self, name: str, *, host: Any = None, cat: str = "",
             **args: Any) -> _NullSpan:  # type: ignore[override]
        return _NULL_SPAN

    def complete(self, name: str, ts: float, dur: float, *, host: Any = None,
                 cat: str = "", **args: Any) -> None:
        pass

    def count(self, name: str, delta: float = 1.0, *, host: Any = None,
              timeline: bool = False) -> None:
        pass

    def gauge(self, name: str, value: Any, *, host: Any = None,
              timeline: bool = False) -> None:
        pass


_DISABLED = NullRecorder()
_current: Recorder = _DISABLED


def get() -> Recorder:
    """The process-current recorder (a NullRecorder unless installed)."""
    return _current


def install(rec: Optional[Recorder]) -> Recorder:
    """Swap the process-current recorder; returns the previous one.
    Pass None to disable."""
    global _current
    prev = _current
    _current = rec if rec is not None else _DISABLED
    return prev


class recording:
    """Context manager: install `rec` for the duration, restore after.

        with obs.recording(obs.Recorder()) as rec:
            engine.run(requests)
        write_trace(path, rec.events)
    """

    def __init__(self, rec: Recorder):
        self.rec = rec
        self._prev: Optional[Recorder] = None

    def __enter__(self) -> Recorder:
        self._prev = install(self.rec)
        return self.rec

    def __exit__(self, *exc: Any) -> bool:
        install(self._prev)
        return False
