"""Flight recorder: a bounded ring of recent events that a process
flushes to disk when it dies, so a post-mortem of a killed worker
includes the last N things it saw, not only the coordinator's outside
view.

The port's copy of the JAX package's ``obs/flight.py``, with the same
dump format.  A worker keeps a `FlightRecorder` (stdlib-only, timestamps
relative to worker start), `note()`s every command and beat, and flushes
on an injected "die", on "stop" and on SIGTERM.  SIGKILL cannot be
flushed by nature: an injected kill has the worker exit itself.

Dumps are written atomically (`.tmp` + rename) as
`flight_host<id>.json`.  `load_flight` lifts a dump back into recorder
`Event`s so it can be merged onto a trace timeline.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import time
from typing import Any, Deque, Dict, List, Optional

from repro_torch.obs.recorder import Event


class FlightRecorder:
    def __init__(self, host: Any, *, maxlen: int = 256,
                 clock: Optional[Any] = None):
        self.host = host
        self.ring: Deque[Dict[str, Any]] = collections.deque(maxlen=maxlen)
        self._clock = clock or time.monotonic
        self._t0 = self._clock()

    def note(self, name: str, **args: Any) -> None:
        e: Dict[str, Any] = {"ts": self._clock() - self._t0, "name": name}
        if args:
            e["args"] = args
        self.ring.append(e)

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self.ring)

    def flush(self, dirpath: str, *, reason: str = "") -> str:
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"flight_host{self.host}.json")
        payload = {"host": self.host, "reason": reason,
                   "events": list(self.ring)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def install_sigterm(self, dirpath: str) -> None:
        """Flush the ring before dying on SIGTERM (chains the default)."""
        def _handler(signum: int, frame: Any) -> None:
            try:
                self.flush(dirpath, reason="sigterm")
            finally:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
        signal.signal(signal.SIGTERM, _handler)


def load_flight(path: str, *, offset: float = 0.0) -> List[Event]:
    """Lift a flight dump into `Event`s (instants on the dump's host
    lane), shifted by `offset` onto the caller's timeline."""
    with open(path) as f:
        payload = json.load(f)
    host = payload.get("host")
    out = []
    for e in payload.get("events", []):
        out.append(Event(ts=e["ts"] + offset, host=host, ph="i",
                         name=e["name"], cat="flight",
                         args=e.get("args")))
    return out
