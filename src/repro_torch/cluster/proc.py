"""ProcTransport: real multi-process workers behind the Transport ABC.

The port of the JAX package's ``cluster/proc.py``.  Each logical worker
is a real OS process (`python -m repro_torch.cluster.proc --wid N`)
running `_worker_entry`: a heartbeat loop that beats
line-delimited JSON onto its stdout pipe every few milliseconds and
services commands arriving on stdin — per-host heartbeat RPC, the
coordinator end of which is this transport.  `poll(step)` translates raw
observations into the same trace vocabulary the simulated clock uses:

  observation                                   emitted event
  -----------------------------------------     -------------
  worker process exited (preemption, crash)     fail
  heartbeats went silent > `silence_after` s    hang
  beats resumed after silence                   recover
  a freshly spawned process's first beat        join
  beat carries a changed self-reported rate     slow

Determinism bridge: pass `inject=FailureTrace` and the transport
*actuates* each trace event against the real processes at its wall step
(kills the process for `fail`, commands a heartbeat stop for `hang`,
spawns for `join`, ...) and emits the event only once the actuation is
acknowledged — so the same trace drives SimTransport and ProcTransport
to the identical membership transition log (`tests/test_cluster.py`
pins this).  Every emitted event — injected or organic — is also
recorded into `captured_trace()`, the replayable `FailureTrace` of what
actually happened: a live incident becomes a deterministic test case.

Host ids are dense ranks over the cards: worker id w maps to
`torch.device("cuda", w % torch.cuda.device_count())` (`host_devices`),
or to the CPU when the transport was built with `device="cpu"`; the
coordinator's `place_rows` moves resharded state rows there.

Workers are plain `subprocess` children rather than
`multiprocessing.Process` on purpose: mp's spawn/forkserver preparation
re-imports the driver's `__main__` in every child (seconds per worker
under a torch-importing driver script), while `-m
repro_torch.cluster.proc` starts in ~100ms because this module — and
everything it imports at module scope — is stdlib-only.  Keep it that
way: torch and the trace types are imported lazily inside
coordinator-side methods.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import queue as _queue
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.cluster import roles
from repro_torch.cluster.transport import RoleHostDied, Transport
from repro_torch.obs import recorder as obs
from repro_torch.obs.flight import FlightRecorder


# ---------------------------------------------------------------------------
# The worker process (stdlib-only; runs in the child)
# ---------------------------------------------------------------------------
def _worker_entry(argv: Optional[List[str]] = None) -> None:
    """Heartbeat + command loop of one worker process.

    Commands are one JSON object per line on stdin, verb under "v".
    Two verbs are loop control flow:
      {"v": "die"}            simulate a hard crash: exit, no ack
      {"v": "stop"}           clean shutdown (flushes the flight ring)
    Everything else routes through the role/verb registry
    (`cluster.roles.dispatch`) — the same handlers SimTransport runs
    in-process.  The built-in "member" role covers the base heartbeat
    duties (hang / recover / slow / commit / obs_pull); server roles
    (ps_* / replay_* / learner_*) come up on their open verb, which is
    when numpy gets imported — never at module scope, so plain workers
    stay stdlib-only.

    Every command except die/stop is acknowledged on stdout so an
    injecting transport can emit the event at a deterministic wall step
    (role acks double as RPC replies).  Array payloads ride as base64
    float32 (`param_server.encode_entries`) — an exact round-trip, so
    proc-transport role traffic is bit-identical to sim.
    All pre-hang beats precede the hang ack in pipe order (single
    writer), so after the ack the worker is provably silent."""
    import argparse
    import select

    ap = argparse.ArgumentParser()
    ap.add_argument("--wid", type=int, required=True)
    ap.add_argument("--heartbeat-every", type=float, default=0.005)
    ap.add_argument("--flight-dir", default=None)
    ap.add_argument("--roles", default=None,
                    help="comma-separated modules imported before the "
                         "loop so out-of-tree roles register in this "
                         "child (built-ins come with cluster.roles)")
    args = ap.parse_args(argv)
    if args.roles:
        import importlib
        for mod in args.roles.split(","):
            if mod:
                importlib.import_module(mod)

    out = sys.stdout
    seq = 0
    commands = _Lines()
    # flight recorder: a bounded ring of this worker's recent events,
    # flushed to disk on die/stop/SIGTERM so the post-mortem of a killed
    # host shows its last N events (timestamps relative to worker start)
    flight = FlightRecorder(args.wid)
    if args.flight_dir:
        flight.install_sigterm(args.flight_dir)
    # this host's role states; "member" (liveness knobs + flight ring)
    # exists from birth, server roles appear on their open verbs
    member = roles.MemberState(args.wid, flight)
    states: Dict[str, Any] = {"member": member}

    def _flush_flight(reason: str) -> None:
        if args.flight_dir:
            flight.flush(args.flight_dir, reason=reason)

    def emit(obj) -> None:
        out.write(json.dumps(obj) + "\n")
        out.flush()

    while True:
        ready, _, _ = select.select([0], [], [], args.heartbeat_every)
        if ready:
            chunk = os.read(0, 1 << 20)
            if not chunk:
                _flush_flight("eof")
                return                      # coordinator went away
            for line in commands.feed(chunk):
                if not line.strip():
                    continue
                cmd = json.loads(line)
                verb = cmd["v"]
                flight.note("cmd." + verb,
                            **{k: v for k, v in cmd.items()
                               if k != "v" and isinstance(v, (int, float,
                                                              str))})
                if verb == "die":
                    _flush_flight("die")
                    os._exit(1)             # no ack, no cleanup: a crash
                elif verb == "stop":
                    _flush_flight("stop")
                    return
                reply = roles.dispatch(states, cmd)
                emit({"t": "ack", "verb": verb, **reply})
        if not member.hung:
            seq += 1
            if seq == 1 or seq % 64 == 0:   # beat context, ring-friendly
                flight.note("beat", seq=seq, rate=member.rate)
            emit({"t": "beat", "seq": seq, "rate": member.rate,
                  "committed": member.committed})


class _Lines:
    """The complete lines of a byte stream fed in chunks.  Each chunk is
    searched for newlines once and each line joined once, so a line of n
    bytes (a parameter server's push or pull of a whole model) costs
    O(n); searching an accumulated buffer again at every chunk costs
    O(n^2), hours for a gigabyte in 64 KiB pipe reads."""

    def __init__(self):
        self._pending: List[bytes] = []

    def feed(self, chunk: bytes) -> List[bytes]:
        """The lines `chunk` completes; its tail waits for the next."""
        done = []
        while True:
            i = chunk.find(b"\n")
            if i < 0:
                if chunk:
                    self._pending.append(chunk)
                return done
            done.append(b"".join(self._pending) + chunk[:i])
            self._pending.clear()
            chunk = chunk[i + 1:]


def _reader(wid: int, stream, msg_q) -> None:
    """Per-worker pipe reader thread: parsed messages -> the shared
    message queue (EOF marker when the pipe closes)."""
    for line in stream:
        try:
            msg_q.put((wid, json.loads(line)))
        except (ValueError, UnicodeDecodeError):
            pass
    msg_q.put((wid, {"t": "eof"}))


@dataclasses.dataclass
class _Handle:
    """Coordinator-side view of one worker process."""
    wid: int
    proc: Any
    # time.monotonic() of the newest beat; None = no beat since spawn or
    # since an injected hang (a real sentinel, NOT 0.0 — the monotonic
    # epoch is boot time, so 0.0 would read as "recent" on a fresh VM)
    last_beat: Optional[float] = None
    silent: bool = False          # currently believed not-heartbeating
    dead: bool = False            # death already emitted
    joined_pending: bool = False  # spawned; join event not yet emitted
    rate_emitted: float = 1.0     # last rate the detector reported
    rate_seen: float = 1.0        # last rate carried by a beat
    committed: Optional[int] = None
    commit_dirty: bool = False
    spawned: float = 0.0          # driver monotonic at spawn (obs offset)


class ProcTransport(Transport):
    def __init__(self, *, inject=None, heartbeat_every: float = 0.05,
                 silence_after: float = 30.0, ack_timeout: float = 60.0,
                 flight_dir: Optional[str] = None,
                 role_modules: Optional[List[str]] = None,
                 device=None):
        """inject: optional FailureTrace to actuate against the real
        processes (None = purely observational).  heartbeat_every: the
        workers' beat period — only the real-time granularity of organic
        silence detection depends on it (injected events are ack'd
        synchronously), so it defaults coarse enough that N workers'
        beats never contend with the train loop for CPU.  silence_after:
        organic hang detection threshold in REAL seconds — deliberately
        lax by default so driver stalls (e.g. jit compiles between
        polls) are never misread as worker failures; tighten it (with a
        proportionally smaller heartbeat_every) to exercise the organic
        silence path.  flight_dir: directory worker children flush
        their flight-recorder rings to on die/stop/SIGTERM (None =
        flight recording off).  role_modules: extra modules each worker
        child imports at startup so out-of-tree `cluster.roles`
        registrations exist on both ends of the pipe (built-in roles
        need no listing).  device: where the hosts' state rows live
        (`host_devices`): the CUDA cards unless "cpu" is asked for;
        without a card and without a device this raises."""
        self.device = resolve_device(device)
        self._inject = inject
        self.flight_dir = flight_dir
        self.role_modules = list(role_modules or [])
        self.heartbeat_every = heartbeat_every
        self.silence_after = silence_after
        self.ack_timeout = ack_timeout
        self._msg_q: _queue.Queue = _queue.Queue()
        self._workers: Dict[int, _Handle] = {}
        self._captured: List[Any] = []
        self._commit_updates: List[Tuple[int, int]] = []
        self._next_id = 0
        self._closed = False

    # -- lifecycle -----------------------------------------------------
    def start(self, num_workers: int) -> None:
        """Idempotent: a transport started ahead of time (e.g. to keep
        worker spawn cost out of a benchmark's timed window) is left
        as-is when the coordinator starts it again."""
        if self._workers:
            return
        self._next_id = num_workers
        # spawn first, await after: the N interpreter startups overlap
        handles = [self._spawn(wid) for wid in range(num_workers)]
        for h in handles:
            self._await_beat(h)

    def _spawn(self, wid: int) -> _Handle:
        env = dict(os.environ)
        src = str(pathlib.Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        argv = [sys.executable, "-m", "repro_torch.cluster.proc",
                "--wid", str(wid),
                "--heartbeat-every", str(self.heartbeat_every)]
        if self.flight_dir:
            argv += ["--flight-dir", str(self.flight_dir)]
        if self.role_modules:
            argv += ["--roles", ",".join(self.role_modules)]
        p = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env, text=False)
        h = _Handle(wid, p)        # last_beat None until the first beat
        h.spawned = time.monotonic()
        threading.Thread(target=_reader, args=(wid, p.stdout, self._msg_q),
                         name=f"cluster-reader-{wid}", daemon=True).start()
        self._workers[wid] = h
        return h

    def spawn_worker(self, wid: int) -> None:
        """Scale-up entry point: bring up a fresh worker process.  The
        join event is emitted by the next `poll` (first-beat detection),
        like any other observation.  Worker ids are never reused — the
        membership machine fences stale state by id, so a rejoining host
        must come back under a fresh one."""
        if wid in self._workers:
            raise ValueError(f"worker id {wid} was already used "
                             f"(ids are never reused)")
        self._next_id = max(self._next_id, wid + 1)
        h = self._spawn(wid)
        self._await_beat(h)
        h.joined_pending = True

    def worker_pids(self) -> List[int]:
        """The process ids of every worker this transport started."""
        return [h.proc.pid for h in self._workers.values()]

    def kill_worker(self, wid: int) -> None:
        """Hard-kill a worker from outside (test/ops hook for organic
        failure observation — SIGKILL, no command round-trip)."""
        h = self._workers[wid]
        h.proc.kill()
        h.proc.wait(timeout=self.ack_timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for h in self._workers.values():
            if h.proc.poll() is None:
                self._send(h, {"v": "stop"})
        for h in self._workers.values():
            try:
                h.proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=2.0)
            if h.proc.stdin:
                try:
                    h.proc.stdin.close()
                except OSError:
                    pass

    # -- message plumbing ---------------------------------------------
    def _send(self, h: _Handle, obj: Dict) -> None:
        try:
            h.proc.stdin.write((json.dumps(obj) + "\n").encode())
            h.proc.stdin.flush()
        except (BrokenPipeError, OSError):
            pass                       # a dead worker can't take commands

    def _next_msg(self, deadline: float, what: str):
        timeout = deadline - time.monotonic()
        if timeout <= 0:
            raise RuntimeError(f"ProcTransport: timed out waiting for "
                               f"{what}")
        try:
            msg = self._msg_q.get(timeout=timeout)
        except _queue.Empty:
            raise RuntimeError(f"ProcTransport: timed out waiting for "
                               f"{what}") from None
        self._note(msg)
        return msg

    def _note(self, msg) -> None:
        wid, payload = msg
        h = self._workers.get(wid)
        if h is None or h.dead:
            return
        if payload.get("t") == "beat":
            h.last_beat = time.monotonic()
            h.rate_seen = float(payload["rate"])
            if payload["committed"] is not None and \
                    payload["committed"] != h.committed:
                h.committed = int(payload["committed"])
                h.commit_dirty = True

    def _drain(self) -> None:
        while True:
            try:
                self._note(self._msg_q.get_nowait())
            except _queue.Empty:
                return

    def _await_ack(self, wid: int, verb: str) -> bool:
        """True once the worker acks `verb`; False if its pipe hit EOF
        first (the worker died mid-command — a corpse never acks, so
        waiting out the timeout would stall the whole run)."""
        return self._await_reply(wid, verb) is not None

    def _await_reply(self, wid: int, verb: str) -> Optional[Dict]:
        """The ack payload for `verb` (RPC reply), or None if the
        worker's pipe hit EOF first (it died mid-command).  The wait is
        a span on the worker's lane — this is the per-command heartbeat
        RPC latency the trace shows."""
        deadline = time.monotonic() + self.ack_timeout
        with obs.get().span("rpc." + verb, host=wid, cat="proc"):
            while True:
                w, payload = self._next_msg(deadline,
                                            f"{verb} ack from worker {wid}")
                if w != wid:
                    continue
                t = payload.get("t")
                if t == "ack" and payload.get("verb") == verb:
                    return payload
                if t == "eof":
                    return None

    def _await_beat(self, h: _Handle) -> None:
        """Block until the worker's first beat (already-noted beats from
        interleaved waits count — last_beat leaves None exactly once)."""
        deadline = time.monotonic() + self.ack_timeout
        with obs.get().span("rpc.first_beat", host=h.wid, cat="proc"):
            while h.last_beat is None:
                self._next_msg(deadline, f"first beat from worker {h.wid}")

    # -- injection: actuate a trace event against real processes ------
    def _actuate(self, step: int, ev) -> List[Any]:
        from repro_torch.elastic.membership import TraceEvent

        h = self._workers.get(ev.worker)
        if ev.kind == "join":
            # mirror Membership.apply's id allocation exactly (ids are
            # never reused, dead or alive): the real process must live
            # under the id the membership machine will assign, or commit
            # reports and host->device placement for the joiner would key
            # on the wrong worker.  The ORIGINAL event is emitted either
            # way, so the transition log matches SimTransport's.
            wid = ev.worker
            if wid in self._workers:
                wid = self._next_id
            self._next_id = max(self._next_id, wid + 1)
            h = self._spawn(wid)
            self._await_beat(h)
            return [TraceEvent(step, "join", ev.worker)]
        if h is None or h.dead:
            return []          # events against unknown/dead workers: no-op
        if h.proc.poll() is not None:
            # the worker crashed organically since the last poll: a dead
            # process can't ack anything, so observe the death here and
            # let the injected event fall through as a no-op-on-a-corpse
            # (exactly what membership does with it)
            h.dead = True
            return [TraceEvent(step, "fail", ev.worker)]
        if ev.kind == "fail":
            self._send(h, {"v": "die"})
            try:
                h.proc.wait(timeout=self.ack_timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"worker {ev.worker} survived 'die'")
            h.dead = True
            return [TraceEvent(step, "fail", ev.worker)]
        if ev.kind == "hang":
            self._send(h, {"v": "hang"})
            if not self._await_ack(ev.worker, "hang"):
                return self._died_mid_command(step, h)
            # pre-hang beats precede the ack in pipe order, so the worker
            # is now provably silent: clear the beat clock so only a
            # GENUINE new beat (an injected recover) clears the silence
            h.silent = True
            h.last_beat = None
            return [TraceEvent(step, "hang", ev.worker)]
        if ev.kind == "recover":
            self._send(h, {"v": "recover"})
            if not self._await_ack(ev.worker, "recover"):
                return self._died_mid_command(step, h)
            h.silent = False
            h.rate_emitted = h.rate_seen = 1.0
            h.last_beat = time.monotonic()
            return [TraceEvent(step, "recover", ev.worker)]
        if ev.kind == "slow":
            self._send(h, {"v": "slow", "rate": ev.rate})
            if not self._await_ack(ev.worker, "slow"):
                return self._died_mid_command(step, h)
            # stale-rate beats all precede the ack (pipe FIFO); every beat
            # from here on provably carries the new rate
            h.rate_emitted = h.rate_seen = ev.rate
            return [TraceEvent(step, "slow", ev.worker, ev.rate)]
        raise ValueError(f"unknown event kind {ev.kind!r}")

    def _died_mid_command(self, step: int, h: _Handle) -> List[Any]:
        """The worker's pipe closed while we waited for an ack: observe
        the death (the injected command is a no-op against a corpse)."""
        from repro_torch.elastic.membership import TraceEvent

        h.proc.wait(timeout=self.ack_timeout)
        h.dead = True
        return [TraceEvent(step, "fail", h.wid)]

    # -- the detector --------------------------------------------------
    def poll(self, step: int) -> List[Any]:
        with obs.get().span("transport.poll", cat="proc", step=step):
            return self._poll(step)

    def _poll(self, step: int) -> List[Any]:
        from repro_torch.elastic.membership import TraceEvent

        events: List[Any] = []
        if self._inject is not None:
            for ev in self._inject.at(step):
                events.extend(self._actuate(step, ev))
        self._drain()
        now = time.monotonic()
        for wid in sorted(self._workers):
            h = self._workers[wid]
            if h.dead:
                continue
            if h.joined_pending:
                h.joined_pending = False
                events.append(TraceEvent(step, "join", wid))
                continue
            if h.proc.poll() is not None:         # organic crash/preemption
                h.dead = True
                events.append(TraceEvent(step, "fail", wid))
                continue
            if h.silent:
                if h.last_beat is not None and \
                        now - h.last_beat < self.silence_after:  # resumed
                    h.silent = False
                    # membership resets a recovered worker's rate to 1.0;
                    # mirror that belief so a beat still carrying the old
                    # slow rate re-emits a 'slow' event and re-syncs
                    h.rate_emitted = 1.0
                    events.append(TraceEvent(step, "recover", wid))
                continue
            if now - h.last_beat > self.silence_after:
                h.silent = True
                events.append(TraceEvent(step, "hang", wid))
                continue
            if h.rate_seen != h.rate_emitted:     # self-reported slowdown
                h.rate_emitted = h.rate_seen
                events.append(TraceEvent(step, "slow", wid, h.rate_seen))
        # stable within-step order (FailureTrace's own sort) so a captured
        # trace replays to the identical transition sequence under sim
        events.sort(key=lambda e: (e.worker, e.kind))
        for h in self._workers.values():
            if h.commit_dirty:
                h.commit_dirty = False
                self._commit_updates.append((h.wid, h.committed))
        self._captured.extend(events)
        return events

    # -- reporting -----------------------------------------------------
    def commit_reports(self) -> List[Tuple[int, int]]:
        out, self._commit_updates = self._commit_updates, []
        return out

    def set_commit(self, wid: int, step: int) -> None:
        """Tell a worker which checkpoint step its host has committed;
        the report rides back on its next heartbeat.  A worker that died
        mid-command is left for the next poll to observe."""
        h = self._workers[wid]
        self._send(h, {"v": "commit", "step": step})
        self._await_ack(wid, "commit")

    # -- roles ---------------------------------------------------------
    def _role_rpc(self, host: int, msg: Dict) -> Dict:
        """Command round-trip to a role host over its heartbeat pipe.
        `RoleHostDied` if the host's pipe hit EOF mid-RPC — the CLIENT
        decides whether that is fatal (PS/learner: the only copy of the
        state) or a degradation (replay: sample from survivors)."""
        h = self._workers[host]
        self._send(h, msg)
        reply = self._await_reply(host, msg["v"])
        if reply is None:
            raise RoleHostDied(host, msg["v"])
        if "err" in reply:
            raise KeyError(f"host {host}: {reply['err']}")
        # strip the ack envelope: clients see the handler's reply dict
        # verbatim, exactly as SimTransport returns it
        return {k: v for k, v in reply.items() if k not in ("t", "verb")}

    def role_open(self, host: int, role: str, **kwargs) -> None:
        spec = roles.get(role)
        if spec.open_verb is None:
            raise ValueError(f"role {role!r} has no open verb")
        self._role_rpc(host, {"v": spec.open_verb, **kwargs})

    def role_call(self, host: int, verb: str, payload=None):
        if roles.lookup(verb) is None:
            raise ValueError(f"unknown role verb {verb!r}")
        return self._role_rpc(host, {"v": verb, **(payload or {})})

    # -- observability -------------------------------------------------
    def host_events(self) -> List[Any]:
        """Pull the surviving workers' flight rings over the ack channel
        and lift them into recorder `Event`s.  Worker timestamps are
        relative to worker start; they are shifted by the driver-observed
        spawn time, so per-host lanes are exact in order and host-local
        spacing (cross-host alignment is approximate — see repro_torch.obs).
        Dead workers can't answer; their rings are on disk (flight_dir)."""
        from repro_torch.obs.recorder import Event

        out: List[Any] = []
        for wid in sorted(self._workers):
            h = self._workers[wid]
            if h.dead or h.proc.poll() is not None:
                continue
            reply = self._await_reply_send(h, {"v": "obs_pull"})
            if reply is None:
                continue
            for e in reply.get("events", ()):
                out.append(Event(ts=h.spawned + e["ts"], host=wid, ph="i",
                                 name=e["name"], cat="flight",
                                 args=e.get("args")))
        return out

    def _await_reply_send(self, h: _Handle, msg: Dict) -> Optional[Dict]:
        self._send(h, msg)
        return self._await_reply(h.wid, msg["v"])

    def host_devices(self) -> Dict[int, Any]:
        import torch  # coordinator-side only; workers never reach here
        if self.device.type == "cuda":
            n = torch.cuda.device_count()
            dev = lambda wid: torch.device("cuda", wid % n)
        else:
            dev = lambda wid: self.device
        return {wid: dev(wid)
                for wid, h in self._workers.items() if not h.dead}

    def captured_trace(self):
        from repro_torch.elastic.membership import FailureTrace
        return FailureTrace(self._captured)


if __name__ == "__main__":
    _worker_entry()
