"""Port parity for the observability spine (`repro_torch.obs`) and the
engine's events.

Against the JAX package's `repro.obs`: the Chrome trace, its JSON bytes
and the written file for one event list; flight dumps (the worker ring
and the recorder's ring) byte for byte; the registry and bench reports.
The port's engine and the JAX engine serve one SMOKE stream on a tight
paged pool, with a preemption, a drain and a migrated admit, under
recorders on a counter clock: their event lists are equal in (ts, ph,
name, cat, host, args) and order.  With the default null recorder the
port's engine allocates no `Event`; recording leaves the streams as they
are; the launchers' `--trace-out` writes a trace also when the run
fails; `repro_torch.obs` imports without torch.
"""
import io
import itertools
import json
import logging
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.elastic import ServingDrainReadmit as JPolicy  # noqa: E402
from repro.obs import flight as jflight  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.elastic import ServingDrainReadmit  # noqa: E402
from repro_torch.launch import cli  # noqa: E402
from repro_torch.obs import flight as tflight  # noqa: E402
from repro_torch.obs import recorder as obs_recorder  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "qwen3-0.6b"
# 2 slots over 6 pages of 4 tokens: one max-length request fits, two
# growing ones do not, so the younger is preempted
KW = dict(num_slots=2, cache_len=24, page_size=4)
TIGHT = 6
_CACHE = {}


def _events(mod):
    """One event list in package `mod`: every phase, four lanes (the
    driver, a worker, a ps shard, the engine's "serve"), args of every
    JSON type, ties in ts broken by lane and name."""
    E = mod.Event
    return [E(2.5, "driver", "i", "go", "c", args={"k": [1, 2.5, "x"]}),
            E(2.0, 1, "X", "rpc", "proc", dur=0.25),
            E(3.0, "ps0", "X", "push", "ps", dur=1e-7),
            E(2.0, "serve", "i", "serve.admit", "serving",
              args={"rid": 3, "slot": 0}),
            E(2.0, 0, "C", "goodput", "gauge", args={"value": 1.5}),
            E(4.0, "driver", "X", "request", dur=0.5,
              args={"reason": "length", "ok": True, "none": None})]


def _arch():
    if ARCH not in _CACHE:
        jcfg = jax_get_config(ARCH, smoke=True)
        _CACHE[ARCH] = (jcfg, torch_get_config(ARCH, smoke=True),
                        *TP.params(jcfg))
    return _CACHE[ARCH]


def _stream(vocab, n=4, seed=13):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, size=int(rng.choice((5, 8)))),
             int(rng.choice((8, 12)))) for i in range(n)]


def _serve(make, Req, policy, reqs, ticks):
    """`ticks` ticks on a tight pool, drain, the rest on a second (ample)
    engine: {rid: stitched tokens}, engine A's stats."""
    a = make(num_pages=TIGHT)
    for i, p, g in reqs:
        a.submit(Req(rid=i, prompt=p.copy(), max_new_tokens=g))
    for _ in range(ticks):
        a.tick()
    out = {f.rid: f.tokens for f in a.finished}
    st = a.stats()
    b = make(num_pages=None)
    for f in b.run(policy.readmit(a.drain())):
        s = policy.stitch(f)
        out[s.rid] = s.tokens
    b.stats()
    return out, st


def _port_serve(ticks, reqs=None):
    _, tcfg, _, tp = _arch()
    reqs = reqs or _stream(tcfg.vocab_size)
    return _serve(lambda **k: ServeEngine(tp, tcfg, device="cpu",
                                          **dict(KW, **k)),
                  Request, ServingDrainReadmit(), reqs, ticks)


def _counter():
    return itertools.count().__next__


def _key(e):
    return (e.ts, e.ph, e.name, e.cat, e.host, e.args)


# ---------------------------------------------------------------------------
# export formats, byte for byte
# ---------------------------------------------------------------------------
def test_chrome_trace_and_trace_bytes_equal_jax(tmp_path):
    tevs, jevs = _events(tobs), _events(jobs)
    assert tobs.chrome_trace(tevs) == jobs.chrome_trace(jevs)
    assert tobs.trace_json(tevs) == jobs.trace_json(jevs)
    assert tobs.trace_json([]) == jobs.trace_json([])
    tobs.write_trace(tmp_path / "t" / "trace.json", tevs)
    jobs.write_trace(tmp_path / "j" / "trace.json", jevs)
    assert ((tmp_path / "t" / "trace.json").read_bytes()
            == (tmp_path / "j" / "trace.json").read_bytes())
    tids = {e["name"]: e["tid"] for e in tobs.chrome_trace(tevs)[
        "traceEvents"] if e["ph"] != "M"}
    assert tids == {"go": 0, "rpc": 2, "push": 1000, "serve.admit": 0,
                    "goodput": 1, "request": 0}


def test_flight_dumps_equal_jax(tmp_path):
    """The worker ring and the recorder's ring dump the same bytes, and
    a dump lifts into the same events."""
    dumps = {}
    for name, fl, mod in (("t", tflight, tobs), ("j", jflight, jobs)):
        f = fl.FlightRecorder(3, maxlen=4, clock=_counter())
        for i in range(6):                     # the ring keeps the last 4
            f.note(f"cmd.{i}", **({"step": i} if i % 2 else {}))
        assert len(f.snapshot()) == 4
        path = f.flush(str(tmp_path / name), reason="die")
        rec = mod.Recorder(host=3, clock=_counter(), ring=3)
        for e in _events(mod):
            rec._record(e)
        rec.flight_dump(str(tmp_path / name / "ring.json"), reason="stop")
        dumps[name] = (pathlib.Path(path).read_bytes(),
                       (tmp_path / name / "ring.json").read_bytes(),
                       [e.as_dict() for e in fl.load_flight(path,
                                                            offset=10.0)])
    assert pathlib.Path(path).name == "flight_host3.json"
    assert dumps["t"] == dumps["j"]
    assert json.loads(dumps["t"][0])["reason"] == "die"


def test_recorder_registry_and_bench_report_equal_jax(tmp_path):
    """Spans, instants, complete, counters (with timeline samples),
    gauges and handles give the same events and registry; a bench
    report writes the same file."""
    out = {}
    for name, mod in (("t", tobs), ("j", jobs)):
        rec = mod.Recorder(host="serve", clock=_counter())
        with rec.span("work", host=2, cat="x", step=1):
            rec.event("tick", k=1)
        rec.complete("req", 1.0, 2.0, rid=4)
        rec.count("n", 2, timeline=True)
        rec.counter("n").inc()
        rec.gauge("g", 0.5, timeline=True)
        rec.gauge_handle("h").set(7)
        null = mod.NullRecorder()
        assert null.span("a") is null.span("b", host=1) and not null.enabled
        report = {"workers": 4, "modes": {"sync": {"goodput": 8.0}}}
        # a bench name of this test's own: the registry is process-global,
        # and tests/test_obs.py fills `bench.unit` in the JAX package's
        # when an earlier file in the same process
        path = mod.bench_report("torch_obs_parity", report, tmp_path / name)
        out[name] = ([e.as_dict() for e in rec.events], rec.metrics(),
                     path.read_bytes(),
                     mod.registry_view("bench.torch_obs_parity"))
        assert json.loads(path.read_text()) == report
    assert out["t"] == out["j"]
    assert out["t"][1] == {"n": 3.0, "g": 0.5, "h": 7}


def test_recording_installs_and_restores():
    assert isinstance(tobs.get(), tobs.NullRecorder)
    rec = tobs.Recorder()
    with tobs.recording(rec) as got:
        assert got is rec and tobs.get() is rec
        prev = tobs.install(None)
        assert prev is rec and isinstance(tobs.get(), tobs.NullRecorder)
        tobs.install(rec)
    assert isinstance(tobs.get(), tobs.NullRecorder)


# ---------------------------------------------------------------------------
# the engine's events
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ticks", [4, 8])
def test_engine_events_equal_jax_engine(ticks):
    """A preemption on the tight pool, a drain of every request and at
    least one migrated admit: the port's events equal the JAX engine's in
    (ts, ph, name, cat, host, args) and order, on a counter clock."""
    jcfg, tcfg, jp, tp = _arch()
    reqs = _stream(jcfg.vocab_size)
    jrec = jobs.Recorder(clock=_counter())
    with jobs.recording(jrec):
        jout, jst = _serve(lambda **k: JEngine(jp, jcfg, **dict(KW, **k)),
                           JRequest, JPolicy(), reqs, ticks)
    trec = tobs.Recorder(clock=_counter())
    with tobs.recording(trec):
        tout, tst = _port_serve(ticks, reqs)
    assert tout == jout and tst["preemptions"] == jst["preemptions"] >= 1
    assert [_key(e) for e in trec.events] == [_key(e) for e in jrec.events]
    names = [e.name for e in trec.events]
    for want in ("serve.admit", "serve.admit_migrated", "serve.preempt",
                 "serve.drain", "serve.first_token", "request"):
        assert want in names, want
    assert {e.host for e in trec.events} == {"serve"}
    assert trec.metrics() == pytest.approx(jrec.metrics())
    assert set(trec.metrics()) == {"serving.slot_occupancy",
                                   "serving.pool_occupancy"}
    # the JAX engine's `serve.preempt` carries a numpy slot index, which
    # its own trace writer cannot serialize (ROADMAP, "Found in the
    # reference"); the port's is an int, and with the reference's args
    # cast to int the two traces are the same bytes
    with pytest.raises(TypeError, match="int64"):
        jobs.trace_json(jrec.events)
    for e in jrec.events:
        if e.args:
            e.args = {k: int(v) if isinstance(v, np.integer) else v
                      for k, v in e.args.items()}
    assert tobs.trace_json(trec.events) == jobs.trace_json(jrec.events)


def test_disabled_engine_allocates_zero_events(monkeypatch):
    """With the default NullRecorder the engine's paths — admit, decode,
    preemption, drain, migrated admit, finish, stats — construct no
    `Event` (the single allocation point, shimmed)."""
    assert isinstance(obs_recorder.get(), tobs.NullRecorder)
    made = []
    real = obs_recorder.Event

    def counting(*a, **k):
        made.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(obs_recorder, "Event", counting)
    _, st = _port_serve(4)
    assert st["preemptions"] >= 1
    assert made == []


def test_recording_leaves_the_streams_unchanged():
    off, st_off = _port_serve(8)
    with tobs.recording(tobs.Recorder()) as rec:
        on, st_on = _port_serve(8)
    assert on == off and st_on == st_off
    spans = [e for e in rec.events if e.name == "request"]
    assert sorted(e.args["rid"] for e in spans) == sorted(on)
    assert all(e.dur >= 0 for e in spans)


# ---------------------------------------------------------------------------
# launchers, logger, imports
# ---------------------------------------------------------------------------
class _Args:
    def __init__(self, trace_out):
        self.trace_out = trace_out


def test_run_traced_writes_the_trace_and_reraises(tmp_path):
    path = tmp_path / "fail.json"

    def boom():
        tobs.get().event("before", cat="t")
        raise ValueError("run failed")

    with pytest.raises(ValueError, match="run failed"):
        cli.run_traced(_Args(str(path)), boom)
    tr = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in tr if e["ph"] != "M"] == ["before"]
    assert isinstance(tobs.get(), tobs.NullRecorder)
    assert cli.run_traced(_Args(None), lambda: 5) == 5


def test_serve_launcher_trace_out(tmp_path, capsys):
    from repro_torch.launch.serve import serve
    path = tmp_path / "serve.json"
    out = serve(["--smoke", "--device", "cpu", "--continuous", "--paged",
                 "--page-size", "4", "--requests", "3", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4",
                 "--trace-out", str(path)])
    tr = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in tr if e["ph"] != "M"]
    assert names.count("request") == names.count("serve.first_token") == 3
    assert names.count("serve.admit") == 3
    assert len(out["finished"]) == 3
    assert "wrote trace" in capsys.readouterr().out


def test_log_quiet_by_default_and_gated_after_configure():
    from repro_torch.obs import log
    logger = log.get_logger()
    assert logger.name == "repro_torch"
    assert log.get_logger("serve").name == "repro_torch.serve"
    assert not logger.isEnabledFor(logging.INFO)
    buf = io.StringIO()
    try:
        log.configure("info", stream=buf)
        log.info("hello %d", 7)
        assert "hello 7" in buf.getvalue()
        n = len(logger.handlers)
        log.configure("warning")                   # idempotent attach
        assert len(logger.handlers) == n
        before = buf.getvalue()
        log.info("dropped")
        assert buf.getvalue() == before
    finally:
        logger.handlers = [h for h in logger.handlers
                           if not isinstance(h, logging.StreamHandler)
                           or isinstance(h, logging.NullHandler)]
        logger.setLevel(logging.WARNING)
        log._configured = False


def test_obs_imports_without_torch():
    """A worker process without torch can import the whole package."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'torch':\n"
        "            raise ImportError('torch is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from repro_torch import obs\n"
        "from repro_torch.obs import flight, log, registry, trace\n"
        "with obs.recording(obs.Recorder()) as rec:\n"
        "    with obs.get().span('s'):\n"
        "        pass\n"
        "assert len(rec.events) == 1 and 'torch' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(ROOT / "src")},
                       timeout=60)
    assert r.returncode == 0, r.stderr
