"""`repro_torch.serving.ServeFleet` and `ThroughputRouter` against the JAX
package's: counterparts of tests/test_elastic_serving.py's 24 tests.

Both packages serve the same request streams with the same JAX
`init_model` weights (qwen3-0.6b SMOKE, fp32) under the same traces.  Each
fleet case runs both fleets and holds the port's to the JAX one's
exactly: every finished request (rid, prompt length, tokens, finish
reason, admit and finish ticks) and the whole of `stats()` (wall ticks,
goodput, drains, preemptive drains, re-admits, routing, epoch, prefill
tokens, migration counters, pool occupancy, the hedge counters).  Then
the JAX test's own criterion is held on the port's fleet.  One case
records both fleets: their obs events are equal in (ts, ph, name, cat,
host, args) and order on the fleet's wall-tick clock.  One case runs the
port's fleet over `ProcTransport` worker processes.

The JAX fleets share one `ServeProgram` per (cache_len, page_size) here
(a fleet builds its own; the JAX package's own test shows that sharing
one changes no output), so the JAX side compiles each shape once.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro import elastic as JE  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro.elastic.straggler import ThroughputMonitor as JMonitor  # noqa: E402
from repro.serving import engine as JENG  # noqa: E402
from repro.serving import fleet as JFLEET  # noqa: E402
from repro_torch import elastic as TE  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.cluster import ProcTransport  # noqa: E402
from repro_torch.elastic.straggler import ThroughputMonitor  # noqa: E402
from repro_torch.serving.engine import DrainedRequest, MigratedKV  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

_JPROGS = {}


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_programs():
    """Every JAX fleet and engine of this module runs one ServeProgram per
    (cache_len, page_size): each shape compiles once."""
    real = JFLEET.ServeProgram

    def shared(cfg, *, cache_len, page_size=None):
        key = (cache_len, page_size)
        if key not in _JPROGS:
            _JPROGS[key] = real(cfg, cache_len=cache_len,
                                page_size=page_size)
        return _JPROGS[key]
    mp = pytest.MonkeyPatch()
    mp.setattr(JFLEET, "ServeProgram", shared)
    yield
    mp.undo()


_MODEL = {}


def _model():
    """(jax cfg, port cfg, jax params, port params), built once."""
    if not _MODEL:
        jcfg, tcfg = TP.configs(param_dtype="float32",
                                compute_dtype="float32")
        _MODEL["m"] = (jcfg, tcfg, *TP.params(jcfg))
    return _MODEL["m"]


def _stream(n, seed=0, plens=(6, 10), gens=(4, 8)):
    """tests/test_elastic_serving.py's stream, as (rid, prompt, budget)."""
    vocab = _model()[0].vocab_size
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, size=int(rng.choice(plens))),
             int(rng.choice(gens))) for i in range(n)]


def _reqs(mod, spec):
    return [mod.Request(rid=i, prompt=p.copy(), max_new_tokens=g)
            for i, p, g in spec]


def _trace(mod, events):
    return mod.FailureTrace(mod.TraceEvent(*e) for e in events)


def _fins(fins):
    return [(f.rid, f.prompt_len, list(f.tokens), f.finish_reason,
             int(f.admitted_tick), int(f.finished_tick)) for f in fins]


def _fleet(side, events=None, replicas=3, slots=2, cache_len=24, **kw):
    jcfg, tcfg, jp, tp = _model()
    if side == "jax":
        return JS.ServeFleet(jp, jcfg, replicas=replicas, num_slots=slots,
                             cache_len=cache_len,
                             trace=_trace(JE, events or []), **kw)
    return TS.ServeFleet(tp, tcfg, replicas=replicas, num_slots=slots,
                         cache_len=cache_len,
                         trace=_trace(TE, events or []), device="cpu", **kw)


def _both(spec, events=None, **kw):
    """Both packages' fleets over the stream: the port's finished
    requests and stats equal the JAX fleet's.  Returns the port's fleet
    and its finished requests."""
    jf = _fleet("jax", events, **kw)
    jfins = jf.run(_reqs(JS, spec))
    tf = _fleet("port", events, **kw)
    tfins = tf.run(_reqs(TS, spec))
    assert _fins(tfins) == _fins(jfins)
    assert tf.stats() == jf.stats()
    return tf, tfins


_FREE = {}


def _free(n=10, **kw):
    """The failure-free fleet's tokens by rid, both packages held equal."""
    key = (n, tuple(sorted(kw.items())))
    if key not in _FREE:
        _, fins = _both(_stream(n), **kw)
        _FREE[key] = {f.rid: f.tokens for f in fins}
    return _FREE[key]


def _same_tokens(fins, ref):
    assert {f.rid: f.tokens for f in fins} == ref


# ---------------------------------------------------------------------------
# router (no model)
# ---------------------------------------------------------------------------
def _routers():
    return JS.ThroughputRouter(), TS.ThroughputRouter()


def test_router_weights_away_from_stragglers():
    outs = []
    for mod, r in zip((JS, TS), _routers()):
        for _ in range(6):
            r.observe(0, 1.0)
            r.observe(1, 0.25)
            r.observe(2, 1.0)
        for i in range(8):
            r.submit(mod.Request(rid=i, prompt=np.zeros(4, np.int32),
                                 max_new_tokens=2))
        outs.append([(q.rid, w) for q, w in
                     r.route({0: 4, 1: 4, 2: 4}, {0: 0, 1: 0, 2: 0})])
        outs.append(dict(r.routed))
    assert outs[2:] == outs[:2]
    counts = {w: sum(1 for _, rw in outs[2] if rw == w) for w in (0, 1, 2)}
    assert counts[1] < counts[0] and counts[1] < counts[2]
    assert counts[1] <= 2


def test_router_fresh_joiner_assumed_nominal():
    picks = []
    for mod, r in zip((JS, TS), _routers()):
        r.observe(0, 0.25)
        r.submit(mod.Request(rid=0, prompt=np.zeros(4, np.int32),
                             max_new_tokens=2))
        picks.append((r.pick({0: 2, 7: 2}, {0: 0, 7: 0}),
                      [w for _, w in r.route({0: 2, 7: 2}, {0: 0, 7: 0})]))
    assert picks[1] == picks[0] == (7, [7])


def test_router_requeue_front_preserves_order():
    orders = []
    for mod, r in zip((JS, TS), _routers()):
        for i in (10, 11):
            r.submit(mod.Request(rid=i, prompt=np.zeros(2, np.int32),
                                 max_new_tokens=2))
        r.requeue_front([mod.Request(rid=i, prompt=np.zeros(2, np.int32),
                                     max_new_tokens=2) for i in (3, 5)])
        orders.append([q.rid for q in r.queue])
    assert orders[1] == orders[0] == [3, 5, 10, 11]


def test_monitor_first_observation_blends_from_nominal():
    for mon in (JMonitor(decay=0.5), ThroughputMonitor(decay=0.5)):
        mon.observe(0, 1, 4.0)
        assert mon.rates([0])[0] == pytest.approx(0.625)
        mon.observe(0, 1, 4.0)
        assert mon.rates([0])[0] == pytest.approx(0.4375)
        mon.set_rate(0, 0.25)
        assert mon.rates([0])[0] == 0.25


# ---------------------------------------------------------------------------
# drain + readmit policy
# ---------------------------------------------------------------------------
def _engines(**kw):
    jcfg, tcfg, jp, tp = _model()
    prog = JFLEET.ServeProgram(jcfg, cache_len=kw.get("cache_len", 24),
                               page_size=kw.get("page_size"))
    return (JS.ServeEngine(jp, jcfg, program=prog, **kw),
            TS.ServeEngine(tp, tcfg, device="cpu", **kw))


def _drained(ds):
    return [(d.request.rid, len(np.asarray(d.request.prompt)),
             d.request.max_new_tokens, list(d.emitted)) for d in ds]


def test_engine_drain_preserves_harvested_tokens():
    spec = _stream(3, seed=1, gens=(8,))
    out = []
    for mod, eng in zip((JS, TS), _engines(num_slots=2, cache_len=24)):
        for q in _reqs(mod, spec):
            eng.submit(q)
        for _ in range(4):
            eng.tick()
        out.append((_drained(eng.drain()), _fins(eng.finished)))
        assert eng.pool.num_active == 0 and eng.scheduler.pending == 0
        assert eng.free_capacity == 2
    assert out[1] == out[0]
    drained, fins = out[1]
    assert sorted(d[0] for d in drained) == \
        sorted(i for i, _, _ in spec if i not in [f[0] for f in fins])


def test_drain_readmit_builds_prefix_continuations():
    spec = _stream(2, seed=2, plens=(6,), gens=(12,))
    conts = []
    for mod, pmod, eng in zip((JS, TS), (JE, TE),
                              _engines(num_slots=2, cache_len=24)):
        for q in _reqs(mod, spec):
            eng.submit(q)
        for _ in range(3):
            eng.tick()
        drained = eng.drain()
        assert any(d.emitted for d in drained)
        policy = pmod.ServingDrainReadmit()
        cs = policy.readmit(drained)
        by_rid = {d.request.rid: d for d in drained}
        for c in cs:
            if not by_rid[c.rid].emitted:
                assert c is by_rid[c.rid].request   # verbatim re-admit
        conts.append([(c.rid, np.asarray(c.prompt).tolist(),
                       c.max_new_tokens) for c in cs])
    assert conts[1] == conts[0]


def test_stitch_reconstructs_full_output():
    outs = []
    for mod, pmod, drained_cls in ((JS, JE, JENG.DrainedRequest),
                                   (TS, TE, DrainedRequest)):
        orig = mod.Request(rid=4, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=6)
        policy = pmod.ServingDrainReadmit()
        [cont] = policy.readmit([drained_cls(orig, [7, 8])])
        fin = mod.FinishedRequest(rid=4, prompt_len=7, tokens=[9, 10, 11, 12],
                                  finish_reason="length", admitted_tick=1,
                                  finished_tick=9)
        out = policy.stitch(fin)
        assert not policy.originals and not policy.emitted
        outs.append((cont.max_new_tokens, _fins([out])))
    assert outs[1] == outs[0] == (4, [(4, 5, [7, 8, 9, 10, 11, 12],
                                       "length", 1, 9)])


# ---------------------------------------------------------------------------
# the fleet under traces
# ---------------------------------------------------------------------------
def test_fleet_failure_free_matches_single_engine():
    ref = _free(8)
    jeng, teng = _engines(num_slots=2, cache_len=24)
    single = {f.rid: f.tokens for f in teng.run(_reqs(TS, _stream(8)))}
    assert single == ref
    assert {f.rid: f.tokens for f in jeng.run(_reqs(JS, _stream(8)))} == ref


def test_fleet_replica_crash_drains_and_readmits():
    fleet, fins = _both(_stream(10), [(4, "fail", 1, 1.0)])
    st = fleet.stats()
    assert st["drains"] == 1 and st["readmitted"] >= 1
    assert st["finished"] == 10 and 1 not in fleet.replicas
    _same_tokens(fins, _free())


def test_fleet_crash_right_after_admission_reprefills():
    fleet, fins = _both(_stream(6), [(1, "fail", 0, 1.0)])
    assert fleet.stats()["finished"] == 6
    _same_tokens(fins, _free(6))


def test_fleet_hang_escalates_to_timeout_drain():
    fleet, fins = _both(_stream(10), [(3, "hang", 2, 1.0)])
    st = fleet.stats()
    assert st["drains"] == 1 and st["finished"] == 10
    dead = [w for w in fleet.membership.workers.values()
            if w.status == "dead"]
    assert len(dead) == 1 and dead[0].wid == 2
    _same_tokens(fins, _free())


@pytest.mark.parametrize("preemptive", [True, False])
def test_fleet_hang_recover_before_timeout(preemptive):
    free_wall = _both(_stream(10))[0].stats()["wall"]
    fleet, fins = _both(_stream(10), [(3, "hang", 2, 1.0),
                                      (4, "recover", 2, 1.0)],
                        preemptive_drain=preemptive)
    st = fleet.stats()
    assert st["drains"] == 0 and st["finished"] == 10
    _same_tokens(fins, _free())
    if preemptive:
        assert st["preemptive_drains"] == 1 and len(fleet.replicas) == 3
        assert st["wall"] <= free_wall + 2 + 2 * st["readmitted"]
    else:
        assert st["preemptive_drains"] == 0
        assert st["wall"] <= free_wall + 3


def test_fleet_join_absorbs_backlog():
    fleet, _ = _both(_stream(12), [(2, "join", 2, 1.0)], replicas=2)
    st = fleet.stats()
    assert st["finished"] == 12 and len(fleet.replicas) == 3
    assert st["routed"].get(2, 0) > 0
    assert fleet.replicas[2].engine.program is fleet.program


def test_fleet_slow_replica_gets_less_work():
    fleet, _ = _both(_stream(16, gens=(8,)), [(1, "slow", 0, 0.2)])
    routed = fleet.stats()["routed"]
    assert routed.get(0, 0) < routed[1] and routed.get(0, 0) < routed[2]


def _stepwise(side, events):
    """Drive one fleet a wall tick at a time, logging what the JAX tests
    watch: replica 2's status, its routed count, drains, re-admits,
    preemptive drains and its load."""
    fleet = _fleet(side, events)
    for q in _reqs(JS if side == "jax" else TS, _stream(10)):
        fleet.submit(q)
    log = []
    while not fleet.done:
        fleet.step()
        rep = fleet.replicas.get(2)
        log.append((fleet.membership.workers[2].status,
                    fleet.router.routed.get(2, 0), fleet.drains,
                    fleet.policy.readmitted, fleet.preemptive_drains,
                    None if rep is None else rep.load))
    return fleet, log


def test_drained_continuations_skip_suspect_replica():
    events = [(2, "hang", 2, 1.0), (3, "fail", 0, 1.0)]
    (jf, jlog), (tf, tlog) = _stepwise("jax", events), _stepwise("port",
                                                                 events)
    assert tlog == jlog and tf.stats() == jf.stats()
    suspect = [e for e in tlog if e[0] == "suspect"]
    assert len({e[1] for e in suspect}) == 1      # admissions frozen
    assert any(e[2] for e in suspect)             # a drain in the window
    assert tf.stats()["drains"] == 2 and set(tf.replicas) == {1}
    _same_tokens(tf.finished, _free())


def test_preemptive_drain_on_suspect():
    (jf, jlog), (tf, tlog) = (_stepwise("jax", [(3, "hang", 2, 1.0)]),
                              _stepwise("port", [(3, "hang", 2, 1.0)]))
    assert tlog == jlog and tf.stats() == jf.stats()
    first = next(e for e in tlog if e[0] == "suspect")
    assert first[4] == 1 and first[5] == 0 and first[3] >= 1
    st = tf.stats()
    assert st["drains"] == 1 and st["readmitted"] == first[3]
    _same_tokens(tf.finished, _free())


@pytest.mark.parametrize("side", ["jax", "port"])
def test_fleet_all_replicas_dead_raises(side):
    fleet = _fleet(side, [(1, "fail", 0, 1.0), (1, "fail", 1, 1.0),
                          (1, "fail", 2, 1.0)])
    with pytest.raises(RuntimeError, match="all replicas dead"):
        fleet.run(_reqs(JS if side == "jax" else TS, _stream(8)))


def test_fleet_rejects_oversized_request():
    for side, mod in (("jax", JS), ("port", TS)):
        fleet = _fleet(side, replicas=2, slots=1, cache_len=8)
        with pytest.raises(ValueError, match="exceeds cache_len"):
            fleet.submit(mod.Request(rid=0, prompt=np.zeros(6, np.int32),
                                     max_new_tokens=4))


def test_shared_program_across_engines():
    _, tcfg, _, tp = _model()
    prog = TS.ServeProgram(tcfg, cache_len=24)
    a = TS.ServeEngine(tp, tcfg, num_slots=2, cache_len=24, program=prog,
                       device="cpu")
    b = TS.ServeEngine(tp, tcfg, num_slots=2, cache_len=24, program=prog,
                       device="cpu")
    jeng, _ = _engines(num_slots=2, cache_len=24)
    ref = {f.rid: f.tokens for f in jeng.run(_reqs(JS, _stream(6, seed=5)))}
    for eng in (a, b):
        assert {f.rid: f.tokens
                for f in eng.run(_reqs(TS, _stream(6, seed=5)))} == ref
    assert a.program is b.program
    with pytest.raises(ValueError, match="cache_len"):
        TS.ServeEngine(tp, tcfg, num_slots=2, cache_len=16, program=prog,
                       device="cpu")
    c = TS.ServeEngine(tp, tcfg, num_slots=2, cache_len=24, chunk_cap=2,
                       device="cpu")
    assert {f.rid: f.tokens
            for f in c.run(_reqs(TS, _stream(6, seed=5)))} == ref
    assert c.stats()["decode_ticks"] >= a.stats()["decode_ticks"]


# ---------------------------------------------------------------------------
# paged KV migration on drain
# ---------------------------------------------------------------------------
def _drain_and_resume(side, spec, ticks, num_pages=None, migrate_kv=True):
    jcfg, tcfg, jp, tp = _model()
    kw = dict(num_slots=2, cache_len=24, page_size=4, num_pages=num_pages)
    if side == "jax":
        prog = JFLEET.ServeProgram(jcfg, cache_len=24, page_size=4)
        mk = lambda: JS.ServeEngine(jp, jcfg, program=prog, **kw)  # noqa
        mod, policy = JS, JE.ServingDrainReadmit()
    else:
        mk = lambda: TS.ServeEngine(tp, tcfg, device="cpu", **kw)  # noqa
        mod, policy = TS, TE.ServingDrainReadmit()
    a = mk()
    for q in _reqs(mod, spec):
        a.submit(q)
    for _ in range(ticks):
        if a.scheduler.done:
            break
        a.tick()
    drained = a.drain(migrate_kv=migrate_kv)
    conts = policy.readmit(drained)
    b = mk()
    out = {f.rid: f.tokens for f in a.finished}
    for f in b.run(conts):
        s = policy.stitch(f)
        out[s.rid] = s.tokens
    return out, b, drained


@pytest.mark.parametrize("num_pages,ticks", [(None, 3), (6, 5), (12, 9)])
def test_drain_migrate_readmit_equals_jax(num_pages, ticks):
    spec = _stream(4, seed=11, plens=(6, 9), gens=(10,))
    jout, jb, jd = _drain_and_resume("jax", spec, ticks, num_pages)
    tout, tb, td = _drain_and_resume("port", spec, ticks, num_pages)
    assert tout == jout and _drained(td) == _drained(jd)
    assert [d.kv.pos for d in td if d.kv is not None] == \
        [d.kv.pos for d in jd if d.kv is not None]
    for k in ("migrated_admits", "migrated_tokens_saved", "prefill_tokens",
              "decode_ticks", "preemptions"):
        assert tb.stats()[k] == jb.stats()[k], k
    _, ref_eng = _engines(num_slots=2, cache_len=24, page_size=4)
    assert tout == {f.rid: f.tokens for f in ref_eng.run(_reqs(TS, spec))}
    harvested = [d for d in td if d.kv is not None]
    assert all(isinstance(d.kv, MigratedKV) for d in harvested)
    if num_pages is None:
        assert harvested and tb.migrated_admits == len(harvested)
        pout, pb, _ = _drain_and_resume("port", spec, ticks,
                                        migrate_kv=False)
        assert pout == tout and pb.migrated_admits == 0
        assert tb.prefill_tokens < pb.prefill_tokens


def test_fleet_death_migrates_kv():
    ref = _free(10, page_size=4)
    on, fins = _both(_stream(10), [(4, "fail", 1, 1.0)], page_size=4)
    st = on.stats()
    assert st["finished"] == 10 and st["migrated_admits"] >= 1
    assert st["migrated_tokens_saved"] >= 1
    _same_tokens(fins, ref)
    off, fins_off = _both(_stream(10), [(4, "fail", 1, 1.0)], page_size=4,
                          migrate_kv=False)
    _same_tokens(fins_off, ref)
    assert off.stats()["migrated_admits"] == 0
    assert st["prefill_tokens"] < off.stats()["prefill_tokens"]
    es = on.engine_stats()
    assert es["prefill_tokens"] == st["prefill_tokens"]
    assert es["migrated_admits"] == st["migrated_admits"]


# ---------------------------------------------------------------------------
# hedged decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("recovers", [False, True])
def test_hedged_decode_equals_jax(recovers):
    events = [(3, "hang", 2, 1.0)] + ([(4, "recover", 2, 1.0)]
                                      if recovers else [])
    fleet, fins = _both(_stream(10), events, page_size=4,
                        hedged_decode=True)
    st = fleet.stats()
    assert st["finished"] == 10 and len({f.rid for f in fins}) == 10
    assert st["hedges_launched"] >= 1
    if recovers:
        assert (st["hedges_won_backup"] + st["hedges_won_primary"]
                == st["hedges_launched"])
    else:
        assert st["hedges_won_backup"] >= 1
    _same_tokens(fins, _free())


# ---------------------------------------------------------------------------
# obs on the wall-tick clock, and the proc transport
# ---------------------------------------------------------------------------
def _key(e):
    return (e.ts, e.ph, e.name, e.cat, e.host, e.args)


def test_fleet_events_equal_jax_on_the_wall_tick_clock():
    """A paged fleet whose replica dies and migrates: the port's events
    (the fleet's drain, the engines' admits, migrated admits, drains,
    first tokens and request spans, the coordinator's) equal the JAX
    fleet's, and so do the gauges of `stats()`."""
    events = [(4, "fail", 1, 1.0)]
    recs = []
    for side, o in (("jax", jobs), ("port", tobs)):
        rec = o.Recorder(clock=itertools.count().__next__)
        with o.recording(rec):
            fleet = _fleet(side, events, page_size=4)
            fleet.run(_reqs(JS if side == "jax" else TS, _stream(10)))
            fleet.stats()
        recs.append(rec)
    jrec, trec = recs
    assert [_key(e) for e in trec.events] == [_key(e) for e in jrec.events]
    names = {e.name for e in trec.events}
    for want in ("fleet.drain", "serve.admit", "serve.admit_migrated",
                 "serve.drain", "serve.first_token", "request"):
        assert want in names, want
    assert trec.metrics() == pytest.approx(jrec.metrics())


def test_proc_fleet_equals_jax_sim():
    """The port's fleet over worker processes (the trace injected against
    them) serves what the JAX fleet serves on the simulated clock."""
    jcfg, tcfg, jp, tp = _model()
    events = [(4, "fail", 1, 1.0)]
    jf = JS.ServeFleet(jp, jcfg, replicas=3, num_slots=2, cache_len=24,
                       page_size=4, trace=_trace(JE, events))
    jfins = jf.run(_reqs(JS, _stream(10)))
    tf = TS.ServeFleet(tp, tcfg, replicas=3, num_slots=2, cache_len=24,
                       page_size=4, device="cpu",
                       transport=ProcTransport(inject=_trace(TE, events),
                                               device="cpu"))
    try:
        tfins = tf.run(_reqs(TS, _stream(10)))
    finally:
        tf.close()
    assert _fins(tfins) == _fins(jfins)
    assert tf.stats() == jf.stats()


def test_fleet_and_launcher_refuse_without_cuda(monkeypatch):
    """The fleet and `serve --replicas` run on the card unless asked for
    the CPU; without a card they raise."""
    from repro_torch.launch.serve import serve
    _, tcfg, _, tp = _model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ServeFleet(tp, tcfg, replicas=2, num_slots=1, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(["--smoke", "--replicas", "2", "--requests", "1"])
    fleet = TS.ServeFleet(tp, tcfg, replicas=2, num_slots=1, cache_len=8,
                          device="cpu")
    assert fleet.device.type == "cpu"
