"""`repro_torch.rl.fleet.run_fleet` against the JAX package's, and the
counterparts of tests/test_rl_fleet.py's fourteen tests.

The port's fleet gets JAX's initial weights (its `ac_init` patched to
return them, through the bridge) and JAX's Gumbel draws for every
rollout: actor `wid`'s n-th rollout draws
from fold_in(fold_in(PRNGKey(seed + 1), wid), n), which `jax_noise`
rebuilds after checking that argmax(logits + g) is
`jax.random.categorical`'s sample on the same key.  Replay sampling is
requester-seeded numpy in both packages.  Then the simulated clock and
everything it drives are compared exactly: transitions, env steps,
simulated time, learner steps, the published version, staleness and the
survivors, and the obs trace event for event.  Losses and final params
are held at rtol 1e-5 with atol 1e-6: a loss near zero cancels O(0.1)
terms (the killed run's step 8 is -1.2e-4, where the packages part by
1.7e-8, fp32 rounding of those terms).

Two cases spawn `python -m repro_torch.cluster.proc` children: their runs
must equal the simulated-clock run on the same trace bit for bit.
"""
import functools
import json
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.elastic import membership as JM  # noqa: E402
from repro.obs import recorder as jobs  # noqa: E402
from repro.rl import agents as JA  # noqa: E402
from repro.rl import fleet as JF  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.cluster import ProcTransport  # noqa: E402
from repro_torch.core.replay_shard import (  # noqa: E402
    ParamStore, ReplayShard, stratified_assign)
from repro_torch.elastic import membership as TM  # noqa: E402
from repro_torch.elastic.membership import (  # noqa: E402
    FailureTrace, TraceEvent)
from repro_torch.obs import recorder as obs  # noqa: E402
from repro_torch.rl import fleet as TF  # noqa: E402

# small but structurally honest: 4 actors, 2 replay shards, 1 learner
KW = dict(actors=4, replay_shards=2, steps=30, rollout_len=8, batch=8,
          capacity=256, pull_every=4, evaluate=False)
KILL_AT = 15
TOL = dict(rtol=1e-5, atol=1e-6)


def _trace(mod, events):
    return mod.FailureTrace([mod.TraceEvent(*e) for e in events])


@functools.lru_cache(maxsize=None)
def _draw_fn(seed, rollout_len):
    @jax.jit
    def draws(wid, n):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed + 1), wid), n)
        keys = jax.random.split(key, rollout_len)
        return jax.vmap(lambda k: jax.random.gumbel(
            jax.random.split(k)[0], (2,)))(keys)
    return draws


def jax_noise(seed=0, rollout_len=KW["rollout_len"]):
    """`run_fleet(noise=...)` giving JAX's fleet draws, after checking
    that they reproduce jax.random.categorical on actor 3's 5th rollout."""
    draws = _draw_fn(seed, rollout_len)
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed + 1), 3), 5)
    logits = jax.random.normal(jax.random.PRNGKey(99), (rollout_len, 2))
    want = jax.vmap(lambda k, lg: jax.random.categorical(
        jax.random.split(k)[0], lg))(jax.random.split(key, rollout_len),
                                     logits)
    assert np.array_equal(np.argmax(np.asarray(logits + draws(3, 5)), -1),
                          np.asarray(want))
    return lambda wid, n: np.asarray(draws(wid, n))


def jax_ac_init(generator, obs_dim, num_actions, hidden=64):
    """`ac_init` giving JAX's weights for the fleet's seed 0."""
    return params_from_numpy(jax.tree_util.tree_map(
        np.asarray, JA.ac_init(jax.random.PRNGKey(0), obs_dim, num_actions,
                               hidden=hidden)), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(events=(), **kw):
    return JF.run_fleet(trace=_trace(JM, events), **dict(KW, **kw))


def _port_run(events=(), transport=None, **kw):
    with mock.patch.object(TF, "ac_init", jax_ac_init):
        return TF.run_fleet(trace=_trace(TM, events) if transport is None
                            else None, transport=transport,
                            noise=jax_noise(), device="cpu",
                            **dict(KW, **kw))


def _leaves(params):
    return list(TF._flatten(params).values())


def assert_same_fleet(t, j):
    """The simulated clock's results exactly; losses, params at TOL."""
    assert [tuple(x) for x in t.transitions] == \
        [tuple(x) for x in j.transitions]
    for f in ("env_steps", "sim_time", "learner_steps", "final_version",
              "staleness_max", "staleness_sum", "staleness_samples",
              "final_actors", "final_shards"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_allclose(t.losses, j.losses, **TOL)
    jl = jax.tree_util.tree_leaves(j.final_params)
    assert len(jl) == len(_leaves(t.final_params))
    for a, b in zip(_leaves(t.final_params), jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# the port's fleet against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("events", [
    (), ((KILL_AT, "fail", 1, 1.0),), ((10, "slow", 0, 0.5),),
    ((KILL_AT, "fail", 4, 1.0),)],
    ids=["free", "actor_kill", "slow_actor", "shard_kill"])
def test_fleet_equals_jax(events):
    assert_same_fleet(_port_run(events), _jax_run(events))


def test_fleet_greedy_return_equals_jax():
    kw = dict(steps=12, evaluate=True)
    t, j = _port_run(**kw), _jax_run(**kw)
    assert_same_fleet(t, j)
    assert t.final_return == pytest.approx(j.final_return, rel=1e-6)


def test_launcher_trace_equals_jax_event_for_event(tmp_path, monkeypatch):
    """`launch.rl --trace-out` of both packages, the port's fed JAX's
    weights and draws: the same report and the same trace, event for
    event (names, lanes, simulated-clock times and args)."""
    from repro.launch.rl import rl as jrl
    from repro_torch.launch.rl import rl as trl
    noise = jax_noise()
    real = TF.run_fleet
    monkeypatch.setattr(TF, "ac_init", jax_ac_init)
    monkeypatch.setattr(TF, "run_fleet", lambda **kw: real(noise=noise,
                                                           **kw))
    (tmp_path / "kill.json").write_text(json.dumps(
        [{"step": KILL_AT, "kind": "fail", "worker": 1}]))
    args = ["--steps", "20", "--rollout-len", "8", "--batch", "8",
            "--failure-trace", str(tmp_path / "kill.json")]
    j = jrl(args + ["--trace-out", str(tmp_path / "j.json")])
    t = trl(args + ["--device", "cpu", "--trace-out",
                    str(tmp_path / "t.json")])
    jev = json.loads((tmp_path / "j.json").read_text())["traceEvents"]
    tev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert len(tev) == len(jev)
    for a, b in zip(tev, jev):
        assert a == b
    names = {e["name"] for e in tev}
    for want in ("actor.rollout", "replay.push", "replay.sample",
                 "replay.update", "learner.step", "learner.open",
                 "replay.open", "membership.death"):
        assert want in names, want
    np.testing.assert_allclose(t.pop("losses"), j.pop("losses"), **TOL)
    assert [tuple(x) for x in t.pop("transitions")] == \
        [tuple(x) for x in j.pop("transitions")]
    assert t["final_return"] == pytest.approx(j.pop("final_return"),
                                              rel=1e-6)
    t.pop("final_return")
    assert t == j


def test_proc_launcher_equals_sim_launcher(tmp_path):
    """`launch.rl --transport proc` with actor 1 killed at 15 returns the
    sim run's report float for float (its children are real processes)."""
    from repro_torch.launch.rl import rl
    (tmp_path / "kill.json").write_text(json.dumps(
        [{"step": KILL_AT, "kind": "fail", "worker": 1}]))
    args = ["--device", "cpu", "--steps", "20", "--rollout-len", "8",
            "--batch", "8", "--failure-trace", str(tmp_path / "kill.json")]
    sim = rl(args)
    proc = rl(args + ["--transport", "proc"])
    assert proc == sim
    assert sim["goodput"] == pytest.approx(
        (1 - (20 - KILL_AT) / (4 * 20)) * 4 * 8)


# ---------------------------------------------------------------------------
# tests/test_rl_fleet.py's claims, on the port's own draws and weights
# ---------------------------------------------------------------------------
def _run(**kw):
    return TF.run_fleet(device="cpu", **dict(KW, **kw))


def test_fleet_failure_free_goodput_is_deterministic():
    a = _run()
    b = _run()
    assert a.env_steps == KW["actors"] * KW["rollout_len"] * KW["steps"]
    assert a.goodput == KW["actors"] * KW["rollout_len"]
    assert a.losses == b.losses          # bit-identical replay
    assert a.learner_steps > 0
    assert a.final_actors == (0, 1, 2, 3)


def test_actor_kill_costs_only_lost_throughput():
    free = _run()
    fail = _run(trace=FailureTrace.single_failure(KILL_AT, 1))
    ratio = fail.goodput / free.goodput
    expect = 1.0 - (KW["steps"] - KILL_AT) / (KW["actors"] * KW["steps"])
    assert ratio == pytest.approx(expect)
    assert ratio >= 0.8
    assert 1 not in fail.final_actors
    assert fail.final_shards == (4, 5)
    assert fail.learner_steps == free.learner_steps


def test_slow_actor_acts_in_fewer_rounds():
    slow = _run(trace=FailureTrace([TraceEvent(10, "slow", 0, rate=0.5)]))
    free = _run()
    assert slow.env_steps < free.env_steps
    assert slow.final_actors == (0, 1, 2, 3)


def test_proc_fleet_learner_trajectory_bit_identical_to_sim():
    trace = FailureTrace.single_failure(KILL_AT, 1)
    sim = _run(trace=trace)
    proc = _run(transport=ProcTransport(inject=trace, device="cpu"))
    assert sim.transitions == proc.transitions
    assert sim.losses == proc.losses     # float-for-float
    assert sim.final_version == proc.final_version
    assert (sim.staleness_max, sim.staleness_sum) == \
        (proc.staleness_max, proc.staleness_sum)
    for a, b in zip(_leaves(sim.final_params), _leaves(proc.final_params)):
        assert torch.equal(a, b)
    assert sim.goodput / (KW["actors"] * KW["rollout_len"]) >= 0.8


def test_replay_shard_death_degrades_to_survivors():
    fail = _run(trace=FailureTrace.single_failure(KILL_AT, 4))
    assert fail.final_shards == (5,)
    assert fail.final_actors == (0, 1, 2, 3)
    assert fail.learner_steps > KILL_AT
    assert fail.goodput == KW["actors"] * KW["rollout_len"]


def test_learner_host_death_is_fatal():
    with pytest.raises(RuntimeError, match="learner host"):
        _run(trace=FailureTrace.single_failure(KILL_AT, 6))


def test_all_replay_shards_dead_is_fatal():
    trace = FailureTrace([TraceEvent(KILL_AT, "fail", 4),
                          TraceEvent(KILL_AT + 1, "fail", 5)])
    with pytest.raises(RuntimeError, match="replay shards"):
        _run(trace=trace)


def test_fleet_trace_reads_end_to_end():
    with obs.recording(obs.Recorder()) as rec:
        _run(trace=FailureTrace.single_failure(KILL_AT, 1))
    names = {e.name for e in rec.events}
    assert "actor.rollout" in names
    assert "replay.push" in names and "replay.sample" in names
    assert "replay.update" in names
    assert "learner.step" in names
    assert "learner.open" in names and "replay.open" in names
    assert "membership.death" in names
    assert rec.registry.get("rl.staleness") is not None
    expect = (1.0 - (KW["steps"] - KILL_AT) / (KW["actors"] * KW["steps"])
              ) * KW["actors"] * KW["rollout_len"]
    assert rec.registry["rl.goodput"] == pytest.approx(expect)
    hosts = {e.host for e in rec.events if e.name == "replay.push"}
    assert hosts <= {"replay4", "replay5"} and hosts


def test_fleet_staleness_bounded_by_pull_period():
    res = _run()
    assert 0 < res.staleness_max <= KW["pull_every"]


def _items(n, base=0.0):
    return {"x": np.arange(n, dtype=np.float32)[:, None] + base}


def test_replay_shard_never_samples_unwritten_slots():
    sh = ReplayShard(capacity=16, seed=3)
    sh.push(0, 0, _items(5), np.ones(5))
    for s in range(8):
        idx, items, w = sh.sample(64, seed=s)
        assert (idx < 5).all()
        assert (w > 0).all() and w.dtype == np.float32
        assert items["x"].shape == (64, 1)


def test_replay_shard_ring_wraps_and_reprioritizes():
    sh = ReplayShard(capacity=8, alpha=1.0, seed=0)
    sh.push(0, 0, _items(6), np.ones(6))
    sh.push(0, 1, _items(6, base=100.0), np.ones(6))
    assert sh.size == 8 and sh.cursor == 4
    assert sh.store["x"][4, 0] == 4.0
    assert sh.store["x"][0, 0] == 102.0
    v0 = sh.version
    sh.update(np.array([5]), np.array([1000.0]))
    assert sh.version == v0 + 1
    idx, _, _ = sh.sample(512, seed=1)
    counts = np.bincount(idx, minlength=8)
    assert counts[5] == counts.max()


def test_replay_shard_sampling_is_requester_seeded():
    a, b = ReplayShard(16, seed=7), ReplayShard(16, seed=7)
    for sh in (a, b):
        sh.push(0, 0, _items(10), np.linspace(0.1, 2.0, 10))
    ia, _, wa = a.sample(32, seed=5)
    ib, _, wb = b.sample(32, seed=5)
    assert np.array_equal(ia, ib) and np.array_equal(wa, wb)
    ic, _, _ = a.sample(32, seed=6)
    assert not np.array_equal(ia, ic)


def test_stratified_assign_deals_priority_spectrum_across_shards():
    prios = np.array([9.0, 1.0, 8.0, 2.0, 7.0, 3.0, 6.0, 4.0])
    assign = stratified_assign(prios, 2)
    top4 = np.argsort(-prios, kind="stable")[:4]
    assert sorted(assign[top4]) == [0, 0, 1, 1]
    assert sorted(np.bincount(assign)) == [4, 4]
    assert np.array_equal(assign, stratified_assign(prios, 2))


def test_param_store_versions_publishes():
    ps = ParamStore()
    assert ps.publish({"w": np.ones(3, np.float32)}) == 1
    assert ps.publish({"w": np.full(3, 2.0, np.float32)}) == 2
    version, entries = ps.pull()
    assert version == 2
    assert np.array_equal(entries["w"], np.full(3, 2.0, np.float32))
    entries["w"][0] = 99.0
    assert ps.pull()[1]["w"][0] == 2.0


def test_fleet_events_equal_jax_on_the_simulated_clock():
    """The recorded events of one killed run, compared as the cluster
    tests compare them, and the registry's gauges."""
    jrec, trec = jobs.Recorder(), obs.Recorder()
    with jobs.recording(jrec):
        JF.run_fleet(trace=_trace(JM, [(KILL_AT, "fail", 1, 1.0)]), **KW)
    with obs.recording(trec):
        _port_run([(KILL_AT, "fail", 1, 1.0)])

    def key(e):
        return (e.ts, e.ph, e.name, e.cat, e.host, e.args)
    assert [key(e) for e in trec.events] == [key(e) for e in jrec.events]
    assert trec.metrics() == pytest.approx(jrec.metrics())
