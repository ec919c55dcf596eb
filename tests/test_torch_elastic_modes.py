"""`repro_torch.elastic.run_elastic` against the JAX package's, mode by
mode, on the traces of tests/test_training_modes.py,
tests/test_speculation.py's `run_elastic` cases and tests/test_elastic.py's
driver cases.

Both packages train the same least-squares problem on the same numpy
batches.  The simulated clock and everything it drives are compared
exactly: transitions, recoveries (wall, worker, cause, lost steps,
latency), sim_time, samples, goodput, splits_replanned, final_alive, the
checkpoint steps on disk and mode_stats (the PS clocks, versions, pushes,
blocked rounds and clock gaps, the speculation counters).  The fp32
values are held at rtol 1e-5.  Losses and final_loss get atol 2e-8: near
the optimum a loss is about 1e-4 and its residual `x @ w - y` cancels
O(1) terms, so the packages' summation orders differ there by up to
3.1e-5 relative; the largest error beyond rtol 1e-5 found over these
cases was 3.6e-9, and every loss above 1e-3 agreed within 9.4e-6.  The
stacked survivor rows and the PS parameters get atol 1e-5 times their
largest element: a parameter near zero carries its vector's fp32
rounding (the worst found, 7.1e-8 on an element of 2.9e-3 in a row of
scale 2.3).

Some JAX settings are cut in steps to fit the test-time budget (the JAX
rounds run eagerly, ~0.25 s each for the local modes); every trace event
still happens inside the cut run, and the cut is named at each case.
"""
import pathlib
import tempfile

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro import elastic as JE  # noqa: E402
from repro_torch import elastic as TE  # noqa: E402
from repro_torch.elastic import modes as TMODES  # noqa: E402

TOL = dict(rtol=1e-5, atol=2e-8)


def _close_rows(t, j):
    """fp32 parameters: rtol 1e-5, atol 1e-5 of the largest element."""
    t, j = _np(t), _np(j)
    np.testing.assert_allclose(t, j, rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


def _trace(mod, events):
    return mod.FailureTrace(mod.TraceEvent(*e) for e in events)


def _run(mod, events, ckpt=False, **kw):
    """run_elastic of one package on the trace; with `ckpt` in a fresh
    directory, whose complete steps come back with the result."""
    problem = (mod.ElasticProblem() if mod is JE
               else mod.ElasticProblem(device="cpu"))
    if not ckpt:
        return mod.run_elastic(problem, trace=_trace(mod, events), **kw), []
    with tempfile.TemporaryDirectory() as d:
        res = mod.run_elastic(problem, trace=_trace(mod, events),
                              ckpt_dir=d, **kw)
        steps = sorted(p.name for p in pathlib.Path(d).glob("step_*"))
    return res, steps


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same_run(t, j):
    """Everything the simulated clock drives equal; fp32 values at TOL."""
    assert [x.as_tuple() for x in t.transitions] == \
        [x.as_tuple() for x in j.transitions]
    assert [(r.wall_step, r.worker, r.cause, r.lost_steps, r.latency)
            for r in t.recoveries] == \
        [(r.wall_step, r.worker, r.cause, r.lost_steps, r.latency)
         for r in j.recoveries]
    assert t.sim_time == j.sim_time
    assert t.samples == j.samples
    assert t.goodput == j.goodput
    assert t.splits_replanned == j.splits_replanned
    assert t.final_alive == j.final_alive
    assert t.steps == j.steps and t.mode == j.mode
    assert len(t.losses) == len(j.losses)
    np.testing.assert_allclose(t.losses, j.losses, **TOL)
    np.testing.assert_allclose(t.final_loss, j.final_loss, **TOL)
    assert (t.stacked_params is None) == (j.stacked_params is None)
    if t.stacked_params is not None:
        _close_rows(t.stacked_params["w"], j.stacked_params["w"])
    ts, js = dict(t.mode_stats), dict(j.mode_stats)
    tp, jp = ts.pop("ps_params", None), js.pop("ps_params", None)
    assert ts == js
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert sorted(tp) == sorted(jp)
        for k in tp:
            _close_rows(tp[k], jp[k])


def _both(events, ckpt=False, **kw):
    (j, jsteps), (t, tsteps) = (_run(JE, events, ckpt, **kw),
                                _run(TE, events, ckpt, **kw))
    assert_same_run(t, j)
    assert tsteps == jsteps
    return t, j


# ---------------------------------------------------------------------------
# tests/test_training_modes.py
# ---------------------------------------------------------------------------
FAIL1 = [(13, "fail", 1, 1.0)]
CHURN = [(4, "fail", 1, 1.0), (8, "hang", 2, 1.0), (12, "join", 4, 1.0),
         (16, "slow", 3, 0.25)]
LEGACY = dict(workers=4, global_batch=32, ckpt_every=5, keep_last=3)


@pytest.mark.parametrize("tname", ["fail1", "churn"])
@pytest.mark.parametrize("mode", ["sync", "local_sgd", "easgd"])
def test_legacy_modes_equal_jax(mode, tname):
    """The legacy pins' runs (sync at their 30 steps; the local modes cut
    to 17 steps, past the last event).  On the single failure the local
    modes also hold tests/test_elastic.py's convergence criterion against
    the port's failure-free run (its sync case is
    `test_torch_elastic_driver.py`'s)."""
    steps = 30 if mode == "sync" else 17
    t, _ = _both(FAIL1 if tname == "fail1" else CHURN, ckpt=True,
                 mode=mode, steps=steps, **LEGACY)
    assert t.final_alive == ((0, 2, 3) if tname == "fail1" else (0, 3, 4))
    if mode == "sync":
        assert [r.lost_steps for r in t.recoveries] == \
            ([3] if tname == "fail1" else [4, 1])
    elif tname == "fail1":
        free, _ = _run(TE, [], ckpt=True, mode=mode, steps=steps, **LEGACY)
        assert [r.lost_steps for r in t.recoveries] == [0]
        assert t.final_loss < max(10 * free.final_loss, 5e-3)


PS_KW = dict(workers=8, steps=40, global_batch=56)


def test_async_ps_failure_free_and_death_equal_jax():
    free, _ = _both([], mode="async_ps", **PS_KW)
    assert free.goodput == 8.0
    assert free.mode_stats["clocks"] == {w: 40 for w in range(8)}
    assert free.mode_stats["versions"] == {8: 8 * 40}
    fail, _ = _both([(17, "fail", 1, 1.0)], mode="async_ps", **PS_KW)
    assert [x.lost_steps for x in fail.recoveries] == [0]
    assert fail.goodput < free.goodput and fail.final_loss < 0.01


@pytest.mark.parametrize("mod", [JE, TE], ids=["jax", "port"])
def test_ps_host_death_is_fatal(mod):
    with pytest.raises(RuntimeError, match="parameter server"):
        _run(mod, [(5, "fail", 4, 1.0)], mode="async_ps", workers=4,
             steps=20, global_batch=32)


def test_async_ps_two_shards_equal_jax():
    t, _ = _both([], mode="async_ps", num_ps=2, workers=4, steps=40,
                 global_batch=32)
    assert t.mode_stats["ps_ids"] == (4, 5)


def test_mode_registry_validation():
    assert TMODES.MODES == JE.MODES
    with pytest.raises(ValueError):
        TE.make_mode("bogus")
    with pytest.raises(ValueError):
        TE.make_mode("ssp", staleness=None)
    with pytest.raises(ValueError):
        TE.run_elastic(TE.ElasticProblem(device="cpu"), mode="bogus",
                       steps=2)
    with pytest.raises(ValueError, match="ckpt_dir"):
        TE.run_elastic(TE.ElasticProblem(device="cpu"), mode="sync",
                       steps=2)


@pytest.mark.parametrize("mode", ["ssp", "async_ps"])
def test_ssp_and_async_ps_under_a_straggler_equal_jax(mode):
    t, _ = _both([(4, "slow", 3, 0.25)], mode=mode, staleness=2,
                 workers=4, steps=14, global_batch=16)
    if mode == "ssp":
        assert t.mode_stats["blocked_rounds"] == 18
        assert t.mode_stats["clocks"] == {0: 8, 1: 8, 2: 8, 3: 6}
    else:
        assert t.mode_stats["blocked_rounds"] == 0
        assert t.mode_stats["max_clock_gap"] > 2


# the hypothesis property's corners: each staleness, straggler and kind
@pytest.mark.parametrize("s,w,onset,kind", [(1, 0, 1, 0), (2, 1, 4, 1),
                                            (3, 2, 8, 2), (1, 2, 3, 2)])
def test_ssp_gap_bound_runs_equal_jax(s, w, onset, kind):
    events = []
    if kind in (0, 2):
        events.append((onset, "slow", w, 0.25))
    if kind in (1, 2):
        events.append((onset + 3, "fail", (w + 1) % 3, 1.0))
    t, _ = _both(events, mode="ssp", staleness=s, workers=3, steps=12,
                 global_batch=12)
    assert t.mode_stats["max_clock_gap"] <= s


# ---------------------------------------------------------------------------
# tests/test_speculation.py
# ---------------------------------------------------------------------------
SPEC = dict(mode="sync", workers=4, steps=10, global_batch=24,
            ckpt_every=5, straggle_threshold=0.0)


@pytest.mark.parametrize("rate,slack,batch", [(0.1, 1.1, 16),
                                              (0.3, 1.5, 24),
                                              (0.45, 2.0, 32)])
def test_speculation_arbitration_runs_equal_jax(rate, slack, batch):
    """The order-invariance property's corners: with and without the
    knob, each package's run equals the other's, and the committed bytes
    do not depend on which copy won."""
    events = [(3, "slow", 2, rate)]
    kw = dict(SPEC, global_batch=batch)
    spec, _ = _both(events, ckpt=True, spec_slack=slack, **kw)
    base, _ = _run(TE, events, ckpt=True, **kw)
    assert spec.losses == base.losses
    assert spec.final_loss == base.final_loss


def test_sync_covered_death_equals_jax():
    kw = dict(SPEC, steps=16, global_batch=32, straggle_threshold=0.5)
    spec, _ = _both([(6, "hang", 2, 1.0)], ckpt=True, spec_slack=1.5, **kw)
    base, _ = _both([(6, "hang", 2, 1.0)], ckpt=True, **kw)
    assert [r.lost_steps for r in base.recoveries] != [0]
    assert [r.lost_steps for r in spec.recoveries] == [0]
    assert spec.mode_stats["speculation"]["covered_deaths"] == 1
    assert spec.goodput > base.goodput


def test_ssp_speculation_equals_jax():
    kw = dict(mode="ssp", staleness=1, workers=3, steps=14,
              global_batch=24)
    spec, _ = _both([(3, "slow", 1, 0.25)], spec_slack=1.5, **kw)
    base, _ = _both([(3, "slow", 1, 0.25)], **kw)
    assert spec.mode_stats["max_clock_gap"] <= 1
    assert (spec.mode_stats["blocked_rounds"]
            < base.mode_stats["blocked_rounds"])
    assert spec.mode_stats["speculation"]["wasted_rows"] > 0


def test_async_ps_ignores_the_knob_and_defaults_off():
    kw = dict(mode="async_ps", workers=3, steps=12, global_batch=24)
    spec, _ = _both([(3, "slow", 1, 0.25)], spec_slack=1.5, **kw)
    base, _ = _run(TE, [(3, "slow", 1, 0.25)], **kw)
    assert spec.losses == base.losses and spec.goodput == base.goodput
    assert "speculation" not in spec.mode_stats
    off, _ = _run(TE, [(3, "slow", 2, 0.3)], ckpt=True, **SPEC)
    assert off.mode_stats == {}


def test_problem_and_run_refuse_without_cuda(monkeypatch):
    """`ElasticProblem` and `run_elastic` run on the card unless asked for
    the CPU; without a card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.ElasticProblem()
    cpu = TE.ElasticProblem(device="cpu")
    assert cpu.init_params()["w"].device.type == "cpu"
    res = TE.run_elastic(cpu, mode="async_ps", workers=2, steps=2,
                         global_batch=4)
    assert res.mode_stats["clocks"] == {0: 2, 1: 2}
