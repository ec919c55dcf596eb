"""`repro_torch.elastic.run_elastic` against the JAX package's on the
traces of tests/test_elastic.py's driver cases; and the port's
`ProcTransport` runs of tests/test_cluster.py's sim-vs-proc cases
against the simulated clock.

The comparison is `test_torch_elastic_modes.assert_same_run`: the
simulated clock's results exactly, fp32 values at rtol 1e-5 (losses
with atol 2e-8, parameters with atol 1e-5 of their largest element).
Each JAX test's own criterion (convergence, goodput, recovery causes) is
then held on the port's run.  The JAX runs are cut in steps to fit the
test-time budget, each past its trace's last event and the recovery it
causes (named at each case).  Two cases spawn `python -m
repro_torch.cluster.proc` children: their runs must equal the
simulated-clock run on the same trace bit for bit.
"""
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

from repro import elastic as JE  # noqa: E402
from repro_torch import elastic as TE  # noqa: E402
from repro_torch.cluster import ProcTransport  # noqa: E402

from test_torch_elastic_modes import _both, _run, _trace, assert_same_run  # noqa: E402

FAIL23 = [(23, "fail", 1, 1.0)]


def test_sync_convergence_after_midrun_failure_equals_jax():
    """The 60-step run cut to 27 steps (death at wall 23: step 20
    restored, 3 redone).  The local modes' case rides on
    `test_torch_elastic_modes.py`'s single-failure runs."""
    fail, _ = _both(FAIL23, ckpt=True, mode="sync", steps=27)
    free, _ = _run(TE, [], ckpt=True, mode="sync", steps=27)
    assert len(fail.final_alive) == 3
    assert fail.recoveries and fail.recoveries[0].cause == "fail"
    assert fail.final_loss < max(10 * free.final_loss, 5e-3)
    assert 0 < fail.recoveries[0].lost_steps <= 10
    assert fail.recoveries[0].latency > 0


def test_sync_goodput_under_single_failure_equals_jax():
    """8 workers, the 80-step run cut to 45 (death at wall 37)."""
    kw = dict(mode="sync", workers=8, steps=45, global_batch=56,
              ckpt_every=10)
    fail, _ = _both([(37, "fail", 1, 1.0)], ckpt=True, **kw)
    free, _ = _run(TE, [], ckpt=True, **kw)
    assert fail.goodput >= 0.8 * free.goodput


def test_timeout_death_and_scaleup_join_equal_jax():
    """local_sgd, the 50-step run cut to 32 (hang at 15, join at 30)."""
    t, _ = _both([(15, "hang", 0, 1.0), (30, "join", 4, 1.0)], ckpt=True,
                 mode="local_sgd", steps=32)
    assert t.recoveries[0].cause == "timeout"
    assert t.final_alive == (1, 2, 3, 4)


def test_sim_driver_replans_on_trace_slowdown_equals_jax():
    """sync, the 60-step run cut to 25 (slowdown at wall 10)."""
    t, _ = _both([(10, "slow", 1, 0.2)], ckpt=True, mode="sync", steps=25)
    assert t.splits_replanned > 0


def test_async_ckpt_trajectory_equals_jax_blocking(tmp_path):
    """The port's asynchronous saves give the JAX package's blocking run:
    the same losses, rewind targets, simulated time and checkpoint steps
    on disk (the 50-step run cut to 30)."""
    kw = dict(mode="sync", steps=30)
    jres = JE.run_elastic(JE.ElasticProblem(), trace=_trace(JE, FAIL23),
                          ckpt_dir=str(tmp_path / "j"), **kw)
    tres = TE.run_elastic(TE.ElasticProblem(device="cpu"),
                          trace=_trace(TE, FAIL23),
                          ckpt_dir=str(tmp_path / "t"), async_ckpt=True,
                          **kw)
    assert_same_run(tres, jres)
    assert (sorted(p.name for p in (tmp_path / "t").glob("step_*")) ==
            sorted(p.name for p in (tmp_path / "j").glob("step_*")))


def test_worker_death_with_async_save_in_flight_equals_jax(tmp_path,
                                                          monkeypatch):
    """The restore race: the death arrives while save(10) is still in the
    writer.  Recovery waits it out and rewinds to it, losing 0 steps, as
    the JAX package's blocking run does."""
    import repro_torch.elastic.recovery as rec

    real = rec.AsyncCheckpointer

    def slow_writer(*a, **kw):
        kw["failpoint"] = lambda name: (time.sleep(0.1)
                                        if name == "before_fsync" else None)
        return real(*a, **kw)

    monkeypatch.setattr(rec, "AsyncCheckpointer", slow_writer)
    kw = dict(mode="sync", steps=30, ckpt_every=10)
    tres = TE.run_elastic(TE.ElasticProblem(device="cpu"),
                          trace=_trace(TE, [(10, "fail", 1, 1.0)]),
                          ckpt_dir=str(tmp_path / "t"), async_ckpt=True,
                          **kw)
    assert [(r.wall_step, r.lost_steps) for r in tres.recoveries] == \
        [(10, 0)]
    jres = JE.run_elastic(JE.ElasticProblem(),
                          trace=_trace(JE, [(10, "fail", 1, 1.0)]),
                          ckpt_dir=str(tmp_path / "j"), **kw)
    assert_same_run(tres, jres)


# ---------------------------------------------------------------------------
# tests/test_cluster.py's sim-vs-proc runs: the port's worker processes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,events,kw", [
    ("local_sgd", [(5, "fail", 1, 1.0), (12, "slow", 0, 0.5)],
     dict(workers=3, steps=20, global_batch=24)),
    ("async_ps", [(5, "fail", 1, 1.0), (9, "slow", 2, 0.5)],
     dict(workers=2, steps=12, global_batch=16)),
], ids=["local_sgd", "async_ps"])
def test_proc_training_equals_sim(mode, events, kw):
    """The trace injected against real worker processes (the PS hosted
    in a third one for async_ps): the same transitions, simulated clock
    and mode stats as the simulated run, and the same losses and
    survivor rows (or PS parameters) bit for bit."""
    proc = TE.run_elastic(TE.ElasticProblem(device="cpu"), mode=mode,
                          transport=ProcTransport(
                              inject=_trace(TE, events), device="cpu"),
                          **kw)
    sim = TE.run_elastic(TE.ElasticProblem(device="cpu"), mode=mode,
                         trace=_trace(TE, events), **kw)
    assert_same_run(proc, sim)
    assert proc.losses == sim.losses and proc.final_loss == sim.final_loss
    if mode == "local_sgd":
        assert torch.equal(proc.stacked_params["w"], sim.stacked_params["w"])
    else:
        for k, v in sim.mode_stats["ps_params"].items():
            assert proc.mode_stats["ps_params"][k].tobytes() == v.tobytes()


def test_elastic_problem_draws_jax_batches():
    """The problem's data and every (worker, step) batch are the JAX
    package's, value for value."""
    j, t = JE.ElasticProblem(seed=3), TE.ElasticProblem(seed=3,
                                                        device="cpu")
    assert t.X.tobytes() == j.X.tobytes() and t.y.tobytes() == j.y.tobytes()
    for K in (0, 2):
        a = j.stack([0, 2, 5], 7, {0: 3, 2: 5, 5: 1}, K=K)
        b = t.stack([0, 2, 5], 7, {0: 3, 2: 5, 5: 1}, K=K)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    assert pathlib.Path(TE.__file__).parent.name == "elastic"
