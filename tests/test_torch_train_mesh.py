"""The train launcher over a mesh: `--env dp_tp --data 2 --model 2` on the
CPU spawns 4 gloo ranks itself, rank 0 prints the summary, and the
losses equal the unsharded launcher's run of the same seed at rtol 1e-5
(the sharded reductions reassociate).

The mesh's state options, three more 2x2 worlds: a first run of 2 steps
that saves asynchronously at step 2 and records a trace, a blocking run
resumed from it for 2 more, and an unbroken blocking run of 4 steps
that saves at steps 2 and 4.  The resumed run's losses and step-4 files
are the unbroken run's bit for bit (gloo's reductions repeat run to
run), the asynchronous step-2 files the blocking run's byte for byte,
and rank 0's trace holds the 1x1 run's events (names, cats, args).

`--elastic --transport proc` on the 2x2 mesh (sync, worker 1 killed at
wall 3, a save every 2 steps): rank 0's transport runs the worker
processes, and the run's recoveries, transitions and final_alive are the
1x1 run's, its losses at rtol 1e-5."""
import collections
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

BASE = ["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32",
        "--log-every", "1", "--compress-grads"]
ARGS = BASE + ["--steps", "3"]
MESH = ["--env", "dp_tp", "--data", "2", "--model", "2"]


def test_train_launcher_on_a_2x2_mesh(capfd):
    from repro_torch.launch.train import train
    mesh = train(ARGS + MESH)
    out = capfd.readouterr().out
    assert "trained 3 steps on a 2x2 dp_tp mesh (4 ranks, cpu)" in out
    assert out.count("step ") == 3        # rank 0 logs, the others do not
    assert mesh["env"] == "dp_tp" and mesh["mesh"] == [2, 2]
    plain = train(ARGS)
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)
    assert mesh["entropy_floor"] == plain["entropy_floor"]


def _files(d: pathlib.Path) -> dict:
    return {p.relative_to(d): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _events(path: pathlib.Path) -> collections.Counter:
    """(name, cat, args) of a trace's events, counted; times left out."""
    evs = json.loads(path.read_text())["traceEvents"]
    return collections.Counter(
        (e["name"], e.get("cat"), json.dumps(e.get("args"), sort_keys=True))
        for e in evs if e["ph"] != "M")


@pytest.fixture(scope="module")
def state_runs(tmp_path_factory):
    from repro_torch.launch.train import train
    tmp = tmp_path_factory.mktemp("train_mesh")
    first = train(BASE + MESH + [
        "--steps", "2", "--ckpt-dir", str(tmp / "d"), "--ckpt-every", "2",
        "--async-ckpt", "--trace-out", str(tmp / "t.json")])
    resumed = train(BASE + MESH + ["--steps", "2", "--ckpt-dir",
                                   str(tmp / "d"), "--resume"])
    unbroken = train(BASE + MESH + ["--steps", "4", "--ckpt-dir",
                                    str(tmp / "u"), "--ckpt-every", "2"])
    train(BASE + ["--steps", "2", "--ckpt-dir", str(tmp / "d1"),
                  "--ckpt-every", "2", "--async-ckpt", "--trace-out",
                  str(tmp / "t1.json")])
    return tmp, first, resumed, unbroken


def test_mesh_resume_equals_unbroken_run(state_runs):
    tmp, first, resumed, unbroken = state_runs
    assert len(first["losses"]) == len(resumed["losses"]) == 2
    assert first["losses"] + resumed["losses"] == unbroken["losses"]
    d, u = _files(tmp / "d" / "step_00000004"), _files(tmp / "u" /
                                                       "step_00000004")
    assert len(d) > 1 and d == u


def test_mesh_async_save_equals_blocking(state_runs):
    """The first run's asynchronous step-2 save against the unbroken
    run's blocking one, and both against the 1x1 run's: the mesh writes
    the files of the state made whole."""
    tmp = state_runs[0]
    step2 = [_files(tmp / d / "step_00000002") for d in ("d", "u", "d1")]
    assert len(step2[0]) > 1 and step2[0] == step2[1]
    manifests = [json.loads(s[pathlib.Path("manifest.json")]) for s in step2]
    assert manifests[0] == manifests[2]


def test_mesh_trace_holds_the_1x1_events(state_runs):
    """Rank 0's trace: one train.step span a step and the ckpt.* spans
    of its asynchronous saves, the 1x1 run's events."""
    tmp = state_runs[0]
    mesh, plain = _events(tmp / "t.json"), _events(tmp / "t1.json")
    assert mesh == plain
    steps = sorted(json.loads(a)["step"] for (n, _, a), k in mesh.items()
                   for _ in range(k) if n == "train.step")
    assert steps == [0, 1]
    assert {"ckpt.snapshot", "ckpt.write", "ckpt.commit"} <= {
        n for n, _, _ in mesh}


def test_elastic_proc_launcher_on_a_2x2_mesh(tmp_path):
    from repro_torch.launch.train import train
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps([{"step": 3, "kind": "fail", "worker": 1}]))
    argv = ["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32",
            "--log-every", "100", "--steps", "4", "--elastic", "--workers",
            "2", "--transport", "proc", "--ckpt-every", "2",
            "--failure-trace", str(trace)]
    mesh = train(argv + MESH + ["--ckpt-dir", str(tmp_path / "m")])
    plain = train(argv + ["--ckpt-dir", str(tmp_path / "p")])
    recs = [(r.wall_step, r.worker, r.cause, r.lost_steps)
            for r in plain["recoveries"]]
    assert recs == [(3, 1, "fail", 1)]
    assert [tuple(r[:4]) for r in mesh["recoveries"]] == recs
    assert tuple(mesh["final_alive"]) == tuple(plain["final_alive"]) == (0,)
    assert [tuple(t) for t in mesh["transitions"]] == plain["transitions"]
    assert len(mesh["losses"]) == 4
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)
    assert sorted(p.name for p in (tmp_path / "m").glob("step_*")) == \
        sorted(p.name for p in (tmp_path / "p").glob("step_*"))
