"""Port parity for asynchronous checkpoints (`repro_torch.checkpoint.
async_ckpt`) and the staging API of `checkpoint/ckpt.py` it stands on.

The port's `AsyncCheckpointer` writes the same files as the JAX
package's and as the port's blocking saver, byte for byte (fp32, bf16
stored as fp32, int32); a save returns before its commit and `wait` is
the barrier; one save is in flight at most; a writer error surfaces once;
a kill at every failure point restores the newest committed step, as the
reference's own tests hold its writer (`tests/test_async_ckpt.py`); the
host snapshot is a copy; retention keeps the rewind floor as JAX does;
the writer records its spans and counters.
"""
import pathlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.checkpoint import AsyncCheckpointer as JAsync  # noqa: E402
from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.checkpoint import (FAILPOINTS, AsyncCheckpointer,  # noqa: E402
                                    AsyncCheckpointError, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import ckpt as TCK  # noqa: E402

TIMEOUT = 10


def _tree(v):
    return {"w": torch.full((3, 2), float(v)),
            "b": torch.full((4,), float(v), dtype=torch.bfloat16),
            "nested": {"step": torch.tensor(int(v), dtype=torch.int32)}}


def _jtree(v):
    return {"w": jnp.full((3, 2), float(v), jnp.float32),
            "b": jnp.full((4,), float(v), jnp.bfloat16),
            "nested": {"step": jnp.asarray(int(v), jnp.int32)}}


def _steps(d):
    return sorted(int(p.name.split("_")[1])
                  for p in pathlib.Path(d).glob("step_*"))


def _files(d):
    d = pathlib.Path(d)
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _restore_w(d, step=None):
    tree, meta = restore_checkpoint(d, _tree(0), step=step)
    return float(tree["w"][0, 0]), meta


# ---------------------------------------------------------------------------
# the same bytes as the JAX package and as the blocking saver
# ---------------------------------------------------------------------------
def test_async_checkpoint_bytes_equal_jax_and_blocking(tmp_path):
    with AsyncCheckpointer(str(tmp_path / "ta")) as ck:
        ck.save(7, _tree(3), {"arch": "x"})
        ck.wait()
        assert ck.last_committed_step() == 7
    with JAsync(str(tmp_path / "ja")) as ck:
        ck.save(7, _jtree(3), {"arch": "x"})
        ck.wait()
    save_checkpoint(str(tmp_path / "tb"), 7, _tree(3), {"arch": "x"})
    ta = _files(tmp_path / "ta")
    assert sorted(ta) == ["step_00000007/b.npy", "step_00000007/manifest.json",
                          "step_00000007/nested__step.npy",
                          "step_00000007/w.npy"]
    assert ta == _files(tmp_path / "ja") == _files(tmp_path / "tb")
    # and each restores in the other package, bf16 cast back
    back, meta = restore_checkpoint(str(tmp_path / "ja"), _tree(0))
    assert meta == {"arch": "x"} and back["b"].dtype == torch.bfloat16
    assert all(torch.equal(back[k], _tree(3)[k]) for k in ("w", "b"))
    jback, _ = JCK.restore_checkpoint(str(tmp_path / "ta"),
                                      jax.eval_shape(lambda: _jtree(0)))
    np.testing.assert_array_equal(np.asarray(jback["w"]),
                                  np.asarray(_jtree(3)["w"]))


def test_host_snapshot_is_a_copy(tmp_path):
    """A save sees the tensors as they were when `save` returned, even
    when the train loop updates them in place while the writer works."""
    gate = threading.Event()
    ck = AsyncCheckpointer(str(tmp_path), failpoint=lambda name: (
        gate.wait(TIMEOUT) if name == "before_write" else None))
    tree = _tree(5)
    ck.save(5, tree)
    for leaf in (tree["w"], tree["b"], tree["nested"]["step"]):
        leaf.add_(1)                           # the next step, in place
    gate.set()
    ck.wait()
    ck.close()
    back, _ = restore_checkpoint(str(tmp_path), _tree(0))
    for k in ("w", "b"):
        assert torch.equal(back[k], _tree(5)[k])
    assert int(back["nested"]["step"]) == 5


# ---------------------------------------------------------------------------
# the non-blocking / barrier contract
# ---------------------------------------------------------------------------
def test_save_returns_before_commit_and_wait_barriers(tmp_path):
    gate = threading.Event()
    ck = AsyncCheckpointer(str(tmp_path), failpoint=lambda name: (
        gate.wait(TIMEOUT) if name == "before_write" else None))
    path = ck.save(5, _tree(5))
    assert path == str(tmp_path / "step_00000005")
    assert ck.last_committed_step() is None      # returned, not durable
    assert latest_step(str(tmp_path)) is None
    gate.set()
    ck.wait()
    assert ck.last_committed_step() == 5 == latest_step(str(tmp_path))
    ck.close()
    assert not ck._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(6, _tree(6))


def test_double_buffered_at_most_one_save_in_flight(tmp_path):
    gate = threading.Event()
    ck = AsyncCheckpointer(str(tmp_path), failpoint=lambda name: (
        gate.wait(TIMEOUT) if name == "before_write" else None))
    ck.save(1, _tree(1))                         # writer parked at the gate
    second_done = threading.Event()

    def second():
        ck.save(2, _tree(2))
        second_done.set()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not second_done.is_set()              # save 2 waits on save 1
    gate.set()
    t.join(TIMEOUT)
    assert not t.is_alive() and second_done.is_set()
    ck.wait()
    assert ck.last_committed_step() == 2 and _steps(tmp_path) == [1, 2]
    ck.close()


def test_writer_error_surfaces_once_then_saves_recover(tmp_path):
    calls = []

    def flaky(name):
        if name == "before_fsync" and not calls:
            calls.append(name)
            raise OSError("disk full (injected)")

    ck = AsyncCheckpointer(str(tmp_path), failpoint=flaky)
    ck.save(1, _tree(1))
    with pytest.raises(AsyncCheckpointError, match="disk full"):
        ck.wait()
    assert ck.last_committed_step() is None      # failed step NOT committed
    ck.save(2, _tree(2))                         # error consumed: usable
    ck.wait()
    assert ck.last_committed_step() == 2 and _steps(tmp_path) == [2]
    assert not list(tmp_path.glob(".tmp_step_*"))
    ck.close()


# ---------------------------------------------------------------------------
# crash consistency: a kill at every failure point restores the newest
# committed step, and the next save sweeps the debris
# ---------------------------------------------------------------------------
# the newest committed step after save(4) dies at each point, given the
# committed history [2, 3] (keep_last=2); "mid_replace" fires only on an
# overwrite and has its own test
_EXPECT_AFTER_KILL = {
    "before_write": 3,
    "before_fsync": 3,
    "after_fsync_before_rename": 3,
    "after_commit_before_gc": 4,
    "mid_gc": 4,
}


def test_failpoints_equal_jax_and_every_one_is_covered():
    from repro.checkpoint import FAILPOINTS as JFAILPOINTS
    assert FAILPOINTS == JFAILPOINTS
    assert set(_EXPECT_AFTER_KILL) | {"mid_replace"} == set(FAILPOINTS)


@pytest.mark.parametrize("point",
                         [p for p in FAILPOINTS if p in _EXPECT_AFTER_KILL])
def test_kill_at_failpoint_restores_newest_committed(tmp_path, point):
    d = str(tmp_path)
    with AsyncCheckpointer(d, keep_last=2) as ck:
        for s in (1, 2, 3):
            ck.save(s, _tree(s))
        ck.wait()
    assert _steps(tmp_path) == [2, 3]

    def die(name):
        if name == point:
            raise RuntimeError(f"injected kill at {name}")

    ck = AsyncCheckpointer(d, keep_last=2, failpoint=die)
    ck.save(4, _tree(4))
    with pytest.raises(AsyncCheckpointError, match=point):
        ck.wait()
    ck.close(wait=False)

    expect = _EXPECT_AFTER_KILL[point]
    assert latest_step(d) == expect
    assert _restore_w(d)[0] == float(expect)
    ck2 = AsyncCheckpointer(d, keep_last=2)
    assert ck2.last_committed_step() == expect   # resumes from the disk
    if expect == 3:                              # the kill left a tmp dir
        assert list(tmp_path.glob(".tmp_step_*"))
    ck2.save(5, _tree(5))
    ck2.wait()
    ck2.close()
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert _steps(tmp_path) == [expect, 5]
    assert _restore_w(d)[0] == 5.0


def test_kill_mid_replace_rescues_displaced_checkpoint(tmp_path):
    d = str(tmp_path)
    with AsyncCheckpointer(d) as ck:
        ck.save(3, _tree(3))
        ck.save(4, _tree(4))
        ck.wait()

    def die(name):
        if name == "mid_replace":
            raise RuntimeError("injected kill at mid_replace")

    ck = AsyncCheckpointer(d, failpoint=die)
    ck.save(4, _tree(44))                        # a redo of step 4
    with pytest.raises(AsyncCheckpointError, match="mid_replace"):
        ck.wait()
    ck.close(wait=False)
    assert (tmp_path / ".old_step_00000004").exists()
    assert _steps(tmp_path) == [3]
    with AsyncCheckpointer(d) as ck2:
        ck2.save(5, _tree(5))                    # its sweep puts 4 back
        ck2.wait()
        assert _steps(tmp_path) == [3, 4, 5]
        assert _restore_w(d, step=4)[0] == 4.0
        ck2.save(4, _tree(44))
        ck2.wait()
    assert _restore_w(d, step=4)[0] == 44.0
    assert not list(tmp_path.glob(".old_step_*"))
    assert not list(tmp_path.glob(".tmp_step_*"))


# ---------------------------------------------------------------------------
# retention with the rewind floor, and the obs spans and counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("floor", [None, 2, 4, 0])
def test_gc_keeps_the_rewind_floor_as_jax(tmp_path, floor):
    removed = {}
    for name, save, gc, tree in (
            ("t", save_checkpoint, TCK.gc_checkpoints, {"w": torch.ones(2)}),
            ("j", JCK.save_checkpoint, JCK.gc_checkpoints,
             {"w": jnp.ones(2)})):
        d = str(tmp_path / name)
        for s in (1, 2, 3, 4, 5):
            save(d, s, tree)
        seen = []
        removed[name] = ([pathlib.Path(p).name for p in gc(
            d, 2, on_remove=seen.append, floor=floor)], len(seen),
            _steps(d))
    assert removed["t"] == removed["j"]
    kept = removed["t"][2]
    assert kept[-2:] == [4, 5] and len(kept) <= 3
    if floor == 2:
        assert kept == [2, 4, 5]


def test_floor_fn_is_read_at_save_and_protects_the_floor(tmp_path):
    floors = iter([None, None, 1, 1])
    with AsyncCheckpointer(str(tmp_path), keep_last=1,
                           floor_fn=lambda: next(floors)) as ck:
        for s in (1, 2, 3, 4):
            ck.save(s, _tree(s))
            ck.wait()
    assert _steps(tmp_path) == [4]
    floors = iter([2, 2, 2])
    with AsyncCheckpointer(str(tmp_path / "f"), keep_last=1,
                           floor_fn=lambda: next(floors)) as ck:
        for s in (1, 2, 3):
            ck.save(s, _tree(s))
            ck.wait()
    assert _steps(tmp_path / "f") == [2, 3]


def test_writer_records_spans_and_counters_as_jax(tmp_path):
    """ckpt.saves / ckpt.commits in the registry; the snapshot span on
    the caller's lane; the writer's write/fsync/commit/gc spans on the
    "ckpt" lane under the real clock only, as in the JAX writer."""
    out = {}
    for name, mod, Ck, tree in (("t", tobs, AsyncCheckpointer, _tree),
                                ("j", jobs, JAsync, _jtree)):
        names = {}
        for clock in (None, iter(range(10 ** 6)).__next__):
            with mod.recording(mod.Recorder(clock=clock)) as rec:
                with Ck(str(tmp_path / name / str(clock is None)),
                        keep_last=1) as ck:
                    for s in (1, 2):
                        ck.save(s, tree(s))
                    ck.wait()
            names[clock is None] = sorted((e.name, e.host, e.cat,
                                           e.args["step"])
                                          for e in rec.events)
            assert rec.metrics() == {"ckpt.saves": 2.0, "ckpt.commits": 2.0}
        out[name] = names
    assert out["t"] == out["j"]
    real = out["t"][True]
    assert ("ckpt.snapshot", "driver", "ckpt", 2) in real
    assert {n for n, h, _, _ in real if h == "ckpt"} == {
        "ckpt.write", "ckpt.fsync", "ckpt.commit", "ckpt.gc"}
    assert out["t"][False] == [("ckpt.snapshot", "driver", "ckpt", 1),
                               ("ckpt.snapshot", "driver", "ckpt", 2)]
