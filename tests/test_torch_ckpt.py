"""Checkpoints cross the two packages: a checkpoint the JAX package's
`save_checkpoint` writes restores in the port leaf for leaf (fp32, bf16
stored as fp32, the int32 step), the port's restores in the JAX package,
and both write the same bytes; `latest_step`, `gc_checkpoints` and
`sweep_tmp` agree; a resumed run continues exactly as an uninterrupted
one."""
import pathlib

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro_torch.checkpoint import ckpt as TCK  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _trees(dtype):
    """The same {"params", "opt"} tree for both packages."""
    jcfg, _ = TP.configs()
    jp, tp = TP.params(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    tp = jax.tree_util.tree_map(lambda t: t.to(TDT[dtype]), tp)
    r = np.random.RandomState(1)
    mu = r.randn(5, 3).astype(np.float32)
    jt = {"params": jp, "opt": {"mu": jnp.asarray(mu),
                                "step": jnp.asarray(7, jnp.int32)}}
    tt = {"params": tp, "opt": {"mu": torch.from_numpy(mu),
                                "step": torch.tensor(7, dtype=torch.int32)}}
    return jt, tt


def _files(d: pathlib.Path):
    return {p.relative_to(d): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways(dtype, tmp_path):
    jt, tt = _trees(dtype)
    JCK.save_checkpoint(str(tmp_path / "j"), 3, jt, {"step": 3})
    TCK.save_checkpoint(str(tmp_path / "t"), 3, tt, {"step": 3})
    # the same files, byte for byte (manifest included)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")

    like = jax.tree_util.tree_map(torch.zeros_like, tt)
    back, meta = TCK.restore_checkpoint(str(tmp_path / "j"), like)
    assert meta == {"step": 3}
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    abs_tree = jax.eval_shape(lambda: jt)
    jback, _ = JCK.restore_checkpoint(str(tmp_path / "t"), abs_tree)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)))


def test_restore_rejects_a_wrong_shape(tmp_path):
    _, tt = _trees("float32")
    TCK.save_checkpoint(str(tmp_path), 1, tt)
    like = jax.tree_util.tree_map(torch.zeros_like, tt)
    like["opt"]["mu"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        TCK.restore_checkpoint(str(tmp_path), like)
    with pytest.raises(FileNotFoundError):
        TCK.restore_checkpoint(str(tmp_path / "none"), like)


def test_latest_step_gc_and_sweep_agree_with_jax(tmp_path):
    tree_j = {"w": jnp.ones(3)}
    tree_t = {"w": torch.ones(3)}
    for pkg, save, tree in (("j", JCK.save_checkpoint, tree_j),
                            ("t", TCK.save_checkpoint, tree_t)):
        d = str(tmp_path / pkg)
        for step in (5, 1, 9, 3):
            save(d, step, tree)
        (tmp_path / pkg / "step_00000011").mkdir()       # no manifest
        (tmp_path / pkg / ".tmp_step_00000012").mkdir()  # a killed save
    assert TCK.latest_step(str(tmp_path / "t")) == JCK.latest_step(
        str(tmp_path / "j")) == 9
    assert TCK.latest_step(str(tmp_path / "none")) is None
    rj = JCK.gc_checkpoints(str(tmp_path / "j"), 2)
    rt = TCK.gc_checkpoints(str(tmp_path / "t"), 2)
    assert [pathlib.Path(p).name for p in rt] == [
        pathlib.Path(p).name for p in rj] == ["step_00000001",
                                              "step_00000003"]
    sj = JCK.sweep_tmp(str(tmp_path / "j"))
    st = TCK.sweep_tmp(str(tmp_path / "t"))
    assert [pathlib.Path(p).name for p in st] == [
        pathlib.Path(p).name for p in sj] == [".tmp_step_00000012"]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())


def test_overwrite_displaced_copy_is_put_back_by_sweep(tmp_path):
    """A kill between the two renames of an overwrite leaves only
    `.old_step_N`: the sweep puts it back."""
    TCK.save_checkpoint(str(tmp_path), 4, {"w": torch.ones(2)})
    TCK.save_checkpoint(str(tmp_path), 4, {"w": torch.full((2,), 2.0)})
    back, _ = TCK.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)})
    assert torch.equal(back["w"], torch.full((2,), 2.0))
    (tmp_path / "step_00000004").rename(tmp_path / ".old_step_00000004")
    assert TCK.latest_step(str(tmp_path)) is None
    TCK.sweep_tmp(str(tmp_path))
    assert TCK.latest_step(str(tmp_path)) == 4


def test_resumed_run_continues_exactly(tmp_path):
    """6 steps straight, against 3 steps, a checkpoint, and 3 resumed
    steps: the same parameters, bit for bit.  Fewer steps than the
    warmup keeps the learning rate independent of --steps; the resumed
    run skips the batches the restored steps consumed and draws step s's
    compression noise from seed + 1 + s, as the uninterrupted run."""
    from repro_torch.launch.train import train
    common = ["--smoke", "--device", "cpu", "--compress-grads", "--batch",
              "2", "--seq", "16", "--log-every", "100"]
    straight = train(common + ["--steps", "6"])
    d = str(tmp_path / "ck")
    first = train(common + ["--steps", "3", "--ckpt-dir", d])
    resumed = train(common + ["--steps", "3", "--ckpt-dir", d, "--resume"])
    assert TCK.latest_step(d) == 6
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(straight["params"])):
        assert torch.equal(a, b)
