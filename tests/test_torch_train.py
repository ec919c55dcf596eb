"""Port parity for the training path at the qwen3-0.6b SMOKE config in
fp32, with the JAX package's init_model weights: lm_loss and its
gradients, the train step over 5 steps with and without natural-
compressed gradients, the data pipeline, and the launcher.

Tolerances: loss and gradients rtol 1e-4 / atol 1e-5 (fp32 forward and
backward, reductions summed in another order).  The train step is held
step by step, each of 5 steps starting both packages from the same (JAX's)
state: loss and gradient norm rtol 1e-5; params and moments rtol 1e-4 /
atol 1e-5 for all but at most 1 in 10^4 elements, and every element within
the peak learning rate.  Two effects move those few elements by up to one
step: AdamW's first steps move each element by about +-lr whatever the
gradient's size, so an element whose gradient is at fp32 noise level may
step either way; and with compression, an element whose uniform lies
within the packages' fp32 gradient difference of its rounding threshold
rounds the other way.  Over 5 steps run freely the two packages' states
drift apart through these elements; step by step they agree.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import make_pipeline as jax_pipeline  # noqa: E402
from repro.launch.steps import make_train_step as jax_train_step  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
LO, HI = 2.0 ** -69, 2.0 ** 57      # the nc wire format's range
B, S = 4, 32


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, dtype=np.float32)


def _close(t, j, **tol):
    t, j = _np(t), _np(j)
    if isinstance(t, dict):
        assert sorted(t) == sorted(j)
        for k in t:
            _close(t[k], j[k], **tol)
    else:
        np.testing.assert_allclose(t, j, **tol)


def _batches(vocab, n, seed=0):
    return list(jax_pipeline(vocab, B, S, seed=seed).batches(n))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", ["none", "block"])
def test_lm_loss_and_grads_match_jax(remat):
    jcfg, tcfg = TP.configs(remat=remat)
    jp, tp = TP.params(jcfg)
    batch = _batches(jcfg.vocab_size, 1)[0]
    jl, jg = jax.value_and_grad(JMD.lm_loss)(
        jp, jcfg, jax.tree_util.tree_map(jnp.asarray, batch))
    tl, tg = loss_and_grads(tp, tcfg, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _close(tg, jax.tree_util.tree_map(np.asarray, jg), **TOL)
    # the loss on its own, without autograd, is the same number
    with torch.no_grad():
        np.testing.assert_allclose(float(TMD.lm_loss(tp, tcfg, _tb(batch))),
                                   float(tl), rtol=1e-6)


def test_block_remat_recomputes_the_same_gradients():
    _, tcfg = TP.configs(remat="none")
    _, tp = TP.params(TP.configs()[0])
    batch = _tb(_batches(tcfg.vocab_size, 1, seed=3)[0])
    l0, g0 = loss_and_grads(tp, tcfg, batch)
    l1, g1 = loss_and_grads(tp, tcfg.with_(remat="block"), batch)
    assert float(l0) == float(l1)
    _close(g1, g0, rtol=1e-6, atol=1e-8)


def _uniform_tree(key, params):
    """JAX's compression draw for one step: one key per leaf in flatten
    order, one uniform per element (what `natural_compress` draws)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    us = [np.asarray(jax.random.uniform(k, leaf.shape))
          for k, leaf in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, us)


def _in_wire_range(tree):
    for g in jax.tree_util.tree_leaves(_np(tree)):
        a = np.abs(g[g != 0])
        assert a.size == 0 or (a.min() >= LO and a.max() < HI)


def _close_but_few(t, j, lr):
    """All but 1 in 10^4 elements within TOL, every one within lr."""
    t = jax.tree_util.tree_leaves(_np(t))
    j = jax.tree_util.tree_leaves(_np(j))
    n = sum(a.size for a in t)
    off = sum(int((np.abs(a - b) > TOL["atol"] + TOL["rtol"] * np.abs(b)
                   ).sum()) for a, b in zip(t, j))
    assert off <= n // 10_000, f"{off} of {n} elements beyond {TOL}"
    assert max(float(np.abs(a - b).max()) for a, b in zip(t, j)) <= lr


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax_over_5_steps(compress):
    jcfg, tcfg = TP.configs()
    jp, _ = TP.params(jcfg)
    peak_lr = 3e-3
    jopt = JO.adamw(JO.warmup_cosine(peak_lr, 2, 5))
    topt = TO.adamw(TO.warmup_cosine(peak_lr, 2, 5))
    js = jopt.init(jp)
    jstep = jax.jit(jax_train_step(jcfg, jopt, compress_grads=compress))
    tstep = make_train_step(tcfg, topt, compress_grads=compress)

    def to_torch(tree):
        return TP.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu")

    for i, batch in enumerate(_batches(jcfg.vocab_size, 5, seed=1)):
        tp = to_torch(jp)
        ts = {"mu": to_torch(js["mu"]), "nu": to_torch(js["nu"]),
              "step": torch.tensor(int(js["step"]), dtype=torch.int32)}
        extra, noise = (), None
        if compress:
            key = jax.random.PRNGKey(100 + i)
            extra = (key,)
            noise = to_torch(_uniform_tree(key, jp))
            _in_wire_range(loss_and_grads(tp, tcfg, _tb(batch))[1])
        jp, js, jm = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, batch),
                           *extra)
        tp, ts, tm = tstep(tp, ts, _tb(batch), noise)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _close_but_few(tp, jp, peak_lr)
        _close_but_few(ts["mu"], js["mu"], peak_lr)


def test_train_step_default_noise_follows_the_step_counter():
    """Without noise, the compressed step draws from a generator seeded
    with the optimizer's step count: fresh noise each step, and the same
    noise for the same count."""
    _, tcfg = TP.configs()
    _, tp = TP.params(TP.configs()[0])
    opt = TO.adamw(TO.warmup_cosine(3e-3, 2, 5))
    step = make_train_step(tcfg, opt, compress_grads=True)
    batch = _tb(_batches(tcfg.vocab_size, 1)[0])
    s0 = opt.init(tp)

    def fresh():           # the step updates its params and state in place
        return tree_map(torch.clone, tp), tree_map(torch.clone, s0)

    a = step(*fresh(), batch)[0]
    b = step(*fresh(), batch, torch.Generator().manual_seed(0))[0]
    c = step(*fresh(), batch, torch.Generator().manual_seed(1))[0]
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_pipeline_batches_equal_jax(shard, tmp_path):
    sid, n = shard
    j = jax_pipeline(97, 3, 16, shard_id=sid, num_shards=n, seed=5)
    t = make_pipeline(97, 3, 16, shard_id=sid, num_shards=n, seed=5)
    assert t.source.entropy_nats == j.source.entropy_nats
    for bj, bt in zip(j.batches(4), t.batches(4)):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(bt[k], bj[k])
    path = tmp_path / "tokens.bin"
    np.random.RandomState(0).randint(0, 97, 500).astype(np.uint16).tofile(path)
    j = jax_pipeline(97, 2, 8, path=str(path), seed=1)
    t = make_pipeline(97, 2, 8, path=str(path), seed=1)
    for bj, bt in zip(j.batches(3), t.batches(3)):
        np.testing.assert_array_equal(bt["tokens"], bj["tokens"])


def test_train_launcher_compressed_grads_converges():
    """The criterion of the JAX package's launcher test, held by the port."""
    from repro_torch.launch.train import train
    out = train(["--smoke", "--device", "cpu", "--compress-grads",
                 "--steps", "25", "--batch", "4", "--seq", "64",
                 "--log-every", "100"])
    losses = out["losses"]
    assert len(losses) == 25 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3


def test_train_launcher_refuses_without_cuda(monkeypatch):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(["--smoke", "--steps", "1"])
