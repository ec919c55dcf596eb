"""Port parity for models/common: norms, RoPE, dense, activations and the
weight initialiser, against the JAX package on the same numpy inputs."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as JC  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

RNG = np.random.RandomState(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(shape, scale=1.0):
    return (RNG.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("fn", ["rms_norm", "head_rms_norm"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 4, 2, 64)])
def test_norms_match_jax(fn, shape):
    x, s = _np(shape, 3.0), _np(shape[-1:]) + 1.0
    ref = getattr(JC, fn)(jnp.asarray(x), jnp.asarray(s), 1e-6)
    out = getattr(TC, fn)(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("theta,D", [(1e6, 64), (1e4, 128)])
def test_apply_rope_matches_jax(theta, D):
    x = _np((2, 7, 3, D))
    pos = RNG.randint(0, 600, size=(2, 7)).astype(np.int32)
    ref = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_apply_rope_bf16_keeps_dtype():
    x = torch.from_numpy(_np((1, 4, 2, 64))).to(torch.bfloat16)
    pos = torch.arange(4)[None]
    out = TC.apply_rope(x, pos, 1e6)
    assert out.dtype == torch.bfloat16
    ref = TC.apply_rope(x.float(), pos, 1e6)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("wshape", [(64, 96), (64, 4, 16)])
def test_dense_matches_jax(wshape):
    x, w = _np((2, 3, 64)), _np(wshape, 0.1)
    ref = JC.dense(jnp.asarray(x), jnp.asarray(w))
    out = TC.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_activation_matches_jax(kind):
    x = _np((4, 33), 2.0)
    ref = JC.activation_fn(kind)(jnp.asarray(x))
    out = TC.activation_fn(kind)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_param_tree_matches_jax_layout():
    """init_model gives the JAX tree's keys, stacked shapes and dtypes, so
    the bridge maps the two one to one."""
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    mine = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
    flat_j = {"/".join(str(k.key) for k in path): leaf for path, leaf
              in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + k + "/")
            else:
                yield prefix + k, v

    flat_t, flat_m = dict(walk(tp)), dict(walk(mine))
    assert set(flat_t) == set(flat_j) == set(flat_m)
    for name, leaf in flat_j.items():
        assert tuple(flat_m[name].shape) == leaf.shape, name
        np.testing.assert_array_equal(flat_t[name].numpy(), np.asarray(leaf))


def test_init_mirrors_materialize():
    """normal * 1/sqrt(fan_in), small_normal 0.02, ones; drawn from the
    generator, so one seed gives one set of weights."""
    _, tcfg = TP.configs()
    p = TMD.init_model(tcfg, torch.Generator().manual_seed(3))
    q = TMD.init_model(tcfg, torch.Generator().manual_seed(3))
    assert torch.equal(p["blocks"]["attn"]["wq"], q["blocks"]["attn"]["wq"])
    d = tcfg.d_model
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert abs(float(p["blocks"]["mlp"]["w1"].std()) - d ** -0.5) < 0.01
    assert abs(float(p["blocks"]["mlp"]["w2"].std())
               - tcfg.d_ff ** -0.5) < 0.01
    assert torch.equal(p["final_norm"], torch.ones(d))
    assert torch.equal(p["blocks"]["attn"]["q_scale"],
                       torch.ones(tcfg.num_layers, tcfg.head_dim))


def _materialize_before(desc, generator):
    """The initialiser as it drew every leaf before chunked draws: one
    fp32 randn of the whole shape, scaled, cast."""
    import math
    dtype = TC.torch_dtype(desc.dtype)
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=dtype)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=dtype)
    fan_in = desc.fan_in
    if fan_in is None:
        fan_in = desc.shape[-2] if len(desc.shape) >= 2 else desc.shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    if desc.init == "small_normal":
        scale = 0.02
    x = torch.randn(desc.shape, generator=generator, dtype=torch.float32)
    return (x * scale).to(dtype)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-1.7b", "zamba2-1.2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialize_leaves_under_the_chunk_draw_as_before(arch, dtype):
    """Leaves at or under DRAW_CHUNK elements draw bit-identically to the
    whole-shape draw, in the same generator order; every leaf of the
    earlier configs at full width is such a leaf, so their seeded weights
    are unchanged."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    full = TMD.model_descs(get_config(arch))
    assert max(TC.math.prod(d.shape) for d in tree_leaves(full)) \
        <= TC.DRAW_CHUNK
    cfg = get_config(arch, smoke=True).with_(param_dtype=dtype)
    got = TMD.init_model(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    want = TC.tree_map(lambda d: _materialize_before(d, gen),
                       TMD.model_descs(cfg))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialize_chunks_large_leaves(monkeypatch, dtype):
    """A leaf above DRAW_CHUNK elements draws chunk by chunk into its own
    dtype: the leaf's shape and dtype, mean 0 and std 1/sqrt(fan_in), no
    chunk repeating another, one seed one tensor."""
    monkeypatch.setattr(TC, "DRAW_CHUNK", 4096)
    desc = TC.ParamDesc((3, 64, 100), dtype, fan_in=64)   # 19200 elements
    a = TC._materialize(desc, torch.Generator().manual_seed(1), "cpu")
    b = TC._materialize(desc, torch.Generator().manual_seed(1), "cpu")
    assert tuple(a.shape) == desc.shape and a.dtype == TC.torch_dtype(dtype)
    assert torch.equal(a, b)
    x = a.float().reshape(-1)
    assert abs(float(x.mean())) < 0.01
    assert abs(float(x.std()) - 64 ** -0.5) < 0.005
    chunks = x[:4 * 4096].reshape(4, 4096)
    for i in range(4):
        for j in range(i):
            assert not torch.equal(chunks[i], chunks[j])
    small = TC._materialize(TC.ParamDesc((4096,), dtype, fan_in=64),
                            torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(small, a.reshape(-1)[:4096])
