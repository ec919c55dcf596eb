"""Port parity for the optimizers, the global-norm clip and the learning
rate schedule, against the JAX package's `optim/optimizers.py`, on the
same random trees and gradients.

Tolerance: fp32 rtol 1e-6 (atol 1e-7 for entries near zero): the same
elementwise formulas, with reductions (global norm, adafactor's row and
column means) summed in another order; bf16 parameters to one bf16 ulp,
since their fp32 updates may round to either neighbour."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

FP32 = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    """Leaves of the shapes a model has: stacked matrices, a matrix, a
    vector, and a factored-looking leaf with a unit dimension."""
    r = np.random.RandomState(seed)
    return {"blocks": {"w": (r.randn(2, 8, 6) * scale).astype(np.float32),
                       "ln": (r.randn(2, 6) * scale).astype(np.float32)},
            "embed": (r.randn(10, 6) * scale).astype(np.float32),
            "head": (r.randn(6, 1) * scale).astype(np.float32),
            "norm": (r.randn(6) * scale).astype(np.float32)}


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).to(dtype)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(jnp.asarray(tree).astype(jnp.float32))


def _assert_trees_close(t, j, **tol):
    t, j = _np(t), _np(j)
    if isinstance(t, dict):
        assert sorted(t) == sorted(j)
        for k in t:
            _assert_trees_close(t[k], j[k], **tol)
    else:
        np.testing.assert_allclose(t, j, **tol)


def _schedule():
    return (JO.warmup_cosine(1e-2, 2, 5), TO.warmup_cosine(1e-2, 2, 5))


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_matches_jax_over_5_updates(name):
    jlr, tlr = _schedule()
    jopt, topt = JO.get_optimizer(name, jlr), TO.get_optimizer(name, tlr)
    jp, tp = _jax(_tree(0)), _torch(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _tree(10 + step, scale=0.1)
        jp, js = jopt.update(_jax(g), js, jp)
        tp, ts = topt.update(_torch(g), ts, tp)
        _assert_trees_close(tp, jp, **FP32)
    _assert_trees_close({k: v for k, v in ts.items() if k != "step"},
                        {k: v for k, v in js.items() if k != "step"}, **FP32)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(
        js["step"]) == 5


def test_adamw_bf16_params_update_in_fp32_and_cast_back():
    jlr, tlr = _schedule()
    jopt, topt = JO.adamw(jlr), TO.adamw(tlr)
    jp, tp = _jax(_tree(1), jnp.bfloat16), _torch(_tree(1), torch.bfloat16)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["mu"]["embed"].dtype == torch.float32
    for step in range(5):
        g = _tree(20 + step, scale=0.1)
        jp, js = jopt.update(_jax(g, jnp.bfloat16), js, jp)
        tp, ts = topt.update(_torch(g, torch.bfloat16), ts, tp)
    assert tp["embed"].dtype == torch.bfloat16
    _assert_trees_close(tp, jp, rtol=2 ** -8, atol=1e-6)
    _assert_trees_close(ts["nu"], js["nu"], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(3)
    jc, jn = JO.clip_by_global_norm(_jax(g), max_norm)
    tc, tn = TO.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close(tc, jc, **FP32)
    if max_norm > float(tn):
        _assert_trees_close(tc, _torch(g), rtol=0, atol=0)


def test_warmup_cosine_matches_jax():
    j, t = JO.warmup_cosine(3e-3, 20, 100), TO.warmup_cosine(3e-3, 20, 100)
    for step in (0, 1, 10, 19, 20, 21, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(t(torch.tensor(step, dtype=torch.int32))),
            float(j(jnp.int32(step))), rtol=1e-6)


def test_optimizer_state_keys_match_jax():
    jp, tp = _jax(_tree(4)), _torch(_tree(4))
    for name in ("adamw", "sgd", "adafactor"):
        js = JO.get_optimizer(name, lambda s: 1e-3).init(jp)
        ts = TO.get_optimizer(name, lambda s: 1e-3).init(tp)
        jk = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(js)[0]]
        tk = []

        def walk(t, path):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], path + f"['{k}']")
            else:
                tk.append(path)
        walk(ts, "")
        assert tk == jk, name
    with pytest.raises(ValueError):
        TO.get_optimizer("lamb", lambda s: 1e-3)
