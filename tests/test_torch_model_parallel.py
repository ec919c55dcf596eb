"""The port's model-parallelism algorithms that are not tensor sharding,
held against the JAX package: HYPAR's partition search (survey ref 87;
`repro_torch.core.hypar`, a pure-Python copy) and decoupled
delayed-gradient training (refs 79/80; `repro_torch.core.decoupled`).
The counterparts of `tests/test_model_parallel_algos.py`, plus DDG held
tick by tick against JAX's `ddg_tick` from the same numpy weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, st
from _torch_threads import one_thread  # noqa: F401

from repro.core import decoupled as JDD
from repro.core import hypar as JH
from repro_torch.core import decoupled as DD
from repro_torch.core.hypar import (LayerCost, brute_force, hypar_partition,
                                    pure_cost, transformer_layer_costs)


# ---------------------------------------------------------------------------
# HYPAR
# ---------------------------------------------------------------------------
def test_hypar_prefers_m_for_fat_weights_d_for_fat_acts():
    fat_w = [LayerCost("w", 10_000_000, 1_000)]
    fat_a = [LayerCost("a", 1_000, 10_000_000)]
    assert hypar_partition(fat_w, W=4)[0] == ["M"]
    assert hypar_partition(fat_a, W=4)[0] == ["D"]


def test_hypar_beats_pure_on_mixed_stack():
    layers = [LayerCost("emb", 50_000_000, 4_000),      # fat weights -> M
              LayerCost("conv", 10_000, 40_000_000),    # fat acts -> D
              LayerCost("fc", 80_000_000, 8_000)]       # fat weights -> M
    path, cost = hypar_partition(layers, W=8)
    assert cost < pure_cost(layers, "D", 8)
    assert cost < pure_cost(layers, "M", 8)
    assert path == ["M", "D", "M"]


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 7), st.integers(2, 16))
def test_hypar_dp_equals_brute_force_and_jax(seed, n_layers, W):
    rng = np.random.default_rng(seed)
    sizes = [(int(rng.integers(1, 10**7)), int(rng.integers(1, 10**7)))
             for _ in range(n_layers)]
    layers = [LayerCost(f"l{i}", w, a) for i, (w, a) in enumerate(sizes)]
    p_dp, c_dp = hypar_partition(layers, W)
    p_bf, c_bf = brute_force(layers, W)
    assert abs(c_dp - c_bf) < 1e-6 * max(c_bf, 1.0)
    jl = [JH.LayerCost(f"l{i}", w, a) for i, (w, a) in enumerate(sizes)]
    assert (p_dp, c_dp) == JH.hypar_partition(jl, W)
    assert (p_bf, c_bf) == JH.brute_force(jl, W)


def test_hypar_transformer_helper():
    layers = transformer_layer_costs(d_model=512, d_ff=2048, seq=128,
                                     batch=8, num_layers=2)
    assert len(layers) == 4
    path, cost = hypar_partition(layers, W=8)
    assert cost <= min(pure_cost(layers, "D", 8), pure_cost(layers, "M", 8))
    jl = JH.transformer_layer_costs(d_model=512, d_ff=2048, seq=128,
                                    batch=8, num_layers=2)
    assert [_layer_tuple(l) for l in layers] == \
        [_layer_tuple(l) for l in jl]
    assert (path, cost) == JH.hypar_partition(jl, W=8)


def _layer_tuple(layer):
    return (layer.name, layer.weight_elems, layer.act_elems)


# ---------------------------------------------------------------------------
# decoupled delayed-gradient training (DDG)
# ---------------------------------------------------------------------------
def _np_modules(seed, sizes):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(
                np.float32),
             "b": np.zeros((b,), np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _np_problem(seed, d=8):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(d).astype(np.float32)
    X = rng.standard_normal((256, d)).astype(np.float32)
    return {"x": X, "y": np.tanh(X @ w).astype(np.float32)}


def _fns(n, lib):
    def make_fn(is_last):
        def fn(p, x):
            y = x @ p["w"] + p["b"]
            return y if is_last else lib.tanh(y)
        return fn
    return [make_fn(i == n - 1) for i in range(n)]


def loss_fn(pred, batch):
    return torch.mean((pred[:, 0] - batch["y"]) ** 2)


def jax_loss_fn(pred, batch):
    return jnp.mean((pred[:, 0] - batch["y"]) ** 2)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return [_torch(t) for t in tree]


def _full_loss(params, fns, batch):
    y = batch["x"]
    for pk, fn in zip(params, fns):
        y = fn(pk, y)
    return float(loss_fn(y, batch))


def test_ddg_converges_close_to_sequential():
    batch = _torch(_np_problem(0))
    params = _torch(_np_modules(1, (8, 16, 16, 1)))
    fns = _fns(len(params), torch)
    K = len(fns)
    seq_p = [dict(p) for p in params]
    for _ in range(300):
        seq_p, _ = DD.sequential_step(seq_p, fns, loss_fn, batch, lr=0.1)
    state = DD.ddg_init(params)
    for _ in range(300 + K):  # + pipeline fill
        state, _ = DD.ddg_tick(state, fns, loss_fn, batch, lr=0.1)
    l_ddg = _full_loss(state.params, fns, batch)
    assert l_ddg < 0.1  # converges despite staleness (the papers' claim)
    assert l_ddg < _full_loss(params, fns, batch) * 0.2  # way below init
    assert _full_loss(seq_p, fns, batch) < 0.1


def test_ddg_single_module_equals_sequential():
    """K=1: no staleness, DDG matches joint backprop exactly."""
    batch = _torch(_np_problem(2))
    params = _torch(_np_modules(3, (8, 1)))
    fns = _fns(1, torch)
    state = DD.ddg_init(params)
    seq_p = params
    for _ in range(5):
        state, _ = DD.ddg_tick(state, fns, loss_fn, batch, lr=0.05)
        seq_p, _ = DD.sequential_step(seq_p, fns, loss_fn, batch, lr=0.05)
    for a, b in zip(state.params, seq_p):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_ddg_pipeline_fills_then_all_modules_active():
    batch = _torch(_np_problem(4))
    params = _torch(_np_modules(5, (8, 8, 8, 1)))
    fns = _fns(len(params), torch)
    state = DD.ddg_init(params)
    K = len(fns)
    actives = []
    for _ in range(2 * K + 2):
        state, m = DD.ddg_tick(state, fns, loss_fn, batch)
        actives.append(m["active_modules"])
    assert actives[0] == 0          # fwd wave still filling: no grads yet
    assert actives[K - 1] == 1      # head starts updating once reached
    assert actives[-1] == K         # steady state: every module updates
    assert all(b >= a for a, b in zip(actives, actives[1:]))


@pytest.mark.parametrize("sizes", [(8, 16, 16, 1), (8, 8, 8, 8, 1)],
                         ids=["K3", "K4"])
def test_ddg_tick_by_tick_matches_jax(sizes):
    """The same numpy weights and batch through both packages' ddg_tick:
    every tick's parameters and loss at rtol 1e-5, active_modules
    exactly equal."""
    npb, npp = _np_problem(6), _np_modules(7, sizes)
    jb = {k: jnp.asarray(v) for k, v in npb.items()}
    jstate = JDD.ddg_init([{k: jnp.asarray(v) for k, v in p.items()}
                           for p in npp])
    tstate = DD.ddg_init(_torch(npp))
    jfns, tfns = _fns(len(npp), jnp), _fns(len(npp), torch)
    tb = _torch(npb)
    for tick in range(2 * len(npp) + 4):
        jstate, jm = JDD.ddg_tick(jstate, jfns, jax_loss_fn, jb, lr=0.1)
        tstate, tm = DD.ddg_tick(tstate, tfns, loss_fn, tb, lr=0.1)
        assert tm["active_modules"] == jm["active_modules"], tick
        assert (tm["loss"] is None) == (jm["loss"] is None), tick
        if tm["loss"] is not None:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
        for jp, tp in zip(jstate.params, tstate.params):
            for k in tp:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           rtol=1e-5, atol=1e-7)
