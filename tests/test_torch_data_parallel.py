"""Data parallelism (`core/data_parallel.py`) against the JAX package's.

The counterparts of `tests/test_techniques.py`'s data-parallel tests on
its linear-regression problem: the same numpy data goes through both
packages' step functions for a few rounds, and the params, losses and
the communication accounts are compared (params at rtol 1e-6 for
`sync_step`, 1e-5 for the others; comm bytes and events exactly).  The
compressed aggregate takes JAX's own uniforms (drawn with
`jax.random.uniform` on the split keys) and is held at rtol 4e-6, as the
compression parity test holds `natural_compress` (XLA's exp2 on the CPU
is not exact).  A qwen3 SMOKE `sync_step` at W = 2 in fp32 is held to
JAX's at rtol 1e-4, and DBS splits equal JAX's over a hypothesis sweep
that includes tied rates.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _hyp_compat import given, settings, st  # noqa: E402

try:
    from hypothesis import example
except ModuleNotFoundError:   # _hyp_compat's sweep: no pinned examples
    def example(**_kw):
        return lambda fn: fn

from repro.core import data_parallel as JDP  # noqa: E402
from repro.elastic.reshard import plan_split as jax_plan_split  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch.core import data_parallel as DP  # noqa: E402
from repro_torch.elastic.reshard import plan_split  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

W, DIM, NDATA = 4, 8, 256


def _problem(seed=0):
    """Linear regression (test_techniques' problem) from numpy."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(DIM).astype(np.float32)
    X = rng.randn(NDATA, DIM).astype(np.float32)
    y = (X @ w_true + 0.01 * rng.randn(NDATA)).astype(np.float32)
    return X, y


def jax_loss(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def torch_loss(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _shards(X, y):
    n = NDATA // W
    return {"x": X[: n * W].reshape(W, n, DIM), "y": y[: n * W].reshape(W, n)}


def _shards_k(X, y, K):
    n = NDATA // (W * K)
    return {"x": X[: n * W * K].reshape(W, K, n, DIM),
            "y": y[: n * W * K].reshape(W, K, n)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _close(t, j, **tol):
    tl, jl = tree_leaves(t), jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def _opts(momentum=0.9, lr=0.05):
    return (JO.sgd_momentum(lambda s: lr, momentum=momentum),
            TO.sgd_momentum(lambda s: lr, momentum=momentum))


# ---------------------------------------------------------------------------
# S-SGD, all-reduce and parameter server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["allreduce", "ps"])
def test_sync_step_matches_jax(mode):
    X, y = _problem()
    b = _shards(X, y)
    jopt, topt = _opts()
    jp = {"w": jnp.zeros((DIM,))}
    tp = {"w": torch.zeros(DIM)}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        jp, js, jm = JDP.sync_step(jax_loss, jp, jopt, js, _j(b), mode=mode)
        tp, ts, tm = DP.sync_step(torch_loss, tp, topt, ts, _t(b), mode=mode)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        for k in ("comm_bytes", "bottleneck_link_bytes", "comm_events"):
            assert tm[k] == jm[k] and type(tm[k]) is int, k
    _close(tp, jp, rtol=1e-6)
    _close(ts["mu"], js["mu"], rtol=1e-6)


def test_sync_sgd_equals_single_worker_big_batch():
    """test_techniques' property on the port: S-SGD over W shards is one
    SGD step on the joined batch; ps gives the same params and a larger
    bottleneck link."""
    X, y = _problem()
    _, topt = _opts(momentum=0.0)
    tp = {"w": torch.zeros(DIM)}
    p1, _, m_ar = DP.sync_step(torch_loss, tp, topt, topt.init(tp),
                               _t(_shards(X, y)))
    p_ps, _, m_ps = DP.sync_step(torch_loss, tp, topt, topt.init(tp),
                                 _t(_shards(X, y)), mode="ps")
    _, g = DP.value_and_grad(torch_loss, tp, _t({"x": X, "y": y}))
    np.testing.assert_allclose(p1["w"].numpy(), (tp["w"] - 0.05 * g["w"])
                               .numpy(), rtol=1e-5)
    assert torch.equal(p1["w"], p_ps["w"])
    assert m_ps["bottleneck_link_bytes"] > m_ar["bottleneck_link_bytes"]


def _jax_uniforms(key, tree):
    """JAX's compressed-aggregate draw: one key per stacked leaf (flatten
    order), one uniform per element (what `natural_compress` draws)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.uniform(k, l.shape))
        for k, l in zip(keys, leaves)])


@pytest.mark.parametrize("mode", ["allreduce", "ps"])
def test_compressed_aggregate_takes_jax_uniforms(mode):
    rng = np.random.RandomState(1)
    grads_w = {"b": rng.randn(W, 5).astype(np.float32),
               "w": (rng.randn(W, 3, 7) * 1e-3).astype(np.float32)}
    grads_w["w"][0, 0, :2] = 0.0                 # zeros stay zero
    key = jax.random.PRNGKey(3)
    jm, jc = JDP.aggregate(_j(grads_w), mode, compress_key=key)
    tm, tc = DP.aggregate(_t(grads_w), mode,
                          noise=_t(_jax_uniforms(key, grads_w)))
    _close(tm, jm, rtol=4e-6)
    assert tc == jc
    # and a generator draws its own uniforms, with the same accounts
    _, gc = DP.aggregate(_t(grads_w), mode,
                         noise=torch.Generator().manual_seed(0))
    assert gc == jc


def test_compressed_sync_steps_match_jax():
    X, y = _problem()
    b = _shards(X, y)
    jopt, topt = _opts(lr=0.03)
    jp, tp = {"w": jnp.zeros((DIM,))}, {"w": torch.zeros(DIM)}
    js, ts = jopt.init(jp), topt.init(tp)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        key, k = jax.random.split(key)
        shape = {"w": np.zeros((W, DIM), np.float32)}
        jp, js, jm = JDP.sync_step(jax_loss, jp, jopt, js, _j(b),
                                   compress_key=k)
        tp, ts, tm = DP.sync_step(torch_loss, tp, topt, ts, _t(b),
                                  noise=_t(_jax_uniforms(k, shape)))
        assert tm["comm_bytes"] == jm["comm_bytes"]
    _close(tp, jp, rtol=4e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# local SGD, EASGD, DETSGRAD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sync", [True, False])
def test_local_sgd_rounds_match_jax(sync):
    X, y = _problem()
    K = 4
    b = _shards_k(X, y, K)
    jopt, topt = _opts(momentum=0.0, lr=0.03)    # test_techniques' optimizer
    p0 = np.zeros((W, DIM), np.float32)
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0.copy())}
    js = jax.vmap(jopt.init)(jp)
    ts = DP._stack([topt.init({"w": tp["w"][w]}) for w in range(W)])
    for _ in range(3):
        jp, js, jm = JDP.local_sgd_round(jax_loss, jp, jopt, js, _j(b),
                                         sync=sync)
        tp, ts, tm = DP.local_sgd_round(torch_loss, tp, topt, ts, _t(b),
                                        sync=sync)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert tm["comm_bytes"] == int(jm["comm_bytes"])
    # an atol of float32's eps at the params' scale (~1) beside the rtol:
    # a weight near zero (~1e-4) and mu, the last gradients, some near 0
    _close(tp, jp, rtol=1e-5, atol=1e-7)
    _close(ts["mu"], js["mu"], rtol=1e-5, atol=1e-7)
    assert ts["step"].tolist() == np.asarray(js["step"]).tolist()
    if sync:
        # the rows are real copies, bit-equal, not views of one row
        assert all(torch.equal(tp["w"][0], tp["w"][w]) for w in range(W))
        tp["w"][1].add_(1.0)
        assert not torch.equal(tp["w"][0], tp["w"][1])


def test_local_sgd_bf16_counts_fp32_mean_bytes():
    """comm_bytes counts the fp32 mean even for bf16 params, as JAX."""
    X, y = _problem()
    b = _t(_shards_k(X, y, 2))
    b = tree_map(lambda t: t.to(torch.bfloat16), b)
    _, topt = _opts()
    tp = {"w": torch.zeros(W, DIM, dtype=torch.bfloat16)}
    ts = DP._stack([topt.init({"w": tp["w"][w]}) for w in range(W)])
    out, _, m = DP.local_sgd_round(torch_loss, tp, topt, ts, b)
    assert out["w"].dtype == torch.bfloat16
    assert m["comm_bytes"] == 2 * DIM * 4 * (W - 1)


def test_easgd_rounds_match_jax():
    X, y = _problem()
    K = 2
    b = _shards_k(X, y, K)
    cfg_j = JDP.EASGDConfig(lr=0.05, rho=0.5)
    cfg_t = DP.EASGDConfig(lr=0.05, rho=0.5)
    p0 = (0.5 * np.random.RandomState(2).randn(W, DIM)).astype(np.float32)
    jp, tp = {"w": jnp.asarray(p0)}, {"w": torch.from_numpy(p0.copy())}
    jc, tc = {"w": jnp.zeros((DIM,))}, {"w": torch.zeros(DIM)}
    for _ in range(4):
        jp, jc, jm = JDP.easgd_round(jax_loss, jp, jc, _j(b), cfg_j)
        tp, tc, tm = DP.easgd_round(torch_loss, tp, tc, _t(b), cfg_t)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert tm["comm_bytes"] == int(jm["comm_bytes"])
    _close(tp, jp, rtol=1e-5)
    _close(tc, jc, rtol=1e-5, atol=1e-7)


def test_detsgrad_fires_match_jax_step_by_step():
    """The same fire decisions, worker by worker and step by step, each
    decided with a margin to the threshold far above float error (so the
    equality is not a near-tie that happened to agree)."""
    X, y = _problem()
    b = _shards(X, y)
    p0 = np.zeros((W, DIM), np.float32)
    jp = jb = {"w": jnp.asarray(p0)}
    tp, tb = {"w": torch.from_numpy(p0.copy())}, {"w": torch.from_numpy(
        p0.copy())}
    kw = dict(lr=0.03, c0=0.5)
    fired = 0
    for i in range(40):
        jb_old = np.asarray(jb["w"])
        jp, jb, jm = JDP.detsgrad_step(jax_loss, jp, jb, jnp.int32(i),
                                       _j(b), **kw)
        tp, tb, tm = DP.detsgrad_step(torch_loss, tp, tb, i, _t(b), **kw)
        assert int(tm["comm_events"]) == int(jm["comm_events"])
        assert int(tm["comm_bytes"]) == int(jm["comm_bytes"])
        fired += int(jm["comm_events"])
        drift = np.abs(np.asarray(jp["w"]) - jb_old).sum(-1)
        thresh = np.float32(0.5) / np.power(np.float32(i + 1),
                                            np.float32(0.505))
        assert np.all(np.abs(drift - thresh) > 1e-4 * thresh), (i, drift)
        _close(tb, jb, rtol=1e-5, atol=1e-7)
    _close(tp, jp, rtol=1e-5, atol=1e-7)
    assert 0 < fired < 40 * W


# ---------------------------------------------------------------------------
# DBS
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.lists(st.sampled_from([0.25, 0.5, 1.0, 1.0, 2.0, 3.0, 0.7,
                                 1.3, 4.0]), min_size=1, max_size=8),
       st.integers(1, 512), st.sampled_from([1, 2, 4, 8]),
       st.floats(0.1, 10.0))
# the fp32 sum's last bit decides this one's remainders (worker 0's 3 rows)
@example(rates=[0.7, 1.3, 4.0, 3.0, 0.7, 0.5], batch=34, multiple=1,
         scale=1.558169554282709)
def test_dbs_partition_and_plan_split_match_jax(rates, batch, multiple,
                                                scale):
    """Splits equal JAX's exactly, with tied rates (the sampled values
    repeat) and scaled ones; ties in the remainder go to the lower id."""
    _dbs_matches_jax(rates, batch, multiple, scale)


@pytest.mark.parametrize("rates,batch,multiple,scale", [
    # the fp32 sum's last bit decides worker 0's 3 rows (without hypothesis
    # the sweep above never draws it)
    ([0.7, 1.3, 4.0, 3.0, 0.7, 0.5], 34, 1, 1.558169554282709),
    ([0.7, 1.3, 4.0, 3.0, 0.7, 0.5], 34, 2, 1.558169554282709),
])
def test_dbs_partition_sums_rates_as_jax_does(rates, batch, multiple, scale):
    _dbs_matches_jax(rates, batch, multiple, scale)


def _dbs_matches_jax(rates, batch, multiple, scale):
    rates = [r * scale for r in rates]
    js = np.asarray(JDP.dbs_partition(jnp.asarray(rates, jnp.float32),
                                      batch, multiple))
    ts = DP.dbs_partition(rates, batch, multiple)
    assert ts.dtype == torch.int32
    assert ts.tolist() == js.tolist()
    assert int(ts.sum()) == batch // multiple * multiple
    ids = {3 * i + 1: r for i, r in enumerate(rates)}
    assert plan_split(batch, ids, multiple) == jax_plan_split(batch, ids,
                                                              multiple)
    np.testing.assert_allclose(
        float(DP.dbs_epoch_time(torch.tensor(rates), ts.float())),
        float(JDP.dbs_epoch_time(jnp.asarray(rates, jnp.float32),
                                 jnp.asarray(js, jnp.float32))), rtol=1e-6)


def test_dbs_balances_heterogeneous_workers():
    rates = torch.tensor([1.0, 1.0, 2.0, 4.0])
    split = DP.dbs_partition(rates, 256)
    assert int(split.sum()) == 256
    t_uniform = float(DP.dbs_epoch_time(rates, torch.full((4,), 64.0)))
    assert float(DP.dbs_epoch_time(rates, split.float())) < t_uniform


# ---------------------------------------------------------------------------
# qwen3 SMOKE
# ---------------------------------------------------------------------------
def test_qwen3_sync_step_matches_jax():
    """One S-SGD step of the qwen3 SMOKE model at W = 2 in fp32, from
    JAX's init_model weights, held to JAX's sync_step at rtol 1e-4."""
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    rng = np.random.RandomState(5)
    toks = rng.randint(0, jcfg.vocab_size, (2, 1, 17)).astype(np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jopt, topt = _opts(lr=0.1)
    jstep = jax.jit(lambda p, s, bw: JDP.sync_step(
        lambda q, x: JMD.lm_loss(q, jcfg, x), p, jopt, s, bw))
    jp2, js2, jm = jstep(jp, jopt.init(jp), _j(b))
    tp2, ts2, tm = DP.sync_step(lambda q, x: TMD.lm_loss(q, tcfg, x),
                                tp, topt, topt.init(tp), _t(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert tm["comm_bytes"] == int(jm["comm_bytes"])
    _close(tp2, jp2, rtol=1e-4, atol=1e-6)
    _close(ts2["mu"], js2["mu"], rtol=1e-4, atol=1e-6)
