"""`repro_torch.classic` (k-means, SVM, boosting) against the JAX package.

Every public function gets the same numpy data as its JAX counterpart
(tests/test_classic.py's blobs, drawn by JAX from its keys), and the
k-means initial indices JAX's `choice(replace=False)` picks.  Integer
results (assignments, picked stumps, support-vector counts) are compared
exactly, fp32 values at rtol 1e-5 (the SVM weights, a sum of 200-400
subgradient steps, at atol 1e-5 as well).  The second half holds the
counterparts of tests/test_classic.py's ten tests on the port's own
generators, and the chunked paths against unchunked passes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hyp_compat import given, settings, st  # noqa: E402

from repro.classic import boosting as JB  # noqa: E402
from repro.classic import kmeans as JK  # noqa: E402
from repro.classic import svm as JS  # noqa: E402
from repro_torch.classic import boosting as TB  # noqa: E402
from repro_torch.classic import kmeans as TK  # noqa: E402
from repro_torch.classic import svm as TS  # noqa: E402

KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _two_blobs(n=512, d=8, sep=2.0, key=KEY):
    k1, k2, _ = jax.random.split(key, 3)
    y = jnp.where(jax.random.uniform(k1, (n,)) < 0.5, 1.0, -1.0)
    mu = sep * jnp.ones((d,)) / np.sqrt(d)
    x = y[:, None] * mu[None] + jax.random.normal(k2, (n, d))
    return np.asarray(x), np.asarray(y)


def _shard(x, y, W):
    n = x.shape[0] // W
    return x[: n * W].reshape(W, n, -1), y[: n * W].reshape(W, n)


def _blobs3(n=600, d=4, key=KEY):
    ks = jax.random.split(key, 4)
    mus = jnp.array([[4.0] * d, [-4.0] * d,
                     [4.0] * (d // 2) + [-4.0] * (d - d // 2)])
    assign = jax.random.randint(ks[0], (n,), 0, 3)
    return np.asarray(mus[assign] + jax.random.normal(ks[1], (n, d)))


def _init_idx(n, k, key=KEY):
    """`kmeans_fit`'s initial indices: choice(key, n, (k,), replace=False)."""
    return np.asarray(jax.random.choice(key, n, (k,), replace=False))


# ---------------------------------------------------------------------------
# k-means, consensus, fuzzy c-means
# ---------------------------------------------------------------------------
def test_local_stats_and_step_equal_jax():
    x = _blobs3()
    c = x[_init_idx(600, 5)]
    sums, counts, inertia = TK.local_stats(_t(x), _t(c))
    js, jc, ji = JK.local_stats(x, c)
    assert np.array_equal(_np(TK._assign(_t(x), _t(c))[0]),
                          np.asarray(JK._assign(x, c)[0]))
    _close(sums, js)
    assert np.array_equal(_np(counts), np.asarray(jc))
    _close(inertia, ji)
    xw = x.reshape(4, -1, 4)
    nc, ni = TK.kmeans_step(_t(xw), _t(c))
    jnc, jni = JK.kmeans_step(xw, c)
    _close(nc, jnc)
    _close(ni, jni)


@pytest.mark.parametrize("centralized", [False, True])
def test_kmeans_fit_equals_jax(centralized):
    x = _blobs3()
    idx = _init_idx(600, 3)
    if centralized:
        cj, hj = JK.kmeans_centralized(x, k=3, iters=15)
        ct, ht = TK.kmeans_centralized(_t(x), k=3, iters=15, noise=_t(idx))
    else:
        xw = x.reshape(4, -1, 4)
        cj, hj = JK.kmeans_fit(xw, k=3, iters=15)
        ct, ht = TK.kmeans_fit(_t(xw), k=3, iters=15, noise=_t(idx))
    _close(ct, cj)
    _close(ht, hj)


def test_kmeans_empty_cluster_keeps_its_centroid_like_jax():
    x = _blobs3()
    c = np.concatenate([x[:3], np.full((1, 4), 100.0, np.float32)])
    nc, _ = TK.kmeans_step(_t(x.reshape(2, -1, 4)), _t(c))
    jnc, _ = JK.kmeans_step(x.reshape(2, -1, 4), c)
    _close(nc, jnc)
    assert np.array_equal(_np(nc[3]), c[3])


@pytest.mark.parametrize("W", [2, 3, 6])
def test_consensus_mean_equals_jax(W):
    rng = np.random.default_rng(W)
    vals = rng.normal(size=(W, 5)).astype(np.float32)
    wts = (np.abs(rng.normal(size=W)) + 0.5).astype(np.float32)
    _close(TK.consensus_mean(_t(vals), _t(wts), rounds=60),
           JK.consensus_mean(vals, wts, rounds=60), atol=1e-6)
    topo = np.full((W, W), 1.0 / W, np.float32)
    _close(TK.consensus_mean(_t(vals), _t(wts), 3, topology=_t(topo)),
           JK.consensus_mean(vals, wts, 3, topology=topo), atol=1e-6)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_fuzzy_cmeans_and_xie_beni_equal_jax(k):
    x = _blobs3(n=900)
    xw = x.reshape(3, -1, 4)
    c = x[_init_idx(900, k, jax.random.PRNGKey(k))]
    for _ in range(3):
        jc, jobj = JK.fuzzy_cmeans_step(xw, c)
        tc, tobj = TK.fuzzy_cmeans_step(_t(xw), _t(c))
        _close(tc, jc)
        _close(tobj, jobj)
        c = np.asarray(jc)
    _close(TK.xie_beni(_t(xw), _t(c)), JK.xie_beni(xw, c))


def test_chunked_assign_equals_unchunked(monkeypatch):
    """Slices of 7 rows (chunk elements 7 * k * d) give the unchunked
    pass's distances, assignments and fuzzy memberships bit for bit, and
    its float64 Lloyd statistics to their rounding."""
    x = _t(_blobs3(n=100, d=4))
    c = x[:5].clone()
    whole = TK._assign(x, c)
    whole_u = TK._memberships(x, c, 2.0)
    whole_s = TK.local_stats(x, c)
    monkeypatch.setattr(TK, "CHUNK_ELEMS", 7 * 5 * 4)
    assert len(TK._chunks(100, 20)) == 15
    part = TK._assign(x, c)
    part_u = TK._memberships(x, c, 2.0)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
    assert all(torch.equal(a, b) for a, b in zip(whole_u, part_u))
    for a, b in zip(TK.local_stats(x, c), whole_s):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-13)


# ---------------------------------------------------------------------------
# SVM
# ---------------------------------------------------------------------------
def test_hinge_objective_and_accuracy_equal_jax():
    x, y = _two_blobs()
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=8).astype(np.float32),
         "b": np.float32(0.3)}
    tp = {k: _t(v) for k, v in p.items()}
    _close(TS.hinge_objective(tp, _t(x), _t(y), 1e-3),
           JS.hinge_objective(p, x, y, 1e-3))
    assert float(TS.accuracy(tp, _t(x), _t(y))) == \
        float(JS.accuracy(p, x, y))


def test_svm_trainers_equal_jax():
    x, y = _two_blobs()
    xw, yw = _shard(x, y, 4)
    pc, hc = TS.svm_centralized(_t(x), _t(y), steps=200)
    jpc, jhc = JS.svm_centralized(x, y, steps=200)
    _close(pc["w"], jpc["w"], rtol=1e-4, atol=1e-5)
    _close(pc["b"], jpc["b"], rtol=1e-4, atol=1e-5)
    _close(hc, jhc)
    pd, comm = TS.svm_dist_gradient(_t(xw), _t(yw), steps=200)
    jpd, jcomm = JS.svm_dist_gradient(xw, yw, steps=200)
    _close(pd["w"], jpd["w"], rtol=1e-4, atol=1e-5)
    assert comm == jcomm


def test_local_fit_and_dpsvm_equal_jax():
    x, y = _two_blobs(n=1024, sep=2.5)
    xw, yw = _shard(x, y, 4)
    mask = (np.arange(256) % 3 > 0).astype(np.float32)
    tp = TS._local_fit(_t(xw[0]), _t(yw[0]), _t(mask), 1e-3, 100, 1.0)
    jp = JS._local_fit(xw[0], yw[0], mask, 1e-3, 100, 1.0)
    _close(tp["w"], jp["w"], rtol=1e-4, atol=1e-5)
    pd, info = TS.dpsvm(_t(xw), _t(yw), hops=4, local_steps=200,
                        sv_capacity=64)
    jpd, jinfo = JS.dpsvm(xw, yw, hops=4, local_steps=200, sv_capacity=64)
    _close(pd["w"], jpd["w"], rtol=1e-4, atol=1e-5)
    assert info == jinfo


def test_dpsvm_ring_takes_equal_margins_in_index_order():
    """The support-vector order is a stable sort of the margins, as
    jnp.argsort's: duplicated rows (equal margins) keep index order."""
    x, y = _two_blobs(n=256, sep=2.5)
    x = np.repeat(x[:64], 4, 0)
    y = np.repeat(y[:64], 4, 0)
    xw, yw = _shard(x, y, 2)
    pd, info = TS.dpsvm(_t(xw), _t(yw), hops=2, local_steps=50,
                        sv_capacity=16)
    jpd, jinfo = JS.dpsvm(xw, yw, hops=2, local_steps=50, sv_capacity=16)
    _close(pd["w"], jpd["w"], rtol=1e-4, atol=1e-5)
    assert info == jinfo


# ---------------------------------------------------------------------------
# boosting
# ---------------------------------------------------------------------------
def test_stump_grid_preds_errors_and_pick_equal_jax():
    x, y = _two_blobs()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert np.array_equal(_np(TB.linspace(0.0, 1.0, 18)),
                          np.asarray(jnp.linspace(0.0, 1.0, 18)))
    tg, jg = TB.StumpGrid.from_data(_t(x)), JB.StumpGrid.from_data(jx)
    assert np.array_equal(_np(tg.thresholds), np.asarray(jg.thresholds))
    assert np.array_equal(_np(TB._stump_preds(_t(x), tg)),
                          np.asarray(JB._stump_preds(jx, jg)))
    w = np.random.default_rng(0).uniform(size=512).astype(np.float32)
    w /= w.sum()
    te = TB._weighted_errors(_t(x), _t(y), _t(w), tg)
    je = JB._weighted_errors(jx, jy, jnp.asarray(w), jg)
    _close(te, je, atol=1e-7)
    assert [int(v) for v in TB._pick(te)[:3]] == \
        [int(v) for v in JB._pick(je)[:3]]
    # ties: the first minimum, as jnp.argmin
    tie = torch.ones(2, 3, 2)
    tie[1, 0, 1] = tie[0, 2, 0] = 0.0
    assert [int(v) for v in TB._pick(tie)[:3]] == [0, 2, 0]


@pytest.mark.parametrize("algo", ["centralized", "dist_full",
                                  "dist_sample"])
def test_adaboost_equals_jax(algo):
    x, y = _two_blobs(n=1024)
    xw, yw = _shard(x, y, 4)
    if algo == "centralized":
        tm = TB.adaboost_centralized(_t(x), _t(y), rounds=20)
        jm = JB.adaboost_centralized(jnp.asarray(x), jnp.asarray(y),
                                     rounds=20)
    else:
        tm = getattr(TB, f"adaboost_{algo}")(_t(xw), _t(yw), rounds=20)
        jm = getattr(JB, f"adaboost_{algo}")(jnp.asarray(xw),
                                             jnp.asarray(yw), rounds=20)
        assert tm["comm_floats"] == jm["comm_floats"]
    for k in ("d", "t", "p"):
        assert np.array_equal(_np(tm[k]), np.asarray(jm[k])), k
    _close(tm["alpha"], jm["alpha"])
    _close(TB.predict(tm, _t(x)), JB.predict(jm, jnp.asarray(x)), atol=1e-5)
    assert float(TB.error_rate(tm, _t(x), _t(y))) == \
        float(JB.error_rate(jm, jnp.asarray(x), jnp.asarray(y)))


def test_chunked_weighted_errors_equal_unchunked(monkeypatch):
    """Slices of 5 rows give the unchunked errors to fp32 rounding of
    the sum's order, and the same pick."""
    x, y = _two_blobs(n=64)
    g = TB.StumpGrid.from_data(_t(x))
    w = torch.full((64,), 1.0 / 64)
    whole = TB._weighted_errors(_t(x), _t(y), w, g)
    monkeypatch.setattr(TB, "CHUNK_ELEMS", 5 * 2 * g.thresholds.numel())
    part = TB._weighted_errors(_t(x), _t(y), w, g)
    _close(part, whole, rtol=1e-6, atol=1e-7)
    assert [int(v) for v in TB._pick(part)[:3]] == \
        [int(v) for v in TB._pick(whole)[:3]]
    full = (TB._stump_preds(_t(x), g) != _t(y)[:, None, None, None])
    _close(part, torch.einsum("n,ndtp->dtp", w, full.float()), rtol=1e-6,
           atol=1e-7)


def test_quantile_beyond_torch_limit_matches_numpy():
    """A column of 2^24 + 8 rows, past `torch.quantile`'s limit (it
    refuses a reduced axis longer than 2^24): the sort-based quantile
    equals numpy's `linear` to fp32 rounding."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=((1 << 24) + 8, 1)).astype(np.float32)
    q = TB.linspace(0.0, 1.0, 18)[1:-1]
    got = _np(TB.quantile(torch.from_numpy(x), q))
    want = np.quantile(x, _np(q).astype(np.float64), axis=0,
                       method="linear")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x), q, dim=0)


# ---------------------------------------------------------------------------
# tests/test_classic.py's claims on the port's own generators
# ---------------------------------------------------------------------------
def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _tblobs(n=512, d=8, sep=2.0, seed=0):
    g = _gen(seed)
    y = torch.where(torch.rand(n, generator=g) < 0.5, 1.0, -1.0)
    mu = sep * torch.ones(d) / np.sqrt(d)
    return y[:, None] * mu[None] + torch.randn((n, d), generator=g), y


def _tshard(x, y, W):
    n = x.shape[0] // W
    return x[: n * W].reshape(W, n, -1), y[: n * W].reshape(W, n)


def _tblobs3(n=600, d=4, seed=0):
    g = _gen(seed)
    mus = torch.tensor([[4.0] * d, [-4.0] * d,
                        [4.0] * (d // 2) + [-4.0] * (d - d // 2)])
    assign = torch.randint(0, 3, (n,), generator=g)
    return mus[assign] + torch.randn((n, d), generator=g)


def test_adaboost_centralized_drives_error_down():
    x, y = _tblobs()
    e5 = float(TB.error_rate(TB.adaboost_centralized(x, y, 5), x, y))
    e30 = float(TB.error_rate(TB.adaboost_centralized(x, y, 30), x, y))
    assert e30 <= e5
    assert e30 < 0.1


def test_dist_full_boosting_equals_centralized():
    x, y = _tblobs()
    x_w, y_w = _tshard(x, y, 4)
    grid = TB.StumpGrid.from_data(x)
    mc = TB.adaboost_centralized(x_w.reshape(-1, 8), y_w.reshape(-1),
                                 rounds=10, grid=grid)
    md = TB.adaboost_dist_full(x_w, y_w, rounds=10, grid=grid)
    assert torch.equal(mc["d"], md["d"]) and torch.equal(mc["t"], md["t"])
    _close(mc["alpha"], _np(md["alpha"]))


def test_dist_sample_boosting_cheap_and_accurate():
    x, y = _tblobs(n=1024)
    x_w, y_w = _tshard(x, y, 4)
    m_full = TB.adaboost_dist_full(x_w, y_w, rounds=20)
    m_samp = TB.adaboost_dist_sample(x_w, y_w, rounds=20)
    assert m_samp["comm_floats"] < m_full["comm_floats"] / 10
    assert float(TB.error_rate(m_samp, x, y)) < \
        float(TB.error_rate(m_full, x, y)) + 0.05


def test_svm_dist_gradient_equals_centralized():
    x, y = _tblobs()
    x_w, y_w = _tshard(x, y, 4)
    pc, _ = TS.svm_centralized(x_w.reshape(-1, 8), y_w.reshape(-1),
                               steps=200)
    pd, _ = TS.svm_dist_gradient(x_w, y_w, steps=200)
    _close(pc["w"], _np(pd["w"]), rtol=1e-4, atol=1e-5)


def test_dpsvm_accuracy_and_communication():
    x, y = _tblobs(n=1024, sep=2.5)
    x_w, y_w = _tshard(x, y, 4)
    pc, _ = TS.svm_centralized(x, y, steps=400)
    pd, info = TS.dpsvm(x_w, y_w, hops=4, local_steps=200, sv_capacity=64)
    assert float(TS.accuracy(pd, x, y)) > float(TS.accuracy(pc, x, y)) - 0.03
    assert info["comm_floats"] < info["full_exchange_floats"]


def test_svm_objective_decreases():
    x, y = _tblobs()
    _, hist = TS.svm_centralized(x, y, steps=300)
    assert hist[-1] < hist[10]


def test_distributed_kmeans_equals_centralized():
    x = _tblobs3()
    cd, hist_d = TK.kmeans_fit(x.reshape(4, -1, 4), k=3, iters=15)
    cc, hist_c = TK.kmeans_centralized(x, k=3, iters=15)
    _close(cd, _np(cc))
    _close(hist_d, _np(hist_c))


def test_kmeans_inertia_monotone():
    x = _tblobs3()
    _, hist = TK.kmeans_fit(x.reshape(4, -1, 4), k=3, iters=15)
    h = _np(hist)
    assert np.all(h[1:] <= h[:-1] + 1e-3)


@settings(max_examples=10, deadline=None)
@given(st.integers(2, 8))
def test_iterative_consensus_converges_to_allreduce(W):
    vals = torch.randn((W, 5), generator=_gen(W))
    wts = torch.abs(torch.randn(W, generator=_gen(W + 1))) + 0.5
    out = TK.consensus_mean(vals, wts, rounds=400)
    want = torch.sum(vals * wts[:, None], 0) / torch.sum(wts)
    _close(out, np.broadcast_to(_np(want), out.shape), rtol=1e-3, atol=1e-3)


def test_xie_beni_selects_true_k():
    x = _tblobs3(n=900)
    x_w = x.reshape(3, -1, 4)
    scores = {}
    for k in (2, 3, 5):
        c = x[torch.randperm(900, generator=_gen(k))[:k]]
        for _ in range(25):
            c, _ = TK.fuzzy_cmeans_step(x_w, c)
        scores[k] = float(TK.xie_beni(x_w, c))
    assert scores[3] == min(scores.values())
