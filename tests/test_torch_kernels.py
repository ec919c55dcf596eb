"""Port parity for the attention and SSD scan kernels' plain versions
(against the JAX Pallas kernels in interpret mode and the JAX oracles) and
the CPU dispatch of the kernel wrappers.  The CUDA kernels themselves are held against the
plain versions in tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

# a subset of tests/test_kernels.py FA_SHAPES; every query row sees at
# least one key (T >= S, causal), so the kernels' "masked row -> 0" and the
# oracle's uniform average never differ here
FA_SHAPES = [
    # B, S, T, Hq, Hk, dh, causal, window
    (1, 128, 384, 4, 4, 128, True, None),   # MHA, S < T (suffix decode)
    (2, 256, 256, 8, 4, 64, True, 128),     # sliding window
    (1, 200, 256, 4, 2, 64, True, None),    # unpadded q length
    (2, 128, 128, 4, 2, 64, False, None),   # non-causal (encoder)
    (1, 96, 96, 8, 8, 64, True, None),      # zamba2's shared block: G 1
    (1, 64, 64, 8, 8, 96, True, None),      # phi-3-vision-4.2b: dh 96
    (1, 64, 128, 24, 2, 192, True, None),   # nemotron-4-340b: dh 192, G 12
    (1, 32, 64, 4, 4, 96, False, None),     # non-causal, S < T (cross)
]
PA_SHAPES = [
    # B, Np, P, n_max, Hq, Hk, dh
    (3, 16, 8, 4, 8, 2, 64),     # GQA group 4
    (2, 16, 4, 6, 4, 4, 32),     # MHA, small pages
    (4, 32, 8, 8, 8, 8, 64),     # many rows
    (2, 24, 16, 6, 8, 8, 64),    # zamba2's shared block: G 1, page 16
    (2, 16, 4, 6, 4, 4, 96),     # phi-3-vision-4.2b: dh 96
    (2, 16, 4, 6, 24, 2, 192),   # nemotron-4-340b: dh 192, G 12
]
SSD_SHAPES = [
    # B, S, H, P, N, chunk (a subset of tests/test_kernels.py SSD_SHAPES,
    # and the SMOKE chunk)
    (1, 128, 2, 32, 16, 64),
    (1, 256, 1, 128, 32, 256),   # single chunk
    (1, 384, 2, 64, 64, 128),    # 3 chunks
    (2, 96, 3, 16, 32, 32),      # zamba2 SMOKE's chunk
]
SSD_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py's figure


def _qkv(B, S, T, Hq, Hk, dh, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, S, Hq, dh).astype(np.float32),
            r.randn(B, T, Hk, dh).astype(np.float32),
            r.randn(B, T, Hk, dh).astype(np.float32))


def _paged_case(B, Np, P, n_max, Hq, Hk, dh, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(B, Hq, dh).astype(np.float32)
    kp = r.randn(Np, P, Hk, dh).astype(np.float32)
    vp = r.randn(Np, P, Hk, dh).astype(np.float32)
    # distinct pages per row in scrambled order (the fragmented pool)
    ids = np.stack([np.random.RandomState(seed + b).permutation(Np)[:n_max]
                    for b in range(B)]).astype(np.int32)
    pos = r.randint(0, n_max * P, size=B).astype(np.int32)
    return q, kp, vp, ids, pos


def _poison_stale(kp, vp, ids, pos, P):
    """Copies of the pools with every page outside the rows' live
    prefixes set to +-1e9."""
    live = {int(ids[b, j]) for b in range(len(pos))
            for j in range(int(pos[b]) // P + 1)}
    stale = [p for p in range(kp.shape[0]) if p not in live]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[stale], vp2[stale] = 1e9, -1e9
    return kp2, vp2


def _ssd_inputs(B, S, H, P, N, seed=0, decay=0.1):
    """xe, loga = -|normal| * decay, b, c, all float32 (numpy)."""
    r = np.random.RandomState(seed)
    return (r.randn(B, S, H, P).astype(np.float32),
            (-np.abs(r.randn(B, S, H)) * decay).astype(np.float32),
            r.randn(B, S, N).astype(np.float32),
            r.randn(B, S, N).astype(np.float32))


def _t(*arrays, device="cpu", dtype=None):
    out = [torch.from_numpy(a).to(device) for a in arrays]
    return [o.to(dtype) if dtype is not None and o.is_floating_point() else o
            for o in out]


# ---------------------------------------------------------------------------
# plain versions vs the JAX kernels (interpret mode) and oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,T,Hq,Hk,dh,causal,window", FA_SHAPES)
def test_flash_plain_matches_jax(B, S, T, Hq, Hk, dh, causal, window):
    q, k, v = _qkv(B, S, T, Hq, Hk, dh)
    out = FA.reference(*_t(q, k, v), causal=causal, window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = jax_flash(jq, jk, jv, causal=causal, window=window,
                     interpret=True)
    oracle = JR.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(out, np.asarray(kern), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_flash_plain_bf16_matches_jax():
    q, k, v = _qkv(2, 256, 256, 8, 2, 64, seed=1)
    out = FA.reference(*_t(q, k, v, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    kern = jax_flash(*jb, interpret=True)
    oracle = JR.attention_ref(*jb)
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("B,Np,P,n_max,Hq,Hk,dh", PA_SHAPES)
def test_paged_plain_matches_jax(B, Np, P, n_max, Hq, Hk, dh):
    q, kp, vp, ids, pos = _paged_case(B, Np, P, n_max, Hq, Hk, dh)
    out = PA.reference(*_t(q, kp, vp, ids, pos)).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, ids, pos)]
    kern = jax_paged(*args, interpret=True)
    oracle = JR.paged_attention_ref(*args)
    np.testing.assert_allclose(out, np.asarray(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=1e-5, atol=1e-5)


def test_paged_plain_ignores_stale_pages():
    """Pages past a row's position hold +-1e9 and still contribute an exact
    softmax zero: bit-identical to the clean pool, and equal to JAX."""
    B, Np, P, n_max, Hq, Hk, dh = 2, 12, 4, 5, 4, 2, 32
    q, kp, vp, ids, _ = _paged_case(B, Np, P, n_max, Hq, Hk, dh, seed=3)
    pos = np.asarray([P + 1, 2 * P - 1], np.int32)   # 2 pages live each
    clean = PA.reference(*_t(q, kp, vp, ids, pos))
    kp2, vp2 = _poison_stale(kp, vp, ids, pos, P)
    poisoned = PA.reference(*_t(q, kp2, vp2, ids, pos))
    assert torch.equal(clean, poisoned)
    kern = jax_paged(*[jnp.asarray(a) for a in (q, kp2, vp2, ids, pos)],
                     interpret=True)
    np.testing.assert_allclose(poisoned.numpy(), np.asarray(kern),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plain_matches_jax(B, S, H, P, N, chunk):
    """ssd_scan_ref against the Pallas kernel in interpret mode, the JAX
    sequential oracle, and the port's own sequential oracle."""
    args = _ssd_inputs(B, S, H, P, N)
    y, fin = TR.ssd_scan_ref(*_t(*args), chunk)
    ys, fs = TR.ssd_ref(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    jy, jf = jax_ssd(*jargs, chunk=chunk, interpret=True)
    ry, rf = JR.ssd_ref(*jargs)
    assert y.dtype == fin.dtype == torch.float32
    assert tuple(fin.shape) == (B, H, N, P)
    for got, want in ((y, jy), (fin, jf), (y, ry), (fin, rf),
                      (ys.numpy(), ry), (fs.numpy(), rf)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   **SSD_TOL)


def test_ssd_plain_bf16_inputs_widen_exactly():
    """bf16 xe, b and c are widened to fp32 before any arithmetic: the
    result is the fp32 scan of the rounded inputs."""
    args = _t(*_ssd_inputs(1, 64, 2, 16, 16, seed=1))
    xe, loga, b, c = args
    low = [t.bfloat16() for t in (xe, b, c)]
    y, fin = TR.ssd_scan_ref(low[0], loga, low[1], low[2], 32)
    y32, fin32 = TR.ssd_scan_ref(low[0].float(), loga, low[1].float(),
                                 low[2].float(), 32)
    assert torch.equal(y, y32) and torch.equal(fin, fin32)


@pytest.mark.parametrize("S", [64, 256])
def test_ssd_plain_chunk_invariance(S):
    """The chunk is a tiling choice: 32, 64 and 128 (and one chunk, when
    S is shorter than the chunk) give the same scan."""
    args = _t(*_ssd_inputs(1, S, 2, 32, 16, seed=2, decay=0.2))
    y0, f0 = TR.ssd_scan_ref(*args, 32)
    for chunk in (64, 128):
        y, f = TR.ssd_scan_ref(*args, chunk)
        torch.testing.assert_close(y, y0, **SSD_TOL)
        torch.testing.assert_close(f, f0, **SSD_TOL)


def test_ssd_plain_short_sequence_is_one_chunk():
    """S < chunk: Q = S, as in the JAX kernel."""
    args = _ssd_inputs(1, 40, 2, 16, 16, seed=3)
    y, fin = TR.ssd_scan_ref(*_t(*args), 128)
    jy, jf = jax_ssd(*[jnp.asarray(a) for a in args], chunk=128,
                     interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jf), **SSD_TOL)


def test_ssd_refuses_partial_chunks_where_jax_asserts():
    """S 96 at chunk 64: the Pallas kernel asserts a whole number of
    chunks; the port scans the ragged last chunk (32 rows), plain and
    through the wrapper, and matches JAX's sequential oracle."""
    args = _ssd_inputs(1, 96, 1, 16, 16)
    with pytest.raises(AssertionError):
        jax_ssd(*[jnp.asarray(a) for a in args], chunk=64, interpret=True)
    ry, rf = JR.ssd_ref(*[jnp.asarray(a) for a in args])
    for y, fin in (TR.ssd_scan_ref(*_t(*args), 64),
                   ops.ssd_scan(*_t(*args), chunk=64)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SSD_TOL)
        np.testing.assert_allclose(fin.numpy(), np.asarray(rf), **SSD_TOL)


@pytest.mark.parametrize("S", [33, 47, 95, 130])
@pytest.mark.parametrize("chunk", [32, 64])
def test_ssd_plain_ragged_last_chunk_matches_jax_oracle(S, chunk):
    """Any S: the last chunk is S - (nc-1) Q rows, padded exactly (zero
    inputs, zero log decay); y's real rows and the final state match
    JAX's sequential recurrence `ref.ssd_ref`, which takes any S."""
    args = _ssd_inputs(2, S, 3, 16, 32, seed=S, decay=0.3)
    y, fin = TR.ssd_scan_ref(*_t(*args), chunk)
    ry, rf = JR.ssd_ref(*[jnp.asarray(a) for a in args])
    assert tuple(y.shape) == (2, S, 3, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SSD_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(rf), **SSD_TOL)


def test_ssd_plain_strong_decay_is_finite():
    """loga ~ -0.8 a step (the serve path's random weights) drives L to
    about -100 over a 128-step chunk: exp(L_s - L_t) above the diagonal
    would overflow to inf.  The plain scan never takes it there, stays
    finite, matches the sequential oracle and has finite gradients."""
    xe, loga, b, c = _t(*_ssd_inputs(1, 256, 2, 16, 16, seed=4, decay=1.0))
    loga = loga - 0.8
    y, fin = TR.ssd_scan_ref(xe, loga, b, c, 128)
    ys, fs = TR.ssd_ref(xe, loga, b, c)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    torch.testing.assert_close(y, ys, **SSD_TOL)
    torch.testing.assert_close(fin, fs, **SSD_TOL)
    xe.requires_grad_()
    loga.requires_grad_()
    y, fin = TR.ssd_scan_ref(xe, loga, b, c, 128)
    (y.sum() + fin.sum()).backward()
    assert bool(torch.isfinite(xe.grad).all())
    assert bool(torch.isfinite(loga.grad).all())


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------
def test_wrappers_take_plain_path_on_cpu():
    ops.reset_launches()
    q, k, v = _t(*_qkv(1, 64, 64, 4, 2, 32))
    out = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, TR.attention_ref(q, k, v, causal=True))
    pq, kp, vp, ids, pos = _t(*_paged_case(2, 16, 4, 6, 4, 2, 32))
    out = ops.paged_attention(pq, kp, vp, ids, pos)
    assert torch.equal(out, TR.paged_attention_ref(pq, kp, vp, ids, pos))
    assert ops.flash_attention.launches == 0
    assert ops.paged_attention.launches == 0


def test_ssd_wrapper_takes_plain_path_on_cpu():
    ops.reset_launches()
    args = _t(*_ssd_inputs(1, 64, 2, 16, 16))
    y, fin = ops.ssd_scan(*args, chunk=32)
    y0, f0 = TR.ssd_scan_ref(*args, 32)
    assert torch.equal(y, y0) and torch.equal(fin, f0)
    assert ops.ssd_scan.launches == 0


def test_paged_wrapper_crops_block_table():
    """logical_len crops the table to ceil(logical_len / P) pages, as the
    JAX wrapper does; columns past the crop are never read."""
    q, kp, vp, ids, pos = _paged_case(2, 16, 4, 6, 4, 2, 32)
    pos = np.minimum(pos, 9).astype(np.int32)
    full = ops.paged_attention(*_t(q, kp, vp, ids, pos))
    ids2 = ids.copy()
    ids2[:, 3:] = 15   # beyond ceil(10 / 4) = 3 pages
    crop = ops.paged_attention(*_t(q, kp, vp, ids2, pos), logical_len=10)
    np.testing.assert_allclose(crop.numpy(), full.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_flash_wrapper_rejects_ragged_noncausal():
    """The TPU kernel pads keys to its 128-key block, so it refuses a
    non-causal T off the block multiples (padding keys would receive
    weight); the port's kernel masks keys past T and takes any T (the
    whisper encoder's 1500 frames), so its wrapper gives the exact
    softmax over the T keys where the reference raises."""
    q, k, v = _qkv(1, 16, 200, 4, 2, 32)
    with pytest.raises(ValueError, match="non-causal"):
        jax_flash(*map(jnp.asarray, (q, k, v)), causal=False,
                  interpret=True)
    out = ops.flash_attention(*_t(q, k, v), causal=False)
    oracle = JR.attention_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# no backward: autograd through a kernel wrapper raises, on either device,
# as jax.grad through the Pallas kernel does
# ---------------------------------------------------------------------------
def test_jax_cannot_differentiate_through_the_flash_kernel():
    import jax
    from repro.kernels import ops as jax_ops
    q, k, v = (jnp.asarray(a) for a in _qkv(1, 16, 16, 4, 2, 32))
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jax_ops.flash_attention(q, k, v).sum())(q)


def test_flash_wrapper_refuses_autograd():
    import test_torch_bridge as TP
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import attention as TA
    _, tcfg = TP.configs(use_flash_kernel=True)
    q, k, v = _t(*_qkv(1, 16, 16, 4, 2, 32))
    with pytest.raises(RuntimeError, match="no backward"):
        TA.gqa_attend(q.requires_grad_(), k, v, tcfg)
    with torch.no_grad():            # inference through the kernel is fine
        TA.gqa_attend(q, k, v, tcfg)
    _, tp = TP.params(TP.configs()[0])
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(RuntimeError, match="no backward"):
        loss_and_grads(tp, tcfg, batch)
    loss_and_grads(tp, tcfg.with_(use_flash_kernel=False), batch)


def test_paged_wrapper_refuses_autograd():
    import test_torch_bridge as TP
    from repro_torch.models import attention as TA
    from repro_torch.models import model as TMD
    _, tcfg = TP.configs(use_paged_kernel=True)
    _, tp = TP.params(TP.configs()[0])
    lp = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    lp["wq"].requires_grad_()
    pool = TMD.init_paged_cache(tcfg, 2, 8, 4, "cpu")
    x = torch.randn(2, 1, tcfg.d_model)
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    pos = torch.tensor([3, 6], dtype=torch.int32)
    args = (lp, x, pool["k"][0], pool["v"][0], pos, tcfg)
    with pytest.raises(RuntimeError, match="no backward"):
        TA.attention_decode(*args, block_tables=bt, logical_len=16)
    with torch.no_grad():
        TA.attention_decode(*args, block_tables=bt, logical_len=16)
    q, kp, vp, ids, pos = _t(*_paged_case(2, 16, 4, 6, 4, 2, 32))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_attention(q.requires_grad_(), kp, vp, ids, pos)


def test_jax_cannot_differentiate_through_the_ssd_kernel():
    import jax
    from repro.kernels import ops as jax_ops
    xe, loga, b, c = (jnp.asarray(a) for a in _ssd_inputs(1, 32, 1, 16, 16))
    with pytest.raises(AssertionError):
        jax.grad(lambda xe: jax_ops.ssd_scan(xe, loga, b, c,
                                             chunk=32)[0].sum())(xe)


def test_ssd_wrapper_refuses_autograd():
    ops.reset_launches()
    xe, loga, b, c = _t(*_ssd_inputs(1, 32, 1, 16, 16))
    for t in (xe, loga, b, c):
        args = [u.clone().requires_grad_(u is t) for u in (xe, loga, b, c)]
        with pytest.raises(RuntimeError, match="no backward"):
            ops.ssd_scan(*args, chunk=32)
    with torch.no_grad():
        ops.ssd_scan(xe.requires_grad_(), loga, b, c, chunk=32)
    assert ops.ssd_scan.launches == 0


# ---------------------------------------------------------------------------
# the paged kernel's split plan and sizing: plain host arithmetic
# ---------------------------------------------------------------------------
# (B, Hk, n_pages, P) of the serve paths' decode: qwen3-0.6b and
# zamba2-1.2b, 8 slots, cache_len 640, page 16
MAIN_DECODE = {"qwen3-0.6b": (8, 8, 40, 16), "zamba2-1.2b": (8, 32, 40, 16)}


@pytest.mark.parametrize("arch", sorted(MAIN_DECODE))
def test_paged_plan_fills_the_card_at_the_main_shapes(arch):
    B, Hk, n_pages, P = MAIN_DECODE[arch]
    n_splits, span = PA.plan_splits(B, Hk, n_pages, P)
    assert n_splits > 1
    assert n_splits * Hk * B >= PA.TARGET_BLOCKS


@pytest.mark.parametrize("B,Hk,n_pages,P", [
    (8, 8, 40, 16), (8, 32, 40, 16), (1, 1, 1, 16), (1, 2, 300, 16),
    (3, 2, 12, 32), (2, 1, 64, 8), (64, 8, 40, 16), (1, 1, 5000, 1),
    (4, 4, 4, 16), (2, 8, 7, 64)])
def test_paged_plan_covers_every_position_once(B, Hk, n_pages, P):
    """Split s takes positions [s*span*P, (s+1)*span*P) of the table's
    n_pages*P: every position is in exactly one split, no split is empty,
    and a split's table entries fit the kernel's staging."""
    n_splits, span = PA.plan_splits(B, Hk, n_pages, P)
    assert 1 <= span <= PA.MAX_SPAN
    cover = np.zeros(n_pages * P, np.int64)
    for s in range(n_splits):
        lo, hi = s * span * P, min((s + 1) * span * P, n_pages * P)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("n_pages,P", [(1, 16), (4, 16), (2, 32), (8, 8),
                                       (64, 1)])
def test_paged_plan_keeps_short_rows_in_one_split(n_pages, P):
    """A table of at most MIN_SPLIT_POSITIONS positions is one split, so
    no merge pass runs, however few blocks that gives."""
    assert n_pages * P <= PA.MIN_SPLIT_POSITIONS
    assert PA.plan_splits(1, 1, n_pages, P)[0] == 1


@pytest.mark.parametrize("dh", PA.HEAD_DIMS)
@pytest.mark.parametrize("G", PA.GROUPS)
@pytest.mark.parametrize("P", [1, 8, 16, 32, 128])
def test_paged_sizing_fits_every_accepted_shape(dh, G, P):
    """Every head dim and group the wrapper accepts fits the 48 KB of
    static shared memory, for any page size (the table staging is sized
    by MAX_SPAN pages, not by P); the workspace holds acc, m and l for
    every (row, q-head, split) and is empty with one split."""
    assert PA.smem_bytes(dh, G) <= PA._SMEM_LIMIT
    B, Hk = 8, 2
    n_splits, span = PA.plan_splits(B, Hk, 40, P)
    Hq = Hk * G
    n = PA.workspace_numel(B, Hq, dh, n_splits)
    if n_splits == 1:
        assert n == 0
    else:
        assert n == B * Hq * n_splits * (dh + 2)
    assert PA.workspace_numel(B, Hq, dh, 1) == 0
