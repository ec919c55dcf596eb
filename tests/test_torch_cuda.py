"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card every test skips (decided inside the test)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import nat_compress as NC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402

pytestmark = pytest.mark.gpu

FA_SHAPES = [
    # B, S, T, Hq, Hk, dh, causal, window
    (1, 200, 200, 16, 8, 128, True, None),   # qwen3-0.6b prefill, ragged
    (1, 512, 512, 16, 8, 128, True, None),
    (2, 256, 256, 8, 4, 64, True, 128),      # sliding window
    (1, 128, 384, 4, 4, 128, True, None),    # S < T (suffix)
    (2, 128, 128, 4, 2, 64, False, None),    # non-causal
    (1, 37, 37, 4, 2, 32, True, None),       # tiny, ragged, head_dim 32
    (1, 384, 384, 32, 32, 64, True, None),   # zamba2-1.2b prefill: G 1
    (1, 300, 300, 32, 4, 128, True, None),   # qwen3-moe-30b-a3b: G 8
    (1, 257, 257, 32, 32, 128, True, None),  # deepseek-7b: G 1, dh 128
    (1, 512, 512, 56, 8, 128, True, None),   # arctic-480b: G 7
    (1, 65, 130, 14, 2, 64, True, None),     # G 7, S < T, ragged tiles
    (1, 1500, 1500, 6, 6, 64, False, None),  # whisper-tiny encoder
    (1, 300, 1500, 6, 6, 64, False, None),   # whisper-tiny cross prefill
    (1, 592, 592, 32, 32, 96, True, None),   # phi-3-vision-4.2b: dh 96
    (1, 512, 512, 96, 8, 192, True, None),   # nemotron-4-340b: dh 192, G 12
]
PA_SHAPES = [
    # B, Np, P, n_max, Hq, Hk, dh
    (8, 400, 16, 40, 16, 8, 128),            # qwen3-0.6b decode, 8 slots
    (3, 16, 8, 4, 8, 2, 64),
    (2, 16, 4, 4, 4, 4, 32),
    (4, 32, 8, 8, 8, 8, 64),
    (8, 320, 16, 40, 32, 32, 64),            # zamba2-1.2b decode: G 1
    (8, 321, 16, 40, 32, 4, 128),            # qwen3-moe-30b-a3b: G 8
    (8, 321, 16, 40, 32, 32, 128),           # deepseek-7b: G 1, dh 128
    (8, 321, 16, 40, 56, 8, 128),            # arctic-480b: G 7
    (3, 40, 8, 12, 14, 2, 64),               # G 7, dh 64
    (8, 321, 16, 40, 6, 6, 64),              # whisper-tiny decode
    (8, 321, 16, 40, 32, 32, 96),            # phi-3-vision-4.2b: dh 96
    (8, 321, 16, 40, 96, 8, 192),            # nemotron-4-340b: G 12
]
# the bf16 kernel's 64-row query and 64-key tiles: S and T at the tile
# edges, a single query row, S < T, windows and full masking, every head
# dim and group, in both dtypes
FA_EDGE_SHAPES = [
    (1, 1, 64, 4, 4, 64, True, None),        # one query row, G 1
    (1, 63, 63, 8, 4, 128, True, None),
    (1, 64, 64, 8, 2, 64, True, None),       # G 4
    (1, 65, 65, 4, 4, 32, True, None),
    (2, 129, 129, 8, 2, 128, True, None),
    (1, 65, 200, 8, 4, 64, True, None),      # S < T, ragged T
    (1, 129, 129, 8, 2, 32, True, 40),       # window inside a tile
    (1, 100, 192, 8, 8, 128, True, 64),      # window, S < T
    (1, 64, 256, 4, 2, 128, False, None),    # non-causal, S < T
    (2, 33, 64, 4, 1, 64, False, None),      # non-causal, G 4
]
# paged: (B, P, n_max, Hq, Hk, dh); plan_splits gives each its split
# count, and the rows' positions sit at the edges of the splits
PA_SPLIT_SHAPES = [
    (8, 16, 40, 16, 8, 128),                 # qwen3-0.6b: 5 splits of 8
    (8, 16, 40, 32, 32, 64),                 # zamba2-1.2b: 2 splits of 20
    (4, 16, 4, 4, 4, 128),                   # 64 positions: one split
    (2, 8, 64, 8, 1, 64),                    # G 8, P 8
    (3, 32, 12, 8, 2, 32),                   # G 4, P 32
    (1, 16, 300, 2, 2, 64),                  # many splits of 4 pages
    (6, 8, 20, 4, 2, 128),                   # G 2, P 8
    (8, 16, 40, 56, 8, 128),                 # arctic-480b: G 7
    (3, 8, 24, 7, 1, 32),                    # G 7, dh 32, P 8
    (8, 16, 40, 32, 32, 96),                 # phi-3-vision-4.2b: dh 96
    (8, 16, 40, 96, 8, 192),                 # nemotron-4-340b: G 12
    (3, 8, 24, 12, 1, 96),                   # G 12, dh 96, P 8
]
SSD_SHAPES = [
    # B, S, H, P, N, chunk: tests/test_kernels.py's, then zamba2-1.2b's
    # prefill, a short prompt (S < chunk), SMOKE's chunk, and ragged last
    # chunks (a preempted request's re-prefill)
    (2, 256, 4, 64, 64, 128),
    (1, 128, 2, 32, 16, 64),
    (2, 512, 3, 64, 64, 128),
    (1, 256, 1, 128, 32, 256),
    (1, 384, 2, 64, 64, 128),
    (1, 512, 64, 64, 64, 128),
    (2, 40, 4, 16, 128, 128),
    (1, 96, 4, 64, 64, 32),
    (1, 500, 64, 64, 64, 128),
    (2, 130, 4, 64, 64, 128),
    (1, 17, 2, 16, 16, 32),
]
SSD_TOL = 1e-4
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _paged_case(B, Np, P, n_max, Hq, Hk, dh, dtype, seed=0):
    """Scrambled page ids, disjoint across rows; every page outside the
    rows' live prefixes poisoned with +-1e9."""
    r = np.random.RandomState(seed)
    q = r.randn(B, Hq, dh).astype(np.float32)
    kp = r.randn(Np, P, Hk, dh).astype(np.float32)
    vp = r.randn(Np, P, Hk, dh).astype(np.float32)
    ids = r.permutation(Np)[:B * n_max].reshape(B, n_max).astype(np.int32)
    pos = r.randint(0, n_max * P, size=B).astype(np.int32)
    live = {int(ids[b, j]) for b in range(B)
            for j in range(int(pos[b]) // P + 1)}
    stale = [p for p in range(Np) if p not in live]
    kp[stale], vp[stale] = 1e9, -1e9
    f = [torch.from_numpy(a).cuda().to(dtype) for a in (q, kp, vp)]
    return f + [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,Hq,Hk,dh,causal,window", FA_SHAPES)
def test_flash_kernel_matches_plain(B, S, T, Hq, Hk, dh, causal, window,
                                    dtype):
    _cuda()
    dt, tol = getattr(torch, dtype), TOL[dtype]
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").to(dt)
    k = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
    v = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = FA.reference(q, k, v, causal=causal, window=window)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Np,P,n_max,Hq,Hk,dh", PA_SHAPES)
def test_paged_kernel_matches_plain(B, Np, P, n_max, Hq, Hk, dh, dtype):
    _cuda()
    tol = TOL[dtype]
    args = _paged_case(B, Np, P, n_max, Hq, Hk, dh, getattr(torch, dtype))
    out = PA.paged_attention(*args)
    torch.cuda.synchronize()
    ref = PA.reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,Hq,Hk,dh,causal,window", FA_EDGE_SHAPES)
def test_flash_kernel_tile_edges(B, S, T, Hq, Hk, dh, causal, window,
                                 dtype):
    test_flash_kernel_matches_plain(B, S, T, Hq, Hk, dh, causal, window,
                                    dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 64, 128, 96, 192])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8, 12])
def test_flash_kernel_head_dims_and_groups(dh, G, dtype):
    test_flash_kernel_matches_plain(1, 129, 129, 2 * G, 2, dh, True, None,
                                    dtype)


def _split_case(B, P, n_max, Hq, Hk, dh, dtype, seed=0):
    """Rows of very different lengths on scrambled pages, positions at the
    split edges, one row at pos -1 where there is room; every page outside
    the live prefixes poisoned with +-1e9.  Returns (args, clean pools)."""
    r = np.random.RandomState(seed)
    Np = B * n_max + 4
    n_splits, span = PA.plan_splits(B, Hk, n_max, P)
    w = span * P
    last = n_max * P - 1
    edges = [0, w - 1, w, w + 1, last, -1, r.randint(0, last + 1),
             min(last, 2 * w + 1)]
    pos = np.array([min(last, edges[b % len(edges)]) for b in range(B)],
                   dtype=np.int32)
    if B == 1:
        pos[0] = last
    q = r.randn(B, Hq, dh).astype(np.float32)
    kp = r.randn(Np, P, Hk, dh).astype(np.float32)
    vp = r.randn(Np, P, Hk, dh).astype(np.float32)
    ids = r.permutation(Np)[:B * n_max].reshape(B, n_max).astype(np.int32)
    live = {int(ids[b, j]) for b in range(B)
            for j in range(int(pos[b]) // P + 1)}
    stale = [p for p in range(Np) if p not in live]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[stale], vp2[stale] = 1e9, -1e9
    cuda = [torch.from_numpy(a).cuda().to(dtype) for a in (q, kp2, vp2, kp,
                                                           vp)]
    ints = [torch.from_numpy(a).cuda() for a in (ids, pos)]
    return (cuda[0], cuda[1], cuda[2], *ints), (cuda[3], cuda[4]), n_splits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,P,n_max,Hq,Hk,dh", PA_SPLIT_SHAPES)
def test_paged_kernel_split_edges(B, P, n_max, Hq, Hk, dh, dtype):
    """Every split count the planner gives these shapes: positions at the
    split edges match the plain version, a row at pos -1 emits 0, and the
    poisoned stale pages leave the output bit for bit unchanged."""
    _cuda()
    args, (kp, vp), n_splits = _split_case(B, P, n_max, Hq, Hk, dh,
                                           getattr(torch, dtype))
    out = PA.paged_attention(*args)
    clean = PA.paged_attention(args[0], kp, vp, *args[3:])
    torch.cuda.synchronize()
    assert torch.equal(out, clean), f"{n_splits} splits: stale pages leaked"
    pos = args[4]
    dead = pos < 0
    assert bool((out[dead] == 0).all())
    ref = PA.reference(*args)
    tol = TOL[dtype]
    torch.testing.assert_close(out[~dead].float(), ref[~dead].float(),
                               rtol=tol, atol=tol)


def test_attention_kernels_are_deterministic():
    """Two identical calls give bit-identical outputs: the paged splits
    merge in a fixed order, without atomics."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        wide = torch.int16 if dtype == torch.bfloat16 else torch.int32
        q = torch.randn(1, 512, 16, 128, generator=g, device="cuda").to(dtype)
        k = torch.randn(1, 512, 8, 128, generator=g, device="cuda").to(dtype)
        v = torch.randn(1, 512, 8, 128, generator=g, device="cuda").to(dtype)
        a = FA.flash_attention(q, k, v)
        b = FA.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert torch.equal(a.view(wide), b.view(wide))
        args, _, n_splits = _split_case(8, 16, 40, 16, 8, 128, dtype)
        assert n_splits > 1
        a = PA.paged_attention(*args)
        b = PA.paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(a.view(wide), b.view(wide))


def _ssd_case(B, S, H, P, N, dtype, seed=0, decay=0.1):
    """xe, b, c in `dtype`; loga = -|normal| * decay in float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xe = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
    loga = -torch.randn(B, S, H, generator=g, device="cuda").abs() * decay
    b = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    c = torch.randn(B, S, N, generator=g, device="cuda").to(dtype)
    return xe, loga, b, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(B, S, H, P, N, chunk, dtype):
    """Both versions compute in fp32 from the same (rounded) inputs, so
    bf16 inputs are held to the fp32 figure too."""
    _cuda()
    args = _ssd_case(B, S, H, P, N, getattr(torch, dtype), seed=S + N)
    y, fin = SS.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    yr, fr = SS.reference(*args, chunk)
    assert y.dtype == fin.dtype == torch.float32
    torch.testing.assert_close(y, yr, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(fin, fr, rtol=SSD_TOL, atol=SSD_TOL)
    y2, fin2 = SS.ssd_scan(*args, chunk=chunk)   # no atomics: bit-identical
    assert torch.equal(y, y2) and torch.equal(fin, fin2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_tile(dtype):
    """The kernel picks its own tile: the requested chunk up to 128,
    halved only where a pass's shared memory would pass the H100's 227 KB
    (fp32 inputs take three bf16 planes).  At P = N = 128 fp32 inputs scan
    in tiles of 32, and the result is the scan of the requested chunk."""
    _cuda()
    lib = build.load("ssd_scan")
    code = SS._DTYPES[getattr(torch, dtype)]
    fp32 = dtype == "float32"
    assert lib.ssd_scan_tile(40, 16, 128, code) == 40
    assert lib.ssd_scan_tile(256, 64, 64, code) == 128
    assert lib.ssd_scan_tile(256, 128, 128, code) == (32 if fp32 else 128)
    assert lib.ssd_scan_tile(257, 64, 64, code) == 0
    assert lib.ssd_scan_tile(128, 64, 48, code) == 0
    for Q in (1, 17, 40, 64, 128, 256):
        for N in SS.WIDTHS:
            for P in SS.WIDTHS:
                assert 1 <= lib.ssd_scan_tile(Q, P, N, code) <= min(Q, 128)
    args = _ssd_case(1, 300, 2, 128, 128, getattr(torch, dtype), seed=7)
    y, fin = SS.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    yr, fr = SS.reference(*args, 256)
    torch.testing.assert_close(y, yr, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(fin, fr, rtol=SSD_TOL, atol=SSD_TOL)


def _ssd_f64(xe, loga, b, c):
    """The sequential recurrence in float64: the exact answer to ~1e-12."""
    xe, loga, b, c = xe.double(), loga.double(), b.double(), c.double()
    state = torch.zeros(xe.shape[0], xe.shape[2], b.shape[-1], xe.shape[3],
                        dtype=torch.float64, device=xe.device)
    ys = []
    for t in range(xe.shape[1]):
        state = (state * loga[:, t].exp()[..., None, None]
                 + torch.einsum("bn,bhp->bhnp", b[:, t], xe[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], state))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("S", [512, 500])
def test_ssd_kernel_strong_decay_is_finite(S):
    """loga ~ -0.8 a step, as zamba2's random weights give: L falls to about
    -120 over a 128-step chunk, where exp(L_s - L_t) above the diagonal is
    inf in fp32.  The kernel never takes it there: no NaN, no inf; and it
    holds to its plain version and to the float64 recurrence, also with a
    ragged last chunk (S 500)."""
    _cuda()
    xe, loga, b, c = _ssd_case(1, S, 64, 64, 64, torch.bfloat16, seed=3,
                               decay=0.2)
    loga = loga - 0.8
    y, fin = SS.ssd_scan(xe, loga, b, c, chunk=128)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    for yr, fr in (SS.reference(xe, loga, b, c, 128),
                   _ssd_f64(xe, loga, b, c)):
        torch.testing.assert_close(y.double(), yr.double(), rtol=SSD_TOL,
                                   atol=SSD_TOL)
        torch.testing.assert_close(fin.double(), fr.double(), rtol=SSD_TOL,
                                   atol=SSD_TOL)


def test_ssd_kernel_matches_sequential_oracle():
    _cuda()
    args = _ssd_case(1, 64, 2, 16, 16, torch.float32, seed=5)
    y, fin = SS.ssd_scan(*args, chunk=32)
    yr, fr = TR.ssd_ref(*args)
    torch.testing.assert_close(y, yr, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(fin, fr, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_kernel_refuses_what_it_does_not_take():
    """The wrapper raises before a launch on shapes the kernel does not
    take; a bare launch at a chunk the kernel refuses (above 256: its
    `ssd_scan_tile` gives 0) raises, and nothing is counted.  S 500,
    which the JAX package refuses at chunk 128, runs (a ragged last
    chunk)."""
    _cuda()
    ops.reset_launches()
    xe, loga, b, c = _ssd_case(1, 512, 2, 64, 48, torch.float32)
    with pytest.raises(ValueError, match="state 48"):
        ops.ssd_scan(xe, loga, b, c)
    xe, loga, b, c = _ssd_case(1, 512, 2, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="chunk 512"):
        ops.ssd_scan(xe, loga, b, c, chunk=512)
    ragged = [t[:, :500].contiguous() for t in (xe, loga, b, c)]
    y, fin = SS.ssd_scan(*ragged)      # S 500: a ragged last chunk, taken
    yr, fr = SS.reference(*ragged)
    torch.testing.assert_close(y, yr, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(fin, fr, rtol=SSD_TOL, atol=SSD_TOL)
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd_scan(xe, loga, b.bfloat16(), c)
    y = torch.empty_like(xe)
    fin = torch.empty(1, 2, 64, 64, device="cuda")
    with pytest.raises(RuntimeError, match="kernel refuses chunk 512"):
        SS.launch(xe, loga, b, c, y, fin, 512)
    assert ops.ssd_scan.launches == 0


def test_kernels_reject_what_they_do_not_take():
    _cuda()
    q = torch.zeros(1, 8, 4, 48, device="cuda")   # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 8, 4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention(q, q[:, :, :2].contiguous(),
                           q[:, :, :2].contiguous())


def test_wrappers_count_kernel_launches():
    _cuda()
    ops.reset_launches()
    q = torch.randn(1, 64, 4, 64, device="cuda")
    k = torch.randn(1, 64, 2, 64, device="cuda")
    ops.flash_attention(q, k, k)
    ops.paged_attention(*_paged_case(2, 16, 4, 4, 4, 4, 32, torch.float32))
    ops.nc_roundtrip(q, torch.rand_like(q))
    ops.ssd_scan(*_ssd_case(1, 64, 2, 16, 16, torch.float32), chunk=32)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == 1
    assert ops.paged_attention.launches == 1
    assert ops.ssd_scan.launches == 1
    assert ops.nc_pack.launches == 1 and ops.nc_unpack.launches == 1


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _nc_inputs(n, dtype, seed):
    """Normal draws over 16 decades, with zeros, +-powers of two, their
    float predecessors, and values below 2^-69 and at or above 2^57."""
    r = np.random.RandomState(seed)
    x = (r.randn(n) * 10.0 ** r.randint(-12, 4, n)).astype(np.float32)
    pw = np.exp2(np.arange(-75, 64, 3)).astype(np.float32)
    edge = np.concatenate([np.zeros(4, np.float32), pw,
                           np.nextafter(pw, np.float32(0)),
                           np.float32([2.0 ** -80, 1e-30, 1e-40, 2.0 ** 57,
                                       2.0 ** 60, 3e30])])
    edge = np.concatenate([edge, -edge])
    k = min(n, edge.size)
    x[r.permutation(n)[:k]] = edge[:k]
    u = r.rand(n).astype(np.float32)
    u[:2] = np.float32([0.0, 1.0 - 2.0 ** -24])[:n]
    return (torch.from_numpy(x).cuda().to(dtype),
            torch.from_numpy(u).cuda())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 127, 1001, 65537])
@pytest.mark.parametrize("offset", [0, 1])
def test_nc_kernels_match_plain_bit_for_bit(n, dtype, offset):
    """Codes and unpacked values equal to the plain versions', bit for
    bit; offset 1 (a view one element in) takes the kernels' unaligned
    path, for pack's inputs and for unpack's codes."""
    _cuda()
    x, u = _nc_inputs(n + offset, getattr(torch, dtype), seed=n)
    x, u = x[offset:], u[offset:]
    codes = NC.nc_pack(x, u)
    torch.cuda.synchronize()
    assert torch.equal(codes, NC.pack_reference(x, u))
    for out in (torch.float32, torch.bfloat16):
        y = NC.nc_unpack(codes[offset:], out)
        torch.cuda.synchronize()
        assert torch.equal(_bits(y), _bits(NC.unpack_reference(codes[offset:],
                                                               out)))


def test_flash_kernel_refuses_autograd_on_the_card():
    _cuda()
    q = torch.randn(1, 64, 4, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device="cuda")
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    assert ops.flash_attention.launches == 0
    with torch.no_grad():
        ops.flash_attention(q, k, k)
    assert ops.flash_attention.launches == 1


# ---------------------------------------------------------------------------
# the serving paths of the speculative and migration slice
# ---------------------------------------------------------------------------
def _verify_layer(device, dtype, seed=0, arch="qwen3-1.7b"):
    """One attention layer at `arch`'s heads (qwen3-1.7b: 16/8 of 128;
    arctic-480b: 56/8 of 128, G 7), d_model cut to 256, over a paged
    pool: 8 rows x S 4 candidates, page 16, 40-page tables on scrambled
    pages, the rows' positions at the edges of the
    kernel's splits for 32 query rows (and one row whose last candidates
    pass the cache); every page outside the rows' live prefixes poisoned
    with +-1e9.  Returns (cfg, params, x, pos, bt, poisoned, clean)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.common import init_params
    from repro_torch.models import model as MD
    dt = getattr(torch, dtype)
    cfg = get_config(arch).with_(
        d_model=256, num_layers=1, param_dtype=dtype, compute_dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    p = init_params(A.attn_descs(cfg), g, torch.device(device))
    Bv, S, P, n_max = 8, 4, 16, 40
    Np = Bv * n_max + 4
    _, span = PA.plan_splits(Bv * S, cfg.num_kv_heads, n_max, P)
    w, C = span * P, n_max * P
    pos = torch.tensor([0, w - 3, w - 1, w, w + 1, C - 4, C - 2, 100],
                       dtype=torch.int32)
    r = np.random.RandomState(seed)
    ids = r.permutation(Np)[:Bv * n_max].reshape(Bv, n_max)
    pool = MD.init_paged_cache(cfg, Bv, Np, P, device)
    for n in pool:
        pool[n].copy_(torch.randn(pool[n].shape, generator=g,
                                  device=device).to(dt))
    live = {int(ids[b, j]) for b in range(Bv)
            for j in range(min(n_max, (int(pos[b]) + S - 1) // P + 1))}
    stale = [q for q in range(Np) if q not in live]
    poisoned = {n: t.clone() for n, t in pool.items()}
    for n, v in (("k", 1e9), ("v", -1e9)):
        poisoned[n][:, stale] = v
    x = torch.randn(Bv, S, cfg.d_model, generator=g, device=device).to(dt)
    bt = torch.from_numpy(ids.astype(np.int32)).to(device)
    return cfg, p, x, pos.to(device), bt, poisoned, pool


def _attention_verify_kernel_vs_plain(device, dtype, arch="qwen3-1.7b"):
    from repro_torch.models import attention as A
    cfg, p, x, pos, bt, poisoned, clean = _verify_layer(device, dtype,
                                                        arch=arch)
    C = bt.shape[1] * clean["k"].shape[2]
    kcfg = cfg.with_(use_paged_kernel=True)
    ops.reset_launches()
    outs = {}
    for name, c, pools in (("kernel", kcfg, poisoned),
                           ("kernel_clean", kcfg, clean),
                           ("plain", cfg, {n: t.clone()
                                           for n, t in clean.items()})):
        y, nk, nv = A.attention_verify(p, x, pools["k"][0], pools["v"][0],
                                       pos, c, block_tables=bt,
                                       logical_len=C)
        outs[name] = (y, nk, nv)
    launches = ops.paged_attention.launches
    # the stale pages are invisible bit for bit; both paths write the same
    # candidates into the same pages (the trash page, which nothing reads,
    # apart)
    assert torch.equal(outs["kernel"][0], outs["kernel_clean"][0])
    for i in (1, 2):
        assert torch.equal(outs["kernel_clean"][i][:-1], outs["plain"][i][:-1])
    return outs["kernel"][0], outs["plain"][0], launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_verify_paged_kernel_matches_plain(dtype):
    """attention_verify through the paged kernel (one launch of 32 query
    rows) against the plain gather-and-softmax on the same pools."""
    _cuda()
    y, ref, launches = _attention_verify_kernel_vs_plain("cuda", dtype)
    assert launches == 2
    tol = TOL[dtype] * max(1.0, float(ref.float().abs().max()))
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_verify_paged_kernel_at_group_7(dtype):
    """The same at arctic-480b's heads (56/8, G 7): 32 verify rows."""
    _cuda()
    y, ref, launches = _attention_verify_kernel_vs_plain(
        "cuda", dtype, arch="arctic-480b")
    assert launches == 2
    tol = TOL[dtype] * max(1.0, float(ref.float().abs().max()))
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=tol)


def _harvest_round_trip(arch, device):
    """A paged engine (bf16 on the card, the kernels on) drained after a
    few ticks; the continuations installed on a second engine, whose
    pages and rows are read back right after each install and must equal
    the harvest bit for bit.  Returns (harvested, installs checked, the
    second engine, stitched outputs, the requests)."""
    from repro_torch.configs import get_config
    from repro_torch.elastic import ServingDrainReadmit
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serving import Request, ServeEngine
    cfg = get_config(arch, smoke=True)
    if device == "cuda":
        cfg = cfg.with_(param_dtype="bfloat16", compute_dtype="bfloat16",
                        use_flash_kernel=True, use_paged_kernel=True,
                        use_ssd_kernel=True)
    params = MD.init_model(cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, size=n),
                    max_new_tokens=12) for i, n in enumerate((9, 14, 6, 11))]

    def engine():
        return ServeEngine(params, cfg, num_slots=2, cache_len=28,
                           page_size=4, device=device)

    a = engine()
    for q in reqs:
        a.submit(q)
    for _ in range(3):
        a.tick()
    drained = a.drain()
    harvested = [d for d in drained if d.kv is not None]
    b = engine()
    checked = []
    install = b._admit_migrated

    def read_back(req, slot):
        install(req, slot)
        kv = req.kv_seed
        ids = torch.as_tensor(b.pages.owned[slot], dtype=torch.long,
                              device=b.device)
        for n, pages in kv.pages.items():
            held = b.cache[n][:, ids[:pages.shape[1]]].cpu()
            assert torch.equal(_bits(held), _bits(pages)), (req.rid, n)
        rows = {n: tree_map(lambda t: t[:, slot].cpu(), b.cache[n])
                for n in kv.rows}
        for h, r in zip(tree_leaves(rows), tree_leaves(kv.rows)):
            assert torch.equal(_bits(h), _bits(r)), req.rid
        checked.append(req.rid)
    b._admit_migrated = read_back
    policy = ServingDrainReadmit()
    out = {f.rid: f.tokens for f in a.finished}
    for f in b.run(policy.readmit(drained)):
        out[f.rid] = policy.stitch(f).tokens
    return harvested, checked, b, out, reqs


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_harvest_install_round_trip_on_card(arch):
    """Harvested bf16 pages and rows survive the host round trip and the
    install bit for bit; migrated admits run no prefill; every request
    finishes with its full budget."""
    _cuda()
    harvested, checked, b, out, reqs = _harvest_round_trip(arch, "cuda")
    assert len(harvested) == 2
    assert sorted(checked) == sorted(d.request.rid for d in harvested)
    assert b.migrated_admits == len(harvested)
    assert all(len(out[r.rid]) == r.max_new_tokens for r in reqs)


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------
def _routed(M, fn, force=None):
    """fn() with each MoE layer's chosen experts recorded; with `force`
    (another run's choices) every layer takes those experts instead,
    gated by its own router."""
    chosen = []
    top_k = M.top_k

    def pick(probs, k):
        if force is None:
            gates, idx = top_k(probs, k)
        else:
            idx = force[len(chosen)]
            gates = probs.gather(-1, idx)
        chosen.append(idx)
        return gates, idx
    M.top_k = pick
    try:
        return fn(), chosen
    finally:
        M.top_k = top_k


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_tick_kernel_path_matches_plain(arch, dtype):
    """A MoE SMOKE model on the card: two prompts prefilled onto scrambled
    pages (the flash kernel, one launch a layer), then one paged decode
    tick (the paged kernel, one launch a layer), against the same with
    the kernel flags off and the kernel path's expert choices (a bf16
    router near-tie may flip a choice, which is no kernel error): logits
    within the tolerance of their dtype times max(1, max|logit|).  In
    fp32 the plain path's own routing is the kernel path's."""
    _cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import mlp as M
    from repro_torch.models import model as MD
    plain = get_config(arch, smoke=True).with_(param_dtype=dtype,
                                               compute_dtype=dtype)
    kern = plain.with_(use_flash_kernel=True, use_paged_kernel=True)
    params = MD.init_model(plain, torch.Generator(device="cuda")
                           .manual_seed(0))
    r = np.random.RandomState(1)
    P, n_max = 4, 8
    ids = torch.from_numpy(r.permutation(2 * n_max).reshape(2, n_max)
                           .astype(np.int32)).cuda()
    prompts = [r.randint(0, plain.vocab_size, size=n) for n in (13, 21)]
    pool = MD.init_paged_cache(kern, 2, 2 * n_max, P, "cuda")
    toks, pos = [], []
    ops.reset_launches()
    for b, pr in enumerate(prompts):
        npg = -(-(len(pr) + 1) // P)
        lg, _, c = MD.forward(params, kern, torch.from_numpy(pr).cuda()[None],
                              return_cache=True, cache_len=npg * P)
        MD.write_paged_cache(pool, c, b, ids[b, :npg], kern)
        toks.append(int(lg[0, -1].argmax()))
        pos.append(len(pr))
    pools = [{n: t.clone() for n, t in pool.items()} for _ in range(2)]

    def decode(cfg, cache, force=None):
        return _routed(M, lambda: MD.decode_step(
            params, cfg, torch.tensor(toks, device="cuda",
                                      dtype=torch.int32)[:, None],
            torch.tensor(pos, device="cuda", dtype=torch.int32), cache,
            active=torch.ones(2, dtype=torch.bool, device="cuda"),
            block_tables=ids, logical_len=n_max * P)[0], force)
    lk, chosen = decode(kern, pool)
    torch.cuda.synchronize()
    L = plain.num_layers
    assert (ops.flash_attention.launches, ops.paged_attention.launches) \
        == (2 * L, L)
    lp, own = decode(plain, pools[0])
    lf, _ = decode(plain, pools[1], chosen)
    assert (ops.flash_attention.launches, ops.paged_attention.launches) \
        == (2 * L, L)
    assert len(chosen) == len(own) == L
    if dtype == "float32":
        assert all(torch.equal(a, b) for a, b in zip(chosen, own))
        assert torch.equal(lp, lf)
    scale = max(1.0, float(lf.float().abs().max()))
    torch.testing.assert_close(lk.float(), lf.float(), rtol=0,
                               atol=TOL[dtype] * scale)


# ---------------------------------------------------------------------------
# obs, asynchronous checkpoints, the other families' train steps
# ---------------------------------------------------------------------------
def test_recorded_serve_event_counts_on_card(tmp_path):
    """A SMOKE qwen3 stream through the kernels on a paged pool tight
    enough to preempt, recorded and unrecorded: the same streams; one
    request span a request, one serve.admit an admit (re-admits
    included), one serve.preempt a preemption, a first token for every
    request (again for a re-admit, whose tokens count afresh, as in the
    JAX engine) and at most one an admit; the trace parses back with
    every event."""
    _cuda()
    import json
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.serving import Request, ServeEngine
    cfg = get_config("qwen3-0.6b", smoke=True).with_(
        use_flash_kernel=True, use_paged_kernel=True)
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    r = np.random.RandomState(3)
    reqs = [(i, r.randint(0, cfg.vocab_size, size=int(r.choice((5, 8)))),
             int(r.choice((8, 12)))) for i in range(6)]

    def run(rec):
        eng = ServeEngine(params, cfg, num_slots=2, cache_len=24,
                          page_size=4, num_pages=6, device="cuda")
        with obs.recording(rec):
            fins = eng.run([Request(rid=i, prompt=p, max_new_tokens=g)
                            for i, p, g in reqs])
        return [f.tokens for f in fins], eng.stats()
    off, _ = run(None)
    rec = obs.Recorder()
    on, st = run(rec)
    assert on == off and st["preemptions"] >= 1
    names = [e.name for e in rec.events]
    assert sorted(e.args["rid"] for e in rec.events
                  if e.name == "request") == list(range(6))
    assert {e.args["rid"] for e in rec.events
            if e.name == "serve.first_token"} == set(range(6))
    assert names.count("serve.first_token") <= st["prefill_ticks"]
    assert names.count("serve.admit") == st["prefill_ticks"]
    assert names.count("serve.preempt") == st["preemptions"]
    path = obs.write_trace(tmp_path / "trace.json", rec.events)
    back = json.load(open(path))["traceEvents"]
    assert len([e for e in back if e["ph"] != "M"]) == len(rec.events)


def test_async_save_restores_cuda_tensors_bit_equal(tmp_path):
    """bf16, fp32 and int32 leaves on the card: the save sees them as they
    were when it returned, though they are overwritten in place while the
    writer works; the restore lands on the card bit-equal."""
    _cuda()
    import threading
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(257, 129, generator=g, device="cuda"),
            "b": torch.randn(1000, generator=g, device="cuda").bfloat16(),
            "opt": {"step": torch.tensor(7, dtype=torch.int32,
                                         device="cuda")}}
    kept = {"w": tree["w"].clone(), "b": tree["b"].clone(),
            "opt": {"step": tree["opt"]["step"].clone()}}
    gate = threading.Event()
    ck = AsyncCheckpointer(str(tmp_path), failpoint=lambda name: (
        gate.wait(10) if name == "before_write" else None))
    ck.save(7, tree)
    tree["w"].mul_(2)
    tree["b"].add_(1)
    tree["opt"]["step"].add_(1)
    gate.set()
    ck.wait()
    ck.close()
    like = {"w": torch.zeros_like(kept["w"]), "b": torch.zeros_like(
        kept["b"]), "opt": {"step": torch.zeros_like(kept["opt"]["step"])}}
    back, _ = restore_checkpoint(str(tmp_path), like)
    for k in ("w", "b"):
        assert back[k].device.type == "cuda" and back[k].dtype == kept[k].dtype
        assert torch.equal(back[k].view(torch.int16 if k == "b" else
                                        torch.int32),
                           kept[k].view(torch.int16 if k == "b" else
                                        torch.int32))
    assert int(back["opt"]["step"]) == 7


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b",
                                  "whisper-tiny", "phi-3-vision-4.2b",
                                  "qwen3-moe-30b-a3b"])
def test_compressed_train_step_of_each_family(arch):
    """One compressed train step (in place) of each family at SMOKE in bf16
    on the card: a finite loss, one nc_pack and one nc_unpack launch a
    gradient leaf, no attention or scan kernel (they have no backward);
    and the same gradients and uniforms through the kernels and the
    plain versions bit-identical."""
    _cuda()
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (loss_and_grads, make_extra,
                                          make_train_step)
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw, warmup_cosine
    cfg = get_config(arch, smoke=True).with_(param_dtype="bfloat16",
                                             compute_dtype="bfloat16")
    params = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(warmup_cosine(3e-3, 2, 4))
    state = opt.init(params)
    r = np.random.RandomState(0)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 65))
                            .astype(np.int32)).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    extra = make_extra(cfg, 2, torch.device("cuda"))
    if extra is not None:
        batch["extra_embeds"] = extra
    step = make_train_step(cfg, opt, compress_grads=True)
    ops.reset_launches()
    _, _, m = step(params, state, batch,
                   torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    n = len(tree_leaves(params))
    assert np.isfinite(float(m["loss"]))
    assert (ops.nc_pack.launches, ops.nc_unpack.launches) == (n, n)
    assert (ops.flash_attention.launches, ops.paged_attention.launches,
            ops.ssd_scan.launches) == (0, 0, 0)
    _, grads = loss_and_grads(params, cfg, batch)
    gen = torch.Generator(device="cuda").manual_seed(2)
    u = tree_map(lambda g: torch.rand(g.shape, generator=gen,
                                      device="cuda"), grads)
    for g, v in zip(tree_leaves(grads), tree_leaves(u)):
        k = ops.nc_roundtrip(g, v)
        p = NC.unpack_reference(NC.pack_reference(g, v), g.dtype)
        assert torch.equal(k.view(torch.int16), p.view(torch.int16))


# ---------------------------------------------------------------------------
# data parallelism, resharding and placement on the card
# ---------------------------------------------------------------------------
def _dp_smoke(device):
    """qwen3 SMOKE (fp32) params, SGD-with-momentum state and a W = 2
    batch, the same numbers on `device`."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_map
    from repro_torch.optim.optimizers import sgd_momentum
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = tree_map(lambda t: t.to(device),
                      MD.init_model(cfg, torch.Generator().manual_seed(0)))
    r = np.random.RandomState(1)
    toks = torch.from_numpy(r.randint(0, cfg.vocab_size, size=(2, 1, 33))
                            .astype(np.int32)).to(device)
    opt = sgd_momentum(lambda s: 0.1)
    return (cfg, params, opt, opt.init(params),
            {"tokens": toks[..., :-1], "labels": toks[..., 1:]})


@pytest.mark.parametrize("mode", ["allreduce", "ps"])
def test_sync_step_on_card_matches_cpu(mode):
    """sync_step of qwen3 SMOKE on the card against the same call on the
    CPU (fp32, TF32 off): params within 1e-4, the comm accounts equal.
    The compressed aggregate of the same stacked gradients and uniforms
    is bit-identical on the two devices (its arithmetic is exact)."""
    _cuda()
    from repro_torch.core import data_parallel as DP
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            cfg, p, opt, st, b = _dp_smoke(dev)
            loss = lambda q, x: MD.lm_loss(q, cfg, x)
            out[dev] = DP.sync_step(loss, p, opt, st, b, mode=mode)
            if dev == "cpu":
                _, grads_w = DP.per_worker_grads(loss, p, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out["cuda"]
    assert {k: v for k, v in mg.items() if k != "loss"} == \
        {k: v for k, v in mc.items() if k != "loss"}
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               rtol=1e-5)
    for a, c in zip(tree_leaves(pg), tree_leaves(pc)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-6)
    gen = torch.Generator().manual_seed(3)
    u = tree_map(lambda g: torch.rand(g.shape, generator=gen), grads_w)
    ac, cc = DP.aggregate(grads_w, mode, noise=u)
    ag, cg = DP.aggregate(tree_map(lambda t: t.cuda(), grads_w), mode,
                          noise=tree_map(lambda t: t.cuda(), u))
    assert cg == cc
    for a, c in zip(tree_leaves(ag), tree_leaves(ac)):
        assert a.is_cuda and torch.equal(a.cpu(), c)


def test_reshard_and_save_stacked_of_cuda_tensors(tmp_path):
    """Rows of bf16, fp32 and int32 leaves on the card: survivors carried
    bit for bit, the joiner the fp32 mean cast back; the stacked save of
    the card's tensors is byte-identical to the save of their CPU copies,
    and the restore lands on the card."""
    _cuda()
    import filecmp
    from repro_torch.elastic import (reshard_stacked, restore_stacked,
                                     save_stacked)
    from repro_torch.models.common import tree_leaves, tree_map
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn(3, 65, 33, generator=g, device="cuda")
            .bfloat16(),
            "b": torch.randn(3, 7, generator=g, device="cuda"),
            "step": torch.arange(3, dtype=torch.int32, device="cuda")}
    out = reshard_stacked(tree, [4, 5, 6], [6, 4, 9])
    for k, v in tree.items():
        assert torch.equal(out[k][0], v[2]) and torch.equal(out[k][1], v[0])
    assert torch.equal(out["w"][2], tree["w"][[2, 0]].float().mean(0)
                       .bfloat16())
    save_stacked(str(tmp_path / "card"), 3, tree, [4, 5, 6])
    save_stacked(str(tmp_path / "host"), 3, tree_map(lambda t: t.cpu(), tree),
                 [4, 5, 6])
    names = sorted(p.name for p in (tmp_path / "card" / "step_00000003")
                   .iterdir())
    assert len(names) == 4
    assert all(filecmp.cmp(tmp_path / "card" / "step_00000003" / n,
                           tmp_path / "host" / "step_00000003" / n,
                           shallow=False) for n in names)
    row = tree_map(lambda t: t[0], tree)
    back, _, meta = restore_stacked(str(tmp_path / "card"), row, [5, 6, 7])
    assert meta["worker_ids"] == [4, 5, 6]
    for k, v in tree.items():
        assert back[k].is_cuda and back[k].dtype == v.dtype
        assert torch.equal(back[k][:2], v[1:])
    assert all(t.is_cuda for t in tree_leaves(back))


def test_place_rows_onto_the_card():
    """The coordinator moves a stacked host tree onto the card its
    transport maps the hosts to, values unchanged; a transport without a
    map leaves it where it is."""
    _cuda()
    from repro_torch.cluster import Coordinator, SimTransport

    class OnCard(SimTransport):
        def host_devices(self):
            return {0: torch.device("cuda", 0), 1: torch.device("cuda", 0)}

    tree = {"w": torch.arange(12.0).reshape(2, 6),
            "b": torch.ones(2, 3, dtype=torch.bfloat16)}
    placed = Coordinator(OnCard(), 2).place_rows(tree, [0, 1])
    for k, v in tree.items():
        assert placed[k].is_cuda and torch.equal(placed[k].cpu(), v)
    assert Coordinator(SimTransport(), 2).place_rows(tree, [0, 1]) is tree
