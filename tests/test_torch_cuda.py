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
# paged: (B, P, n_max, Hq, Hk, dh); the plan gives each its split
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
    # chunks (a preempted request's re-prefill); then 8 chunks of 256 at
    # P = N = 128 (fp32 tiles of 32), 17 chunks of 32 over 3 heads, the
    # state passed over 1 to 32 chunks, and sequences of 1 and 17 rows at
    # the smallest, zamba2's and the largest widths
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
    (1, 2048, 2, 128, 128, 256),
    (1, 544, 3, 32, 64, 32),
    *[(1, nc * 128 - 3, 4, 64, 64, 128) for nc in (3, 8, 9, 32)],
    (1, 17 * 64 - 3, 4, 64, 64, 64),
    *[(2, S, 3, W, W, 128) for S in (1, 17) for W in (16, 64, 128)],
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


# the Hopper kernel's plan (FA.plan): q-heads of a KV group packed into
# a block's 64 or 128 rows (G 7 and 12 leave rows empty, S off the
# block's positions), windows under packing, keys split over blocks
# (T >> S, small grids), and S > T, where the first S - T rows see no key
FA_PLAN_SHAPES = [
    (1, 100, 100, 14, 2, 128, True, None),   # G 7: 9 / 18 positions
    (1, 77, 77, 24, 2, 64, True, None),      # G 12: 5 / 10 positions
    (2, 53, 53, 24, 2, 192, True, None),     # G 12, dh 192
    (1, 131, 131, 56, 8, 96, True, None),    # G 7, dh 96
    (1, 300, 300, 16, 2, 128, True, 50),     # window, G 8
    (1, 200, 200, 24, 2, 32, True, 33),      # window, G 12
    (1, 700, 700, 14, 2, 192, True, 130),    # window, G 7, dh 192
    (1, 40, 2000, 12, 1, 64, True, None),    # T >> S, G 12: split keys
    (1, 33, 3000, 12, 1, 192, True, None),   # T >> S, dh 192
    (1, 64, 4096, 8, 8, 128, False, None),   # non-causal, split keys
    (1, 100, 2000, 8, 4, 96, True, 700),     # window, split keys
    (1, 300, 100, 14, 2, 128, True, None),   # S > T: 200 rows see no key
    (2, 150, 64, 8, 8, 64, True, None),      # S > T, G 1
]


@pytest.mark.parametrize("B,S,T,Hq,Hk,dh,causal,window", FA_PLAN_SHAPES)
def test_flash_kernel_plan_edges(B, S, T, Hq, Hk, dh, causal, window):
    """bf16 (the Hopper kernel) against the plain version; a row that sees
    no key emits exactly 0 (the plain version averages it uniformly)."""
    _cuda()
    g = torch.Generator(device="cuda").manual_seed(S + T)
    q, k, v = (torch.randn(B, n, H, dh, generator=g, device="cuda")
               .bfloat16() for n, H in ((S, Hq), (T, Hk), (T, Hk)))
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = FA.reference(q, k, v, causal=causal, window=window)
    dead = torch.zeros(S, dtype=torch.bool, device="cuda")
    if causal and S > T:
        dead[:S - T] = True
    assert bool((out[:, dead] == 0).all())
    torch.testing.assert_close(out[:, ~dead].float(), ref[:, ~dead].float(),
                               rtol=2e-2, atol=2e-2)


def test_flash_plan_edges_use_packing_and_splits():
    """The cases above reach what they are named for: rows left empty by
    G 7 and 12, and key splits."""
    plans = [FA.plan(B, S, T, Hq, Hk, dh, causal, window)
             for B, S, T, Hq, Hk, dh, causal, window in FA_PLAN_SHAPES]
    assert {p.rows % p.pack for p in plans} - {0}
    assert sum(p.splits > 1 for p in plans) >= 4


@pytest.mark.parametrize("shape", [(1, 512, 512, 16, 8, 128, True),
                                   (1, 192, 1500, 6, 6, 64, False),
                                   (1, 512, 512, 96, 8, 192, True)])
def test_flash_kernel_graph_replay_equals_eager(shape):
    """A CUDA graph records the kernel's tensor maps by value: replays on
    refilled inputs give the eager call's bits (splits merge in a fixed
    order)."""
    _cuda()
    B, S, T, Hq, Hk, dh, causal = shape
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(B, n, H, dh, generator=g, device="cuda")
               .bfloat16() for n, H in ((S, Hq), (T, Hk), (T, Hk)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = FA.flash_attention(q, k, v, causal=causal)
    for seed in (4, 5):
        g.manual_seed(seed)
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        graph.replay()
        eager = FA.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


def _split_case(B, P, n_max, Hq, Hk, dh, dtype, seed=0):
    """Rows of very different lengths on scrambled pages, positions at the
    split edges, one row at pos -1 where there is room; every page outside
    the live prefixes poisoned with +-1e9.  Returns (args, clean pools)."""
    r = np.random.RandomState(seed)
    Np = B * n_max + 4
    plan = PA.plan(B, 1, Hq, Hk, dh, n_max, P, dtype)
    n_splits, span = plan.splits, plan.span
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


# paged, S query rows a table row (B, S, P, n_max, Hq, Hk, dh): the
# verify round (qwen3-1.7b, 8 slots x 4 candidates), G 7 and 12 with S 4
# (28 and 48 rows a block: two and four 16-row tiles), small pages, and
# groups past 64 rows (two chunks of rows a KV group: G 12 x S 6, as
# nemotron verifies at --spec-k 5; G 2 x S 40; G 1 x S 70)
PA_ROW_SHAPES = [
    (8, 4, 16, 40, 16, 8, 128),              # verify, qwen3-1.7b
    (8, 4, 16, 40, 56, 8, 128),              # arctic-480b heads, S 4
    (8, 4, 16, 40, 96, 8, 192),              # nemotron-4-340b heads, S 4
    (3, 4, 8, 24, 84, 7, 32),                # G 12, dh 32, P 8
    (4, 4, 4, 30, 28, 4, 96),                # G 7, dh 96, P 4
    (5, 2, 16, 20, 16, 2, 64),               # G 8, S 2
    (6, 6, 16, 20, 96, 8, 192),              # G 12, S 6: 72 rows
    (3, 40, 8, 30, 16, 8, 64),               # G 2, S 40: 80 rows
    (2, 70, 16, 12, 8, 8, 128),              # G 1, S 70
]
# page sizes 1-32 (a page slot of 8-32 rows, 1-8 pages a stage), and
# pages past a TMA box's 256 rows (bf16 reads 300 as 2 sub-pages of 150,
# 512 as 2 of 256)
PA_PAGE_SHAPES = [(4, 1, P, n, 16, 8, 128) for P, n in
                  ((1, 200), (2, 120), (4, 80), (8, 40), (32, 12))] + [
    (4, 4, 1, 150, 32, 4, 64), (3, 4, 2, 90, 24, 2, 96),
    (3, 1, 300, 3, 16, 8, 128), (2, 4, 512, 2, 32, 4, 64)]


def _rows_case(B, S, P, n_max, Hq, Hk, dh, dtype, seed=0):
    """S query rows a table row on scrambled disjoint pages: the rows'
    last candidates at the edges of the plan's splits and stages (stage s
    of a split starts at page span*k + pages*s), one row whose first
    candidates sit below 0, one row wholly below 0 where B > 4, one at
    the table's end; every page outside the live prefixes poisoned with
    +-1e9.  Returns (args, clean pools, plan)."""
    r = np.random.RandomState(seed)
    Np = B * n_max + 4
    # (the fp32 plan's splits where bf16 reads sub-pages)
    plan = PA.plan(B, S, Hq, Hk, dh, n_max, P,
                   dtype if P <= PA.MAX_SLOT else torch.float32)
    w, st, last = plan.span * P, max(1, plan.pages) * P, n_max * P - 1
    edges = [last, w - 1, w, st - 1, st, w + st, S - 3, 2 * w + 1,
             w + 2 * st - 1, r.randint(S, last + 1)]
    top = np.array([min(last, edges[b % len(edges)]) for b in range(B)])
    if B > 4:
        top[4] = -1
    pos = (top[:, None] - np.arange(S)[::-1]).astype(np.int32)
    q = r.randn(B, S, Hq, dh).astype(np.float32)
    kp = r.randn(Np, P, Hk, dh).astype(np.float32)
    vp = r.randn(Np, P, Hk, dh).astype(np.float32)
    ids = r.permutation(Np)[:B * n_max].reshape(B, n_max).astype(np.int32)
    live = {int(ids[b, j]) for b in range(B)
            for j in range(int(pos[b].max()) // P + 1)}
    stale = [p for p in range(Np) if p not in live]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[stale], vp2[stale] = 1e9, -1e9
    cuda = [torch.from_numpy(a).cuda().to(dtype)
            for a in (q, kp2, vp2, kp, vp)]
    ints = [torch.from_numpy(a).cuda() for a in (ids, pos)]
    return (cuda[0], cuda[1], cuda[2], *ints), (cuda[3], cuda[4]), plan


def _check_rows(args, clean, plan, dtype):
    out = PA.paged_attention(*args)
    again = PA.paged_attention(*args)
    kept = PA.paged_attention(args[0], *clean, *args[3:])
    q, kp, vp, bt, pos = args
    B, S = pos.shape
    flat = PA.paged_attention(q.reshape(B * S, *q.shape[2:]), kp, vp,
                              bt.repeat_interleave(S, dim=0),
                              pos.reshape(-1))
    torch.cuda.synchronize()
    what = f"plan {plan}"
    assert torch.equal(out, kept), f"stale pages leaked: {what}"
    assert torch.equal(out, again), f"two calls differ: {what}"
    dead = pos < 0
    assert bool((out[dead] == 0).all()), f"a row with no key: {what}"
    ref = PA.reference(*args)
    tol = TOL[dtype]
    torch.testing.assert_close(out[~dead].float(), ref[~dead].float(),
                               rtol=tol, atol=tol, msg=what)
    # the same rows one a table row (the table repeated): another plan,
    # the same function
    torch.testing.assert_close(out.float(), flat.reshape(out.shape).float(),
                               rtol=tol, atol=tol, msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,P,n_max,Hq,Hk,dh",
                         PA_ROW_SHAPES + PA_PAGE_SHAPES)
def test_paged_kernel_query_rows_at_split_and_stage_edges(B, S, P, n_max,
                                                          Hq, Hk, dh, dtype):
    """S query rows through one table row (the verify form) and page sizes
    1-32, 300 and 512 against the plain version and against the flattened form, with
    poisoned stale pages bit-invisible, two calls bit-identical and rows
    below 0 zero."""
    _cuda()
    args, clean, plan = _rows_case(B, S, P, n_max, Hq, Hk, dh,
                                   getattr(torch, dtype), seed=P)
    _check_rows(args, clean, plan, dtype)


@pytest.mark.parametrize("shape", [(8, 1, 16, 8, 128, 40),
                                   (8, 4, 16, 8, 128, 40),
                                   (8, 1, 96, 8, 192, 40)])
def test_paged_kernel_graph_replay_equals_eager(shape):
    """A CUDA graph records the kernel's tensor maps by value: replays on
    refilled inputs (queries, pools, positions) give the eager call's
    bits (splits merge in a fixed order)."""
    _cuda()
    B, S, Hq, Hk, dh, n_max = shape
    P, Np = 16, shape[0] * shape[5] + 1
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn(Np, P, Hk, dh, generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    bt = torch.randperm(Np - 1, generator=torch.Generator().manual_seed(1)
                        )[:B * n_max].reshape(B, n_max).int().cuda()
    pos = torch.randint(0, n_max * P, (B, S), generator=g, device="cuda",
                        dtype=torch.int32)
    if S == 1:
        q, pos = q[:, 0].contiguous(), pos[:, 0].contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PA.paged_attention(q, kp, vp, bt, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = PA.paged_attention(q, kp, vp, bt, pos)
    for seed in (4, 5):
        g.manual_seed(seed)
        for t in (q, kp, vp):
            t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        pos.copy_(torch.randint(0, n_max * P, pos.shape, generator=g,
                                device="cuda", dtype=torch.int32))
        graph.replay()
        eager = PA.paged_attention(q, kp, vp, bt, pos)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


@pytest.mark.parametrize("dh", PA.HEAD_DIMS)
def test_paged_plan_residency_matches_the_card(dh):
    """The plan's RESIDENT (bf16 blocks an SM, bound by registers) is what
    the card's occupancy calculator gives the kernel at a small shared
    memory, and at least what it gives at every plan's shared memory
    that the plan sized for RESIDENT blocks an SM."""
    _cuda()
    lib = build.load("paged_attention")
    assert lib.paged_tc_blocks_per_sm(dh, 16 * 1024) == PA.RESIDENT[dh]
    assert PA.blocks_per_sm(dh) == PA.RESIDENT[dh]
    for G in PA.GROUPS:
        for S, P in ((1, 16), (4, 16), (1, 4), (4, 32)):
            p = PA.plan(8, S, 2 * G, 2, dh, 40, P)
            if PA.RESIDENT[dh] * (p.smem + 1024) <= PA.SMEM_SM:
                assert lib.paged_tc_blocks_per_sm(dh, p.smem) >= \
                    PA.RESIDENT[dh], p


def test_paged_kernel_encodes_each_layer_pool_once():
    """A serve tick calls the kernel on every layer's pool, each a slice
    of one stacked tensor: the first pass over 28 layers encodes their 56
    tensor maps (K and V), a second pass none, and each layer's output is
    the plain version's on its own slice."""
    _cuda()
    L, B, P, n_max, Hq, Hk, dh = 28, 8, 16, 40, 16, 8, 128
    Np = B * n_max + 3            # a pool shape no other test uses
    g = torch.Generator(device="cuda").manual_seed(8)
    pools = [torch.randn(L, Np, P, Hk, dh, generator=g, device="cuda")
             .bfloat16() for _ in range(2)]
    q = torch.randn(B, Hq, dh, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(Np, generator=torch.Generator().manual_seed(2)
                        )[:B * n_max].reshape(B, n_max).int().cuda()
    pos = torch.randint(0, n_max * P, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    lib = build.load("paged_attention")
    outs = []
    for rnd in range(2):
        before = lib.paged_map_encodes()
        outs.append([PA.paged_attention(q, pools[0][i], pools[1][i], bt, pos)
                     for i in range(L)])
        torch.cuda.synchronize()
        assert lib.paged_map_encodes() - before == (2 * L if rnd == 0 else 0)
    for i in (0, L // 2, L - 1):
        assert torch.equal(outs[0][i], outs[1][i])
        ref = PA.reference(q, pools[0][i], pools[1][i], bt, pos)
        torch.testing.assert_close(outs[0][i].float(), ref.float(),
                                   rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"])


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


@pytest.mark.parametrize("S", [512, 500, 2048])
def test_ssd_kernel_strong_decay_is_finite(S):
    """loga ~ -0.8 a step, as zamba2's random weights give: L falls to about
    -120 over a 128-step chunk, where exp(L_s - L_t) above the diagonal is
    inf in fp32.  The kernel never takes it there: no NaN, no inf; and it
    holds to its plain version and to the float64 recurrence, also with a
    ragged last chunk (S 500) and over 16 chunks (S 2048)."""
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
    span = PA.plan(Bv, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                   n_max, P, dt).span
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
    """attention_verify through the paged kernel (one launch: 8 table rows
    of 4 query rows) against the plain gather-and-softmax on the same
    pools."""
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


@pytest.mark.parametrize("mode", ["sync", "local_sgd", "easgd", "async_ps",
                                  "ssp"])
def test_run_elastic_on_card_matches_cpu(mode, tmp_path):
    """run_elastic on the card against the same run on the CPU, on the
    single-failure trace of tests/test_elastic.py: transitions,
    recoveries, simulated time, goodput and final_alive equal, losses
    within rtol 1e-5 (fp32, TF32 off)."""
    _cuda()
    from repro_torch.elastic import ElasticProblem, FailureTrace, run_elastic
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = run_elastic(ElasticProblem(device=dev), mode=mode,
                               steps=30,
                               trace=FailureTrace.single_failure(23, 1),
                               ckpt_dir=str(tmp_path / dev))
    c, g = out["cpu"], out["cuda"]
    assert [t.as_tuple() for t in g.transitions] == \
        [t.as_tuple() for t in c.transitions]
    assert [(r.wall_step, r.worker, r.cause, r.lost_steps, r.latency)
            for r in g.recoveries] == \
        [(r.wall_step, r.worker, r.cause, r.lost_steps, r.latency)
         for r in c.recoveries]
    assert (g.sim_time, g.goodput, g.final_alive, g.splits_replanned) == \
        (c.sim_time, c.goodput, c.final_alive, c.splits_replanned)
    np.testing.assert_allclose(g.losses, c.losses, rtol=1e-5, atol=1e-8)
    if g.stacked_params is not None:
        assert g.stacked_params["w"].is_cuda


@pytest.mark.parametrize("hedged", [False, True])
def test_smoke_fleet_on_card_matches_cpu(hedged):
    """A paged qwen3 SMOKE fleet (fp32) through the attention kernels on
    the card against the plain path on the CPU, a replica killed (or hung
    and hedged) mid-stream: the same greedy streams and stats(); flash
    launches one a layer an admit and paged one a layer a decode tick,
    summed over the fleet's engines, the killed one's included."""
    _cuda()
    from repro_torch.configs import get_config
    from repro_torch.elastic import FailureTrace, TraceEvent
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_map
    from repro_torch.serving import Request, ServeFleet
    cfg = get_config("qwen3-0.6b", smoke=True).with_(
        param_dtype="float32", compute_dtype="float32")
    params = MD.init_model(cfg, torch.Generator().manual_seed(0))
    r = np.random.RandomState(0)
    spec = [(i, r.randint(0, cfg.vocab_size, size=int(r.choice((6, 10)))),
             int(r.choice((4, 8)))) for i in range(10)]
    event = TraceEvent(3, "hang", 2) if hedged else TraceEvent(4, "fail", 1)
    out = {}
    for dev in ("cpu", "cuda"):
        c = cfg.with_(use_flash_kernel=dev == "cuda",
                      use_paged_kernel=dev == "cuda")
        fleet = ServeFleet(tree_map(lambda t: t.to(dev), params), c,
                           replicas=3, num_slots=2, cache_len=24,
                           page_size=4, trace=FailureTrace([event]),
                           hedged_decode=hedged, device=dev)
        ops.reset_launches()
        fins = fleet.run([Request(rid=i, prompt=p.copy(), max_new_tokens=g)
                          for i, p, g in spec])
        out[dev] = ([(f.rid, f.tokens) for f in fins], fleet.stats(),
                    fleet.engine_stats(),
                    {n: getattr(ops, n).launches
                     for n in ("flash_attention", "paged_attention")})
    (ct, cs, _, _), (gt, gs, ge, gl) = out["cpu"], out["cuda"]
    assert gt == ct and gs == cs
    L = cfg.num_layers
    assert gl == {"flash_attention": L * ge["prefill_ticks"],
                  "paged_attention": L * ge["decode_ticks"]}
    assert gs["drains"] == 1 or gs.get("hedges_launched", 0) >= 1


# ---------------------------------------------------------------------------
# the mesh on a world of one: an NCCL group of one rank
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    _cuda()
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_device_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("env", ["dp", "tp", "dp_tp", "fsdp"])
def test_mesh_train_step_bit_equal_on_card(env, one_rank_mesh):
    """qwen3 SMOKE's compressed train step (fp32, the nc kernels) on a
    1x1 mesh under each launcher env equals the plain step bit for bit:
    parameters, moments, loss and gnorm; nc launches one a leaf."""
    from repro_torch.core import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import batch_pspecs, make_train_step
    from repro_torch.launch.train import ENVS
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw
    cfg = get_config("qwen3-0.6b", smoke=True)
    p0 = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(lambda s: 1e-2)
    step = make_train_step(cfg, opt, compress_grads=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def noise():
        return torch.Generator(device="cuda").manual_seed(5)

    pp = tree_map(torch.clone, p0)
    pp, sp, mp = step(pp, opt.init(pp), batch, noise())
    mesh = one_rank_mesh
    with SH.axis_env(ENVS[env]):
        pd = MD.distribute_params(tree_map(torch.clone, p0), cfg, mesh)
        sd = opt.init(pd)
        with SH.use_mesh(mesh):
            specs = batch_pspecs(cfg, batch)
            bd = {k: SH.distribute(v, specs[k], mesh)
                  for k, v in batch.items()}
            ops.reset_launches()
            pd, sd, md = step(pd, sd, bd, noise())
    n = len(tree_leaves(p0))
    assert ops.nc_pack.launches == ops.nc_unpack.launches == n

    def local(t):
        return t.to_local() if SH.is_dtensor(t) else t
    for a, b in zip(tree_leaves(pd) + tree_leaves(sd["mu"])
                    + tree_leaves(sd["nu"]),
                    tree_leaves(pp) + tree_leaves(sp["mu"])
                    + tree_leaves(sp["nu"])):
        assert torch.equal(local(a), b)
    assert torch.equal(md["loss"], mp["loss"])
    assert torch.equal(md["gnorm"], mp["gnorm"])


def test_kernels_on_local_shards_of_dtensors(one_rank_mesh):
    """flash_attention and nc_roundtrip given DTensors launch on the local
    heads / elements and wrap the result with the input's placements,
    bit-equal to the plain tensors' launch; one launch counted each."""
    from repro_torch.core import sharding as SH
    mesh = one_rank_mesh
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(1, 128, h, 128, generator=g, device="cuda")
               .bfloat16() for h in (16, 8, 8))
    ref = ops.flash_attention(q, k, v, causal=True)
    x = torch.randn(4099, generator=g, device="cuda")
    u = torch.rand(4099, generator=g, device="cuda")
    nref = ops.nc_roundtrip(x, u)
    with SH.axis_env(SH.TP_ENV), SH.use_mesh(mesh):
        spec = SH.logical("batch", None, "model", None)
        qd, kd, vd = (SH.distribute(t, spec, mesh) for t in (q, k, v))
        ops.reset_launches()
        out = ops.flash_attention(qd, kd, vd, causal=True)
        xd = SH.distribute(x, (None,), mesh)
        nout = ops.nc_roundtrip(xd, u)
    assert SH.is_dtensor(out) and out.placements == qd.placements
    assert torch.equal(out.to_local(), ref)
    assert SH.is_dtensor(nout) and torch.equal(nout.to_local(), nref)
    assert (ops.flash_attention.launches, ops.nc_pack.launches,
            ops.nc_unpack.launches) == (1, 1, 1)


def test_pipeline_and_ddg_on_card(one_rank_mesh):
    """pipeline_apply on a one-stage mesh equals sequential_apply bit for
    bit, with gradients; DDG with one module equals sequential_step."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import decoupled as DD
    from repro_torch.core.pipeline import pipeline_apply, sequential_apply
    g = torch.Generator(device="cuda").manual_seed(3)
    stack = {"w": (torch.randn(8, 16, 16, generator=g, device="cuda") * 0.3)
             .requires_grad_(True),
             "b": torch.zeros(8, 16, device="cuda", requires_grad=True)}
    x = torch.randn(16, 16, generator=g, device="cuda")

    def block_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])
    smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    y = pipeline_apply(block_fn, stack, x, smesh, num_microbatches=1)
    ys = sequential_apply(block_fn, stack, x)
    assert torch.equal(y, ys)
    ga = torch.autograd.grad((y ** 2).sum(), [stack["w"], stack["b"]])
    gs = torch.autograd.grad((ys ** 2).sum(), [stack["w"], stack["b"]])
    assert all(torch.equal(a, b) for a, b in zip(ga, gs))

    def fn(p, h):
        return h @ p["w"] + p["b"]

    def loss_fn(pred, batch):
        return torch.mean((pred[:, 0] - batch["y"]) ** 2)
    p = {"w": torch.randn(16, 1, generator=g, device="cuda") * 0.25,
         "b": torch.zeros(1, device="cuda")}
    batch = {"x": x, "y": torch.tanh(x.sum(-1))}
    st, seq = DD.ddg_init([p]), [p]
    for _ in range(3):
        st, _ = DD.ddg_tick(st, [fn], loss_fn, batch, lr=0.05)
        seq, _ = DD.sequential_step(seq, [fn], loss_fn, batch, lr=0.05)
    assert all(torch.equal(st.params[0][n], seq[0][n]) for n in p)



@pytest.mark.parametrize("env", ["dp", "tp", "dp_tp", "fsdp"])
def test_mesh_lm_loss_bit_equal_on_card(env, one_rank_mesh):
    """The vocab-parallel lm_loss of qwen3 SMOKE on the card (bf16) on a
    1x1 mesh: loss and gradients bit-equal to the plain loss's."""
    from repro_torch.core import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import batch_pspecs, loss_and_grads
    from repro_torch.launch.train import ENVS
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    cfg = get_config("qwen3-0.6b", smoke=True)
    p0 = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = loss_and_grads(p0, cfg, batch)
    with SH.axis_env(ENVS[env]):
        pd = MD.distribute_params(tree_map(torch.clone, p0), cfg,
                                  one_rank_mesh)
        with SH.use_mesh(one_rank_mesh):
            specs = batch_pspecs(cfg, batch)
            bd = {k: SH.distribute(v, specs[k], one_rank_mesh)
                  for k, v in batch.items()}
            dloss, dgrads = loss_and_grads(pd, cfg, bd)
    assert torch.equal(SH.whole(dloss), loss)
    for a, b in zip(tree_leaves(dgrads), tree_leaves(grads)):
        assert a.dtype == b.dtype and torch.equal(SH.local(a), b)


def test_mesh_checkpoint_round_trip_on_card(one_rank_mesh, tmp_path):
    """A DTensor tree on the card (qwen3 SMOKE's bf16 params and AdamW
    moments under fsdp on a 1x1 mesh), saved blocking and through
    AsyncCheckpointer: the files of the plain tree's save; restored into
    the layout bit-equal, placements kept."""
    from repro_torch.checkpoint import (AsyncCheckpointer,
                                        restore_checkpoint, save_checkpoint)
    from repro_torch.core import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch.train import ENVS
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw
    cfg = get_config("qwen3-0.6b", smoke=True)
    p0 = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw(lambda s: 1e-2)
    plain = {"params": p0, "opt": opt.init(p0)}
    g = torch.Generator(device="cuda").manual_seed(2)
    for t in tree_leaves(plain["opt"]["mu"]):
        t.normal_(generator=g)
    save_checkpoint(str(tmp_path / "plain"), 1, plain, {"step": 1})
    with SH.axis_env(ENVS["fsdp"]):
        pd = MD.distribute_params(p0, cfg, one_rank_mesh)
        sd = opt.init(pd)
        for a, b in zip(tree_leaves(sd["mu"]), tree_leaves(plain["opt"]
                                                           ["mu"])):
            a.to_local().copy_(b)
    tree = {"params": pd, "opt": sd}
    save_checkpoint(str(tmp_path / "mesh"), 1, tree, {"step": 1})
    with AsyncCheckpointer(str(tmp_path / "async")) as ck:
        ck.save(1, tree, {"step": 1})

    def files(d):
        return {p.relative_to(d): p.read_bytes()
                for p in sorted(d.rglob("*")) if p.is_file()}
    want = files(tmp_path / "plain")
    assert files(tmp_path / "mesh") == want == files(tmp_path / "async")
    back, meta = restore_checkpoint(str(tmp_path / "mesh"),
                                    tree_map(torch.zeros_like, tree))
    assert meta == {"step": 1}
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert SH.is_dtensor(a) == SH.is_dtensor(b)
        if SH.is_dtensor(b):
            assert a.placements == b.placements
        assert a.dtype == b.dtype and torch.equal(SH.local(a),
                                                  SH.local(b))

def test_rank_zero_transport_beside_nccl(one_rank_mesh):
    """`RankZeroTransport` over a gloo group made beside the NCCL world:
    rank 0's results (events, a role reply, an error) come back through
    its broadcast, the card's tensors untouched by it."""
    import torch.distributed as dist
    from repro_torch.cluster.coordinator import Coordinator
    from repro_torch.cluster.sim import SimTransport
    from repro_torch.cluster.transport import RankZeroTransport
    from repro_torch.elastic.membership import FailureTrace, TraceEvent
    trace = FailureTrace([TraceEvent(1, "fail", 1)])
    t = RankZeroTransport.build(lambda: SimTransport(trace),
                                dist.new_group(backend="gloo"))
    coord = Coordinator(t, 3)
    try:
        assert coord.advance(0) == []
        assert [x.as_tuple()[:3] for x in coord.advance(1)] == [
            (1, "death", 1)]
        assert coord.alive() == (0, 2)
        t.ps_open(2, 0.1, {"w": np.ones(4, np.float32)})
        _, entries = t.ps_pull(2)
        np.testing.assert_array_equal(entries["w"], np.ones(4, np.float32))
        with pytest.raises(ValueError, match="unknown"):
            t.on_rank0(lambda: (_ for _ in ()).throw(ValueError("unknown")))
        x = torch.arange(8, device="cuda", dtype=torch.float32)
        dist.all_reduce(x)           # the NCCL world still works beside it
        assert x.tolist() == list(range(8))
    finally:
        coord.close()


def test_adafactor_step_on_dtensor_shards_bit_equal(one_rank_mesh):
    """One Adafactor step on qwen3 SMOKE's bf16 params laid out under
    fsdp on the 1x1 mesh equals the plain step bit for bit (params and
    statistics)."""
    from repro_torch.core import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import apply_grads
    from repro_torch.launch.train import ENVS
    from repro_torch.models import model as MD
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.optimizers import adafactor
    cfg = get_config("qwen3-0.6b", smoke=True)
    p0 = MD.init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(3)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                           device="cuda").to(t.dtype), p0)
    opt = adafactor(lambda s: 1e-2)
    plain = tree_map(torch.clone, p0)
    st = opt.init(plain)
    apply_grads(opt, plain, st, grads)
    with SH.axis_env(ENVS["fsdp"]):
        pd = MD.distribute_params(tree_map(torch.clone, p0), cfg,
                                  one_rank_mesh)
        gd = MD.distribute_params(grads, cfg, one_rank_mesh)
        sd = opt.init(pd)
        apply_grads(opt, pd, sd, gd)
    for a, b in zip(tree_leaves(pd) + tree_leaves(sd),
                    tree_leaves(plain) + tree_leaves(st)):
        assert torch.equal(SH.local(a), b)


# ---------------------------------------------------------------------------
# deep RL and classic ML on the card (no kernel on these paths)
# ---------------------------------------------------------------------------
KERNELS = ("flash_attention", "paged_attention", "ssd_scan", "nc_pack",
           "nc_unpack")


def _launch_counts():
    return {n: getattr(ops, n).launches for n in KERNELS}


def _to(tree, dev):
    from repro_torch.rl.agents import tree_map
    return tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, tree)


def _rl_round(arch, state, draws, dev):
    from repro_torch.rl import agents as A
    from repro_torch.rl.env import ChainEnv
    env = ChainEnv()
    state, draws = _to(state, dev), _to(draws, dev)
    if arch in ("gorila", "apex"):
        new, m = A.gorila_round(state, draws, env=env,
                                prioritized=arch == "apex")
        return new.params, new.env_states, m["loss"]
    params, env_states = state
    if arch == "a3c":
        out = A.a3c_round(params, env_states, draws, env=env)
    elif arch == "dppo":
        out = A.dppo_round(params, env_states, draws, env=env)
    else:
        out = A.impala_round(params, params, env_states, draws, env=env,
                             use_vtrace=arch == "impala")
    return out[0], out[1], out[2]["loss"]


@pytest.mark.parametrize("arch", ["gorila", "apex", "a3c", "impala",
                                  "impala_naive", "dppo"])
def test_rl_round_on_card_matches_cpu(arch):
    """One round of each architecture on the card and on the CPU from the
    same state and the same host-drawn draws: params within fp32 2e-5
    relative, env states equal, no kernel launched."""
    _cuda()
    from repro_torch.rl import agents as A
    from repro_torch.rl.env import ChainEnv, gumbel
    env = ChainEnv()
    g = torch.Generator().manual_seed(0)
    W, T = 64, 16
    if arch in ("gorila", "apex"):
        state = A.q_init(env, g, actors=W, capacity=4096)
        state, _ = A.gorila_round(state, g, env=env)   # a filled replay
        draws = {"gumbel": gumbel((W, T, 2), g),
                 "uniform": torch.rand(64, generator=g)}
    else:
        state = (A.ac_init(g, env.obs_dim, 2), env.reset((W,)))
        draws = gumbel((W, T, 2), g)
    before = _launch_counts()
    cp, cs, cl = _rl_round(arch, state, draws, "cpu")
    gp, gs, gl = _rl_round(arch, state, draws, "cuda")
    assert _launch_counts() == before
    for a, b in zip(A.tree_leaves(gp), A.tree_leaves(cp)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5 * float(b.abs().max()))
    for k in ("pos", "t"):
        assert torch.equal(gs[k].cpu(), cs[k])
    np.testing.assert_allclose(float(gl), float(cl), rtol=2e-5, atol=1e-6)


def test_rl_fleet_on_card_matches_cpu():
    """run_fleet with actor 1 killed on the card and on the CPU: the
    simulated clock's results equal (the draws are host-drawn), losses
    within rtol 2e-5."""
    _cuda()
    from repro_torch.elastic import FailureTrace
    from repro_torch.rl.fleet import run_fleet
    out = {dev: run_fleet(actors=4, steps=20, rollout_len=8, batch=8,
                          trace=FailureTrace.single_failure(12, 1),
                          device=dev) for dev in ("cpu", "cuda")}
    c, g = out["cpu"], out["cuda"]
    assert (g.transitions, g.env_steps, g.learner_steps, g.final_version,
            g.staleness_sum, g.final_actors) == \
        (c.transitions, c.env_steps, c.learner_steps, c.final_version,
         c.staleness_sum, c.final_actors)
    np.testing.assert_allclose(g.losses, c.losses, rtol=2e-5, atol=1e-6)


def _classic_small(which, dev):
    from repro_torch.classic import boosting as B
    from repro_torch.classic import kmeans as K
    from repro_torch.classic import svm as S
    g = torch.Generator().manual_seed(0)
    W, n, d = 4, 2048, 16
    y = torch.where(torch.rand(W, n, generator=g) < 0.5, 1.0, -1.0)
    x = (y[..., None] * 0.7 + torch.randn((W, n, d), generator=g))
    x, y = x.to(dev), y.to(dev)
    if which == "kmeans":
        idx = torch.randperm(W * n, generator=g)[:8]
        return K.kmeans_fit(x, 8, iters=10, noise=idx)
    if which == "fuzzy":
        c = x.reshape(-1, d)[:5]
        for _ in range(5):
            c, obj = K.fuzzy_cmeans_step(x, c)
        return c, obj, K.xie_beni(x, c)
    if which == "svm":
        return S.svm_dist_gradient(x, y, steps=100)[0]
    if which == "dpsvm":
        return S.dpsvm(x, y, hops=4, local_steps=50, sv_capacity=128)
    m = B.adaboost_dist_full(x, y, rounds=10)
    return m["d"], m["t"], m["p"], m["alpha"]


@pytest.mark.parametrize("which", ["kmeans", "fuzzy", "svm", "dpsvm",
                                   "adaboost"])
def test_classic_trainer_on_card_matches_cpu(which):
    """Each classic trainer on the card and on the CPU from the same data:
    integer results equal, fp32 values within 2e-5 relative (the SVMs'
    weights, sums of many subgradient steps, within 1e-4), no kernel
    launched."""
    _cuda()
    before = _launch_counts()
    c = _classic_small(which, "cpu")
    g = _classic_small(which, "cuda")
    assert _launch_counts() == before
    flat = (lambda r: [r[k] for k in sorted(r)] if isinstance(r, dict)
            else list(r))
    if which == "dpsvm":
        assert g[1] == c[1]
        c, g = c[0], g[0]
    tol = 1e-4 if which in ("svm", "dpsvm") else 2e-5
    for a, b in zip(flat(g), flat(c)):
        assert a.is_cuda
        if b.dtype in (torch.int64, torch.int32):
            assert torch.equal(a.cpu(), b)
        else:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       rtol=tol, atol=tol * float(
                                           b.abs().max()))
