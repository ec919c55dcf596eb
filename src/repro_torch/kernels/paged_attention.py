"""Paged-attention decode and verify: the CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel of the JAX package's
``kernels/paged_attention.py``; ``reference`` is the plain version with
the same semantics, which the CPU path and the tests use.

Both take one query row a table row, q (B,Hq,dh) with pos (B,), or S rows
that share a table row (a verify round's candidates), q (B,S,Hq,dh) with
pos (B,S).  The kernel runs a `plan`, plain host arithmetic on the
shapes: the rows a block packs, the pages a stage, the stages in flight,
the span of pages a split takes (tests/test_torch_paged_plan.py holds it
on the CPU).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref as reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 192)
GROUPS = (1, 2, 4, 7, 8, 12)

# the H100's streaming multiprocessors, and the dynamic shared memory one
# block may opt in to
SMS = 132
SMEM_LIMIT = 227 * 1024
SMEM_SM = 228 * 1024           # an SM's, 1 KB of it reserved per block
# the fp32 kernel's splits are planned to give at least TARGET_BLOCKS
# blocks, two for each SM; a split takes at least MIN_SPLIT_POSITIONS
# positions, so short tables keep one split and no merge pass; the fp32
# kernel's splits take at most MAX_SPAN pages (their table entries staged
# in static shared memory; the bf16 kernel sizes its staging by the span)
TARGET_BLOCKS = 2 * SMS
MIN_SPLIT_POSITIONS = 64
# the bf16 kernel splits a table row only when its (table row, kv-head)
# pairs leave SMs idle: then into splits for two blocks an SM where a
# block packs at most FEW_ROWS query rows, one where it packs more (the
# end of a block merges its warps' rows, which costs more than a second
# block an SM gains: a sweep of the span on the card, in PERF.md)
FEW_ROWS = 4
MAX_SPAN = 64
# the bf16 kernel's layout (csrc/paged_attention.cu): four consumer warps
# and a producer warp; a warp computes 16 query rows (an mma.sync tile)
# over all, 1/2 or 1/4 of a stage's keys, so a block packs at most 64
# rows, and a KV group of more rows (G*S) takes a block for each chunk
# of 64; a page lands in a slot of a
# power of two rows, at least 8 (the swizzle's repeat) and at most 256 (a
# TMA box); a stage holds at least STAGE_KEYS rows, in whole pages; 1-4
# stages, as many as keep the blocks an SM holds by registers resident
CONSUMERS = 4
THREADS = 32 * (CONSUMERS + 1)
# bf16 blocks an SM holds by registers, a head dim, as ptxas built the
# kernel (90, 109, 128, 149 and 166 registers a thread at dh 32 .. 192, no
# spills; 160 threads a block of the SM's 65536 registers).  On the card
# the wrapper plans with `blocks_per_sm`, the occupancy calculator's
# answer for the kernel as built; this table is its stand-in where there
# is no card (the CPU tests), and tests/test_torch_cuda.py holds it to
# the card: regenerate it when the kernel's registers change
RESIDENT = {32: 4, 64: 3, 96: 3, 128: 2, 192: 2}
MAX_ROWS = 16 * CONSUMERS
MAX_SLOT = 256
STAGE_KEYS = 64
MAX_STAGES = 4
# the fp32 kernel's: 4 warps a block of one query row
NUM_WARPS = 4


class Plan(NamedTuple):
    rows: int        # query rows a block: G*S (bf16), G (fp32)
    tiles: int       # 16-row tiles of a block, 1, 2 or 4 (bf16; fp32: 0)
    chunks: int      # blocks of 16*tiles rows a KV group takes (bf16;
                     # fp32: 0): 1 unless G*S passes MAX_ROWS
    groups: int      # consumer warps that share a tile, each its own keys
    slot: int        # shared-memory rows a page takes (bf16; fp32: 0)
    pages: int       # pages a stage (bf16; fp32: 0)
    keys: int        # rows a stage: pages * slot (bf16; fp32: 0)
    stages: int      # stages in flight (bf16; fp32: 0)
    span: int        # pages a split
    splits: int      # splits a table row (1: no merge pass)
    blocks: int      # the grid
    smem: int        # shared memory a block, bytes
    why: str         # why the grid stays under SMS blocks, if it does


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def smem_bytes(dh: int, stages: int, keys: int, tiles: int,
               span: int) -> int:
    """The bf16 kernel's dynamic shared memory (``Tc::smem``): 1 KB of
    alignment slack; the ring of `stages` K and V stages of `keys` rows,
    or the warps' partial states (O rows of dh + 8 fp32, max and sum)
    where those are larger; Q (16 x `tiles` rows of dh + 8 bf16); the
    split's `span` table entries; the rows' positions; the mbarriers."""
    ring = max(2 * stages * keys * dh * 2, 4 * CONSUMERS * 16 * (dh + 8 + 2))
    return (1024 + ring + 16 * tiles * (dh * 2 + 16) + 16 * (-(-span // 4))
            + 4 * MAX_ROWS + 8 * 2 * MAX_STAGES)


def smem_bytes_f32(dh: int, G: int) -> int:
    """The fp32 kernel's static shared memory: the split's table entries
    and the warps' partial states (acc[G][dh], m and l per head)."""
    return 4 * MAX_SPAN + 4 * NUM_WARPS * G * (dh + 2)


def _splits(pairs: int, n_pages: int, P: int, widest: int, want: int):
    """(span, splits): a table row's n_pages cut into about `want` runs
    of `span` pages, at most `widest` pages a split, at least
    MIN_SPLIT_POSITIONS positions."""
    min_span = max(1, -(-MIN_SPLIT_POSITIONS // P))
    span = min(widest, n_pages, max(min_span, -(-n_pages // max(1, want))))
    return span, -(-n_pages // span)


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, Hq: int, Hk: int, dh: int, n_pages: int, P: int,
         dtype: torch.dtype = torch.bfloat16,
         resident: Optional[int] = None) -> Plan:
    """Pick the kernel's layout for one call of B table rows with S query
    rows each.  bf16: a block per (split, kv-head, table row, chunk)
    packs the G*S rows of the KV group, or a chunk of MAX_ROWS of them
    where there are more, into 1, 2 or 4 16-row tiles (four consumer
    warps: 4 share a tile's keys, 2 and 2, or one a tile); a page takes a
    slot of P rounded up to a power of two (at least 8) rows; a stage
    whole pages of at least STAGE_KEYS rows; splits only where the
    (table row, kv-head, chunk) triples are fewer than the SMs (see
    FEW_ROWS); the most stages (at most 4, no more than a split walks)
    that keep `resident` blocks an SM (the card's `blocks_per_sm`,
    default RESIDENT), else that fit.  fp32: a block per (split,
    kv-head, query row), as many rows as B*S, its splits giving at least
    TARGET_BLOCKS blocks."""
    G = Hq // Hk
    if dtype != torch.bfloat16:
        pairs = B * S * Hk
        span, splits = _splits(pairs, n_pages, P, MAX_SPAN,
                               -(-TARGET_BLOCKS // pairs))
        blocks = splits * Hk * B * S
        return Plan(G, 0, 0, 0, 0, 0, 0, 0, span, splits, blocks,
                    smem_bytes_f32(dh, G), _why(blocks, pairs, span, splits, P))
    if P > MAX_SLOT:
        raise ValueError(f"paged_attention: page size {P} (at most "
                         f"{MAX_SLOT}) past the bf16 kernel's TMA box")
    rows = min(G * S, MAX_ROWS)
    tiles = _pow2_at_least(-(-rows // 16))
    chunks = -(-G * S // (16 * tiles))
    groups = CONSUMERS // tiles
    slot = max(8, _pow2_at_least(P))
    pages = max(1, STAGE_KEYS // slot)
    keys = pages * slot
    resident = resident or RESIDENT[dh]
    pairs = B * Hk * chunks
    want = 1
    if pairs < SMS:
        want = (-(-2 * SMS // pairs) if rows <= FEW_ROWS else SMS // pairs)
    span, splits = _splits(pairs, n_pages, P, n_pages, want)
    walk = -(-span // pages)                        # stages a split walks
    fit = [s for s in range(1, min(MAX_STAGES, walk) + 1)
           if smem_bytes(dh, s, keys, tiles, span) <= SMEM_LIMIT]
    keep = [s for s in fit if resident * (
        smem_bytes(dh, s, keys, tiles, span) + 1024) <= SMEM_SM]
    stages = max(keep or fit)
    blocks = splits * pairs
    return Plan(rows, tiles, chunks, groups, slot, pages, keys, stages, span,
                splits, blocks, smem_bytes(dh, stages, keys, tiles, span),
                _why(blocks, pairs, span, splits, P, rows))


@functools.lru_cache(maxsize=None)
def blocks_per_sm(dh: int) -> int:
    """bf16 blocks of head dim `dh` that an SM of the card holds by
    registers and threads: the occupancy calculator on the kernel as
    built (no shared memory asked), what the wrapper plans with."""
    n = build.load("paged_attention").paged_tc_blocks_per_sm(dh, 0)
    if n < 1:
        raise RuntimeError(f"paged_attention: no occupancy for dh {dh}")
    return n


def _why(blocks: int, pairs: int, span: int, splits: int, P: int,
         rows: int = 0) -> str:
    """Why a grid stays under SMS blocks (`pairs`: the blocks of one
    split): a split takes at least MIN_SPLIT_POSITIONS positions, so a
    short table has few splits; and a
    bf16 block of more than FEW_ROWS rows plans one block an SM, which a
    whole number of splits can leave short of SMS."""
    if blocks >= SMS:
        return ""
    head = f"{pairs} blocks a split x {splits} splits of {span} pages " \
           f"of {P}"
    if rows > FEW_ROWS and span > -(-MIN_SPLIT_POSITIONS // P):
        return (f"{head}: one block an SM for {rows} rows a block, "
                f"{SMS - blocks} SMs idle")
    return f"{head}: a split takes at least {MIN_SPLIT_POSITIONS} positions"


def workspace_numel(p: Plan, B: int, S: int, Hq: int, dh: int) -> int:
    """fp32 elements of the splits' partials (acc[dh], m, l per query row,
    q-head and split), merged by a second kernel; none with one split,
    whose block writes the output."""
    return 0 if p.splits == 1 else B * S * Hq * p.splits * (dh + 2)


def box_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
              block_tables: torch.Tensor):
    """Pages of more than MAX_SLOT positions (taller than a TMA box) as k
    sub-pages each of the largest divisor of P within a box: page j of a
    row becomes sub-pages j*k .. j*k + k - 1 of the same (viewed) pool,
    every position where it was.  Returns the pools and the table."""
    Np, P, Hk, dh = k_pool.shape
    sub = max(d for d in range(1, MAX_SLOT + 1) if P % d == 0)
    k = P // sub
    bt = (block_tables[:, :, None] * k + torch.arange(
        k, dtype=block_tables.dtype, device=block_tables.device))
    return (k_pool.view(Np * k, sub, Hk, dh), v_pool.view(Np * k, sub, Hk, dh),
            bt.reshape(block_tables.shape[0], -1))


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    pos: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B,Hq,dh) with pos (B,), or (B,S,Hq,dh)
    with pos (B,S) (query (b, i) attends 0..pos[b, i] through table row
    b); k/v_pool: (Np,P,Hk,dh) contiguous; block_tables: (B,n) int32 with
    unit column stride (a column crop of a wider table is fine); pos
    int32.  Any page size: bf16 pages past MAX_SLOT positions are read as
    sub-pages.  Page ids are trusted: every id the kernel follows (entries
    j <= max_i pos[b, i] // P) must name a pool page.  Returns q's shape
    in q.dtype."""
    rows = q.dim() == 4
    if not rows and q.dim() != 3:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}; want "
                         f"(B,Hq,dh) or (B,S,Hq,dh)")
    B, S = q.shape[0], q.shape[1] if rows else 1
    Hq, dh = q.shape[-2:]
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)}")
    Np, P, Hk, dh_k = k_pool.shape
    if dh_k != dh or Hq % Hk:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}")
    if dh not in HEAD_DIMS or Hq // Hk not in GROUPS:
        raise ValueError(f"paged_attention: head_dim {dh} (want {HEAD_DIMS})"
                         f" or group {Hq // Hk} (want {GROUPS}) unsupported")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or pos.shape != q.shape[:-2]):
        raise ValueError(f"paged_attention: block_tables "
                         f"{tuple(block_tables.shape)} / pos "
                         f"{tuple(pos.shape)} for q {tuple(q.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("pos", pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} is not on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"paged_attention: {name} dtype {t.dtype}; "
                             f"want float32 or bfloat16, one for all")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             f"aligned (the kernels copy 16 bytes at a "
                             f"time)")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and pos must be int32")
    if block_tables.stride(1) != 1 or not pos.is_contiguous():
        raise ValueError("paged_attention: block_tables rows / pos must be "
                         "unit-stride")
    if q.dtype == torch.bfloat16 and P > MAX_SLOT:
        k_pool, v_pool, block_tables = box_pages(k_pool, v_pool,
                                                 block_tables)
        Np, P = k_pool.shape[:2]
    n_pages = block_tables.shape[1]
    p = plan(B, S, Hq, Hk, dh, n_pages, P, q.dtype,
             blocks_per_sm(dh) if q.dtype == torch.bfloat16 else None)
    sc = scale if scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    ws = torch.empty(workspace_numel(p, B, S, Hq, dh), dtype=torch.float32,
                     device=q.device)
    lib = build.load("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws.numel() else None, B, S, Hq, Hk, dh, P, Np,
            n_pages, block_tables.stride(0), p.splits, p.span, p.tiles,
            max(0, p.slot.bit_length() - 1), p.pages, p.stages,
            ctypes.c_float(sc), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
