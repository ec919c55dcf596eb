"""Flash attention: the CUDA kernel (``csrc/flash_attention.cu``) and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernel of the JAX package's
``kernels/flash_attention.py``; ``reference`` is the plain version with
the same semantics, which the CPU path and the tests use.

The bf16 kernel runs a `plan`, plain host arithmetic on the shapes: how
many query rows a block holds, which q-heads share them, how many K/V
stages are in flight and whether a query tile's keys are split over
blocks (tests/test_torch_flash_plan.py holds it on the CPU).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref as reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 192)

# the H100's streaming multiprocessors, and the dynamic shared memory one
# block may opt in to
SMS = 132
SMEM_LIMIT = 227 * 1024
SMEM_SM = 228 * 1024           # an SM's, 1 KB of it reserved per block
# the kernel's layout (csrc/flash_attention.cu): 64 query rows per
# consumer warpgroup, one or two of them (two at dh 192, whose O
# accumulator does not fit one warpgroup's registers at two blocks an
# SM); 64 keys a K/V tile; 2-4 stages
ROW_CHOICES = (128, 64)
MAX_DH_64_ROWS = 128
KEYS = 64
MAX_STAGES = 4
# a key split walks at least this many key tiles, or the merge costs more
# than the split saves
MIN_SPLIT_TILES = 2


class Plan(NamedTuple):
    rows: int        # query rows a block: 64 per consumer warpgroup
    keys: int        # keys a K/V tile
    stages: int      # K/V tiles in flight
    pack: int        # q-heads of one KV group sharing a block's rows
    positions: int   # query positions a block: rows // pack
    q_tiles: int     # blocks along the queries
    splits: int      # blocks along a query tile's keys (1: no merge pass)
    blocks: int      # the grid
    smem: int        # dynamic shared memory a block, bytes
    why: str         # why the grid stays under SMS blocks, if it does


def smem_bytes(rows: int, dh: int, stages: int) -> int:
    """Q, `stages` K and V tiles, 1 KB of alignment slack, the barriers."""
    return 2 * rows * dh + stages * 2 * (2 * KEYS * dh) + 1024 + 128


def _pack(G: int, rows: int) -> int:
    """The most q-heads of a group that divide it and fit in `rows`."""
    return max(d for d in range(1, min(G, rows) + 1) if G % d == 0)


def key_tiles(S: int, T: int, s0: int, s_end: int, causal: bool,
              window: Optional[int]) -> Tuple[int, int]:
    """(first key, key tiles) visible to any query of positions
    s0..s_end-1, from a tile boundary; queries end at key T-1."""
    off = T - S
    lo, hi = 0, T
    if causal:
        hi = min(T, s_end + off)
        if window is not None:
            lo = max(0, s0 + off - window + 1)
    if hi <= lo:
        return 0, 0
    lo = lo // KEYS * KEYS
    return lo, -(-(hi - lo) // KEYS)


def plan(B: int, S: int, T: int, Hq: int, Hk: int, dh: int,
         causal: bool = True, window: Optional[int] = None) -> Plan:
    """Pick the kernel's layout for one call.  128 rows a block (two
    consumer warpgroups sharing each K/V tile) where that leaves at least
    SMS blocks or dh is 192, else 64; then, while the grid is under SMS
    blocks, split the longest query tile's keys into runs of at least
    MIN_SPLIT_TILES tiles; then the most stages that fit (with 64 rows,
    that let two blocks share an SM)."""
    G = Hq // Hk
    for rows in ROW_CHOICES if dh <= MAX_DH_64_ROWS else ROW_CHOICES[:1]:
        pack = _pack(G, rows)
        positions = rows // pack
        q_tiles = -(-S // positions)
        blocks = q_tiles * (Hq // pack) * B
        if blocks >= SMS:
            break
    # the heaviest query tile: the last one under a causal mask
    longest = max(key_tiles(S, T, s0, min(s0 + positions, S), causal,
                            window)[1]
                  for s0 in {0, (q_tiles - 1) * positions})
    splits, why = 1, ""
    if blocks < SMS:
        splits = max(1, min(-(-SMS // blocks),
                            longest // MIN_SPLIT_TILES))
        if blocks * splits < SMS:
            why = (f"{B * S * Hq} query rows fill {blocks} blocks of "
                   f"{rows} rows; their keys ({longest} tiles of {KEYS} at "
                   f"most) split {splits} ways at {MIN_SPLIT_TILES} tiles "
                   f"a split")
    fit = [s for s in range(2, MAX_STAGES + 1)
           if smem_bytes(rows, dh, s) <= SMEM_LIMIT]
    two = [s for s in fit if 2 * (smem_bytes(rows, dh, s) + 1024) <= SMEM_SM]
    stages = max(two if rows == 64 and two else fit)
    return Plan(rows, KEYS, stages, pack, positions, q_tiles, splits,
                blocks * splits, smem_bytes(rows, dh, stages), why)


def workspace_numel(p: Plan, B: int, S: int, Hq: int, dh: int) -> int:
    """fp32 elements of the splits' partials (O, max and sum a row)."""
    return 0 if p.splits == 1 else p.splits * B * S * Hq * (dh + 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B,S,Hq,dh); k,v: (B,T,Hk,dh), all
    contiguous CUDA tensors of one dtype (float32 or bfloat16).  Returns
    (B,S,Hq,dh) in q.dtype; raises on what the kernel does not take."""
    B, S, Hq, dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    T, Hk = k.shape[1], k.shape[2]
    if Hq % Hk:
        raise ValueError(f"flash_attention: Hq {Hq} % Hk {Hk} != 0")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is not on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: {name} dtype {t.dtype}; "
                             f"want float32 or bfloat16, one for all")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} is not 16-byte "
                                 f"aligned (the bf16 kernel copies 16 "
                                 f"bytes at a time)")
    sc = scale if scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    work = None
    rows = pack = splits = stages = 0
    if q.dtype == torch.bfloat16:
        p = plan(B, S, T, Hq, Hk, dh, causal, window)
        rows, pack, splits, stages = p.rows, p.pack, p.splits, p.stages
        if splits > 1:
            work = torch.empty(workspace_numel(p, B, S, Hq, dh),
                               dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, Hq, Hk, dh, int(causal), int(window is not None),
            int(window or 0), ctypes.c_float(sc), _DTYPES[q.dtype],
            rows, pack, splits, stages,
            None if work is None else work.data_ptr(), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
