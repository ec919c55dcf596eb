"""Paged-attention decode: the CUDA kernel (``csrc/paged_attention.cu``)
and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel of the JAX package's
``kernels/paged_attention.py``; ``reference`` is the plain version with
the same semantics, which the CPU path and the tests use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref as reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 192)
GROUPS = (1, 2, 4, 7, 8, 12)
_SMEM_LIMIT = 48 * 1024  # static launch limit without an opt-in attribute
# the kernel's layout (csrc/paged_attention.cu): 4 warps a block, a split
# takes at most MAX_SPAN pages (their table entries staged in shared memory)
NUM_WARPS = 4
MAX_SPAN = 64
# splits are planned to give at least TARGET_BLOCKS blocks: two for each of
# the H100's 132 SMs; a split takes at least MIN_SPLIT_POSITIONS positions,
# so short tables keep one split and no merge pass
TARGET_BLOCKS = 2 * 132
MIN_SPLIT_POSITIONS = 64


def plan_splits(B: int, Hk: int, n_pages: int, P: int):
    """(n_splits, span): split each row's n_pages table columns into
    n_splits runs of `span` pages, one block per (split, kv-head, row).
    Plain host arithmetic on the shapes: pos stays on the device."""
    want = -(-TARGET_BLOCKS // (B * Hk))           # splits per (row, head)
    min_span = max(1, -(-MIN_SPLIT_POSITIONS // P))
    span = min(MAX_SPAN, max(min_span, -(-n_pages // want)))
    return -(-n_pages // span), span


def smem_bytes(dh: int, G: int) -> int:
    """Static shared memory of one block: the split's table entries and
    the warps' partial states (acc[G][dh], m and l per head)."""
    return 4 * MAX_SPAN + 4 * NUM_WARPS * G * (dh + 2)


def workspace_numel(B: int, Hq: int, dh: int, n_splits: int) -> int:
    """fp32 elements of the splits' partials (acc[dh], m, l per row, q-head
    and split); none with one split, whose block writes the output."""
    return 0 if n_splits == 1 else B * Hq * n_splits * (dh + 2)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    pos: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B,Hq,dh); k/v_pool: (Np,P,Hk,dh)
    contiguous; block_tables: (B,n) int32 with unit column stride (a
    column crop of a wider table is fine); pos: (B,) int32.  Page ids are
    trusted: every id the kernel follows (entries j <= pos[b] // P) must
    name a pool page.  Returns (B,Hq,dh) in q.dtype."""
    B, Hq, dh = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)}")
    _, P, Hk, dh_k = k_pool.shape
    if dh_k != dh or Hq % Hk:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}")
    if dh not in HEAD_DIMS or Hq // Hk not in GROUPS:
        raise ValueError(f"paged_attention: head_dim {dh} (want {HEAD_DIMS})"
                         f" or group {Hq // Hk} (want {GROUPS}) unsupported")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or pos.shape != (B,)):
        raise ValueError(f"paged_attention: block_tables "
                         f"{tuple(block_tables.shape)} / pos "
                         f"{tuple(pos.shape)} for B={B}")
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
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and pos must be int32")
    if block_tables.stride(1) != 1 or not pos.is_contiguous():
        raise ValueError("paged_attention: block_tables rows / pos must be "
                         "unit-stride")
    G = Hq // Hk
    smem = smem_bytes(dh, G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: head_dim {dh}, group {G} needs "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT})")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             f"aligned (the kernel reads 16 bytes a lane)")
    n_pages = block_tables.shape[1]
    n_splits, span = plan_splits(B, Hk, n_pages, P)
    sc = scale if scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    ws = torch.empty(workspace_numel(B, Hq, dh, n_splits),
                     dtype=torch.float32, device=q.device)
    lib = build.load("paged_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws.numel() else None, B, Hq, Hk, dh, P,
            n_pages, block_tables.stride(0), n_splits, span,
            ctypes.c_float(sc), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
