"""Public wrappers around the attention kernels; model code calls these.

A CUDA tensor goes to the hand-written CUDA kernel, and a failed build or
launch raises; a CPU tensor goes to the kernel's plain PyTorch version.
Each wrapper carries ``launches``, a plain integer that counts kernel
launches (and nothing else), so a run can show that it went through the
kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref

# the TPU kernel tiles keys in blocks of 128; non-causal input whose key
# length does not fill whole blocks is refused there, and here alike
_TPU_BLOCK_K = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA flash attention.  q: (B,S,Hq,dh); k,v: (B,T,Hk,dh)."""
    T = k.shape[1]
    if not causal and T % min(_TPU_BLOCK_K, T):
        raise ValueError("non-causal flash requires T % block_k == 0 "
                         "(padding keys would receive weight)")
    if not q.is_cuda:
        return _ref.attention_ref(q, k, v, causal=causal, window=window)
    out = _fa.flash_attention(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    pos: torch.Tensor, *,
                    logical_len: Optional[int] = None) -> torch.Tensor:
    """Paged decode attention through a block table.

    q: (B,Hq,dh); k/v_pool: (Np,P,Hk,dh); block_tables: (B,n_max) int32;
    pos: (B,) int32.  logical_len crops the block table to
    ceil(logical_len / P) pages, so tables wider than the engine's
    cache_len cost nothing for their dead pages."""
    if logical_len is not None:
        P = k_pool.shape[1]
        block_tables = block_tables[:, :-(-logical_len // P)]
    if not q.is_cuda:
        return _ref.paged_attention_ref(q, k_pool, v_pool, block_tables, pos)
    out = _pa.paged_attention(q, k_pool, v_pool, block_tables, pos)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
    paged_attention.launches = 0
