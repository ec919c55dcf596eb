"""Flash attention: the CUDA kernel (``csrc/flash_attention.cu``) and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernel of the JAX package's
``kernels/flash_attention.py``; ``reference`` is the plain version with
the same semantics, which the CPU path and the tests use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref as reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 192)


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
    lib = build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, Hq, Hk, dh, int(causal), int(window is not None),
            int(window or 0), ctypes.c_float(sc), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
