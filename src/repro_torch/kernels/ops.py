"""Public wrappers around the kernels; model and train-step code call these.

A CUDA tensor goes to the hand-written CUDA kernel, and a failed build or
launch raises; a CPU tensor goes to the kernel's plain PyTorch version.
Each wrapper carries ``launches``, a plain integer that counts kernel
launches (and nothing else), so a run can show that it went through the
kernels.

A kernel works on local shards.  Given DTensors (a step under a mesh,
``core/sharding.py``), `flash_attention`, `paged_attention` and
`nc_roundtrip` take each rank's local tensors, launch the kernel on the
local heads (or, for nc, the local elements), and wrap the result back
as a DTensor with the input's placements; ``launches`` counts each local
launch.

On ``device="meta"`` tensors (a step counted by `core/roofline.Counter`)
a wrapper launches nothing and runs no plain version: it records its
kernel's work (`roofline.kernel_cost`) with the counter and returns an
empty meta output of the kernel's shape.  Outside a counter a meta
tensor raises.

The attention kernels and the SSD scan have no backward, as the TPU
kernels they replace have none (``jax.grad`` through them raises): their
wrappers refuse inputs that require a gradient while autograd records, on
either device, rather than return a result cut off from the graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sharding as SH
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import nat_compress as _nc
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_scan as _ssd

def _on_meta(name: str, out: torch.Tensor, **cost) -> torch.Tensor:
    """A kernel call on meta tensors: its work recorded with the active
    counter, and `out` (empty) returned."""
    from repro_torch.core import roofline as RL
    counter = RL.active_counter()
    if counter is None:
        raise RuntimeError(f"{name}: meta tensors run only under "
                           f"core.roofline.Counter, which counts the "
                           f"kernel's work")
    counter.kernel(name, *RL.kernel_cost(name, **cost))
    return out


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has the TPU kernel it replaces): "
            f"run it under torch.no_grad(), or turn the kernel flag off to "
            f"differentiate through the plain version")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA flash attention.  q: (B,S,Hq,dh); k,v: (B,T,Hk,dh).  Any T:
    the kernel masks keys past T, where the TPU kernel pads them and so
    refuses a non-causal T that is not a multiple of its 128-key block
    (the whisper encoder's 1500 frames)."""
    if SH.is_dtensor(q):
        return SH.local_heads(
            lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                            window=window), q, k, v)
    _refuse_autograd("flash_attention", q, k, v)
    if q.is_meta:
        return _on_meta("flash_attention", torch.empty_like(q),
                        q=q.shape, k=k.shape, dtype=q.dtype, causal=causal,
                        window=window)
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

    q: (B,Hq,dh) with pos (B,), or (B,S,Hq,dh) with pos (B,S), S query
    rows sharing table row b (query (b, i) attends 0..pos[b, i]);
    k/v_pool: (Np,P,Hk,dh); block_tables: (B,n_max) int32.  logical_len
    crops the block table to ceil(logical_len / P) pages, so tables wider
    than the engine's cache_len cost nothing for their dead pages."""
    if SH.is_dtensor(q):
        # the pools hold the same heads as q on each rank
        out = paged_attention(q.to_local(), _local(k_pool), _local(v_pool),
                              _local(block_tables), _local(pos),
                              logical_len=logical_len)
        return _like(out, q)
    _refuse_autograd("paged_attention", q, k_pool, v_pool)
    if logical_len is not None:
        P = k_pool.shape[1]
        block_tables = block_tables[:, :-(-logical_len // P)]
    if q.is_meta:
        # positions are unknown: every table row reads its logical length
        # once, and every query row attends all of it
        C = block_tables.shape[1] * k_pool.shape[1]
        return _on_meta("paged_attention", torch.empty_like(q), q=q.shape,
                        pool=k_pool.shape, tables=block_tables.shape,
                        dtype=q.dtype, resident=q.shape[0] * C,
                        attended=pos.numel() * C)
    if not q.is_cuda:
        return _ref.paged_attention_ref(q, k_pool, v_pool, block_tables, pos)
    out = _pa.paged_attention(q, k_pool, v_pool, block_tables, pos)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def ssd_scan(xe: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 128):
    """Mamba2 SSD chunk scan.  xe (B,S,H,P) dt-scaled input; loga (B,S,H)
    float32 log decay; b, c (B,S,N).  Q = min(chunk, S); any S (a ragged
    last chunk is exact, where the JAX package asserts).  Returns
    (y (B,S,H,P), final state (B,H,N,P)), both float32."""
    _refuse_autograd("ssd_scan", xe, loga, b, c)
    if xe.is_meta:
        B, S, H, P = xe.shape
        out = (torch.empty(xe.shape, dtype=torch.float32, device="meta"),
               torch.empty((B, H, b.shape[-1], P), dtype=torch.float32,
                           device="meta"))
        return _on_meta("ssd_scan", out, xe=xe.shape, b=b.shape,
                        chunk=chunk, xe_dtype=xe.dtype, b_dtype=b.dtype)
    if not xe.is_cuda:
        return _ref.ssd_scan_ref(xe, loga, b, c, chunk)
    out = _ssd.ssd_scan(xe, loga, b, c, chunk=chunk)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0


def nc_pack(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Natural-compress to the uint8 wire format, with the caller's
    uniforms ``u`` (float32, x's shape) as the rounding noise."""
    if x.is_meta:
        return _on_meta("nc_pack", torch.empty(x.shape, dtype=torch.uint8,
                                               device="meta"),
                        n=x.numel(), in_dtype=x.dtype)
    if not x.is_cuda:
        return _nc.pack_reference(x, u)
    out = _nc.nc_pack(x, u)
    if x.numel():
        nc_pack.launches += 1
    return out


nc_pack.launches = 0


def nc_unpack(b: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The wire format back to ``dtype``: exactly sign * 2^(code - 70)."""
    if b.is_meta:
        return _on_meta("nc_unpack", torch.empty(b.shape, dtype=dtype,
                                                 device="meta"),
                        n=b.numel(), out_dtype=dtype)
    if not b.is_cuda:
        return _nc.unpack_reference(b, dtype)
    out = _nc.nc_unpack(b, dtype)
    if b.numel():
        nc_unpack.launches += 1
    return out


nc_unpack.launches = 0


def nc_roundtrip(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """pack + unpack: the on-device view of a compressed gradient
    (unbiased: E[nc_roundtrip(x, u)] = x over u, on the wire's range).
    For a DTensor x, u is whole (x's global shape): each rank packs its
    own elements with its own slice of u."""
    if SH.is_dtensor(x):
        return _like(nc_roundtrip(x.to_local(), _local_of(u, x)), x)
    return nc_unpack(nc_pack(x, u), dtype=x.dtype)


def _local(t):
    return t.to_local() if SH.is_dtensor(t) else t


def _like(out: torch.Tensor, x) -> torch.Tensor:
    """The local result `out` as a DTensor laid out as x."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False)


def _local_of(whole: torch.Tensor, x) -> torch.Tensor:
    """This rank's slice of the whole tensor `whole`, laid out as x."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(whole, x.device_mesh, x.placements,
                             src_data_rank=None).to_local()


def reset_launches() -> None:
    flash_attention.launches = 0
    paged_attention.launches = 0
    ssd_scan.launches = 0
    nc_pack.launches = 0
    nc_unpack.launches = 0
