"""Natural compression to the uint8 wire format: the CUDA kernels
(``csrc/nat_compress.cu``) and their plain PyTorch versions.

The kernels replace the Pallas TPU kernels ``nc_pack`` and ``nc_unpack``
of the JAX package's ``kernels/nat_compress.py``; ``pack_reference`` and
``unpack_reference`` are the plain versions with the same semantics, which
the CPU path and the tests use.  The uniforms are an explicit input, as in
the TPU kernel, so the kernel and its plain version can be fed the same
draw and agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import nc_pack_ref as pack_reference
from repro_torch.kernels.ref import nc_unpack_ref as unpack_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} is not on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _launched(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def nc_pack(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch the pack kernel.  x: contiguous float32 or bfloat16 CUDA
    tensor; u: float32 uniforms in [0, 1) of x's shape, on x's device.
    Returns the uint8 codes in x's shape."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"nc_pack: x dtype {x.dtype}; want float32 or "
                         f"bfloat16")
    if u.dtype != torch.float32 or u.shape != x.shape:
        raise ValueError(f"nc_pack: u {u.dtype} {tuple(u.shape)}; want "
                         f"float32 {tuple(x.shape)}")
    _check("nc_pack: x", x, x.device)
    _check("nc_pack: u", u, x.device)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out
    lib = build.load("nat_compress")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nc_pack_fwd(x.data_ptr(), u.data_ptr(), out.data_ptr(),
                              x.numel(), _DTYPES[x.dtype], stream)
    _launched(err, "nc_pack")
    return out


def nc_unpack(b: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the unpack kernel.  b: contiguous uint8 CUDA tensor of codes.
    Returns sign * 2^(code - 70) (0 for code 0) in b's shape, as `dtype`
    (float32 or bfloat16; both exact)."""
    if b.dtype != torch.uint8:
        raise ValueError(f"nc_unpack: codes dtype {b.dtype}; want uint8")
    if dtype not in _DTYPES:
        raise ValueError(f"nc_unpack: dtype {dtype}; want float32 or "
                         f"bfloat16")
    _check("nc_unpack: codes", b, b.device)
    out = torch.empty(b.shape, dtype=dtype, device=b.device)
    if b.numel() == 0:
        return out
    lib = build.load("nat_compress")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nc_unpack_fwd(b.data_ptr(), out.data_ptr(), b.numel(),
                                _DTYPES[dtype], stream)
    _launched(err, "nc_unpack")
    return out
