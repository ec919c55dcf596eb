"""Mamba2 SSD chunk scan: the CUDA kernel (``csrc/ssd_scan.cu``) and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernel of the JAX package's
``kernels/ssd_scan.py``; ``reference`` is the plain version with the same
contract, which the CPU path and the tests use.  Both take any sequence
length: the last chunk may be ragged, where the JAX package asserts
``S % chunk == 0`` (padding the chunk with zero inputs and zero log decay
is exact; the kernel reads those zeros through bounds checks).

The kernel runs in three passes (chunk states, state passing, chunk scan)
over a float32 workspace that ``launch`` allocates.  It scans in tiles of
its own choosing (at most 128 rows, fewer where the shared memory of fp32
inputs at wide P and N would not fit); ``ssd_scan_tile`` in the library
reports the tile, which sizes the workspace.  Every chunk length gives
the same scan up to rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunk_len
from repro_torch.kernels.ref import ssd_scan_ref as reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WIDTHS = (16, 32, 64, 128)   # the head dims P and state sizes N it takes
MAX_CHUNK = 256              # the largest chunk the wrapper takes


def ssd_scan(xe: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 128):
    """Launch the CUDA kernel.  xe (B,S,H,P); b, c (B,S,N), contiguous,
    16-byte aligned CUDA tensors of one dtype (float32 or bfloat16); loga
    (B,S,H) contiguous float32.  Any S >= 1; Q = min(chunk, S) at most 256;
    P and N 16, 32, 64 or 128.  Returns y (B,S,H,P) and the final state
    (B,H,N,P), both float32; raises on what the kernel does not take."""
    if xe.dim() != 4:
        raise ValueError(f"ssd_scan: xe {tuple(xe.shape)}; want (B,S,H,P)")
    B, S, H, P = xe.shape
    N = b.shape[-1]
    if b.shape != (B, S, N) or c.shape != b.shape:
        raise ValueError(f"ssd_scan: b/c {tuple(b.shape)}/{tuple(c.shape)} "
                         f"do not match xe {tuple(xe.shape)}")
    if loga.shape != (B, S, H):
        raise ValueError(f"ssd_scan: loga {tuple(loga.shape)}; want "
                         f"{(B, S, H)}")
    Q = ssd_chunk_len(S, chunk)
    if Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {Q} > {MAX_CHUNK}")
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"ssd_scan: head dim {P} or state {N} not in "
                         f"{WIDTHS}")
    for name, t in (("xe", xe), ("loga", loga), ("b", b), ("c", c)):
        if not t.is_cuda or t.device != xe.device:
            raise ValueError(f"ssd_scan: {name} is not on {xe.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} is not 16-byte aligned")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != xe.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"ssd_scan: {name} dtype {t.dtype}; want xe's, "
                             f"float32 or bfloat16")
    if xe.dtype not in _DTYPES or loga.dtype != torch.float32:
        raise ValueError(f"ssd_scan: xe {xe.dtype} / loga {loga.dtype}; want "
                         f"float32 or bfloat16 / float32")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xe.device)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=xe.device)
    launch(xe, loga, b, c, y, final, Q)
    return y, final


def launch(xe, loga, b, c, y, final, chunk: int) -> None:
    """The bare launch on the current stream at the requested chunk,
    shapes read from xe and b, with its workspace.  Raises when the
    kernel refuses it (``ssd_scan`` checks first)."""
    B, S, H, P = xe.shape
    N = b.shape[-1]
    lib = build.load("ssd_scan")
    tile = lib.ssd_scan_tile(chunk, P, N, _DTYPES[xe.dtype])
    if tile <= 0:
        raise RuntimeError(f"ssd_scan kernel refuses chunk {chunk}, P {P}, "
                           f"N {N}, {xe.dtype}")
    # the (B,nc,H,N,P) chunk states, then the (B,nc,H) chunk decays
    ws = torch.empty(B * -(-S // tile) * H * (N * P + 1),
                     dtype=torch.float32, device=xe.device)
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            xe.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), final.data_ptr(), ws.data_ptr(), B, S, H, P, N,
            chunk, _DTYPES[xe.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
