"""Shared building blocks: parameter descriptors, norms, RoPE, activations.

The PyTorch counterpart of the JAX package's ``models/common.py``.  The
descriptor tree is the single source of truth for parameter shapes and
initializers; ``init_params`` materializes it from a ``torch.Generator``.
Weights keep the JAX layout: ``dense`` takes ``w`` as ``(in, *out)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# --------------------------------------------------------------------------
# Parameter descriptors
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones | small_normal
    fan_in: Optional[int] = None  # for 'normal': scale = 1/sqrt(fan_in)


# elements drawn in one piece (4 GiB of fp32)
DRAW_CHUNK = 1 << 30


def _materialize(desc: ParamDesc, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    dtype = torch_dtype(desc.dtype)
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=dtype, device=device)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=dtype, device=device)
    fan_in = desc.fan_in
    if fan_in is None:
        fan_in = desc.shape[-2] if len(desc.shape) >= 2 else desc.shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    if desc.init == "small_normal":
        scale = 0.02
    # drawn in fp32 chunks straight into the leaf's dtype, so a stacked
    # expert leaf at full width needs no full fp32 temporary; a leaf of
    # one chunk draws the same stream as one randn of its whole shape
    numel = math.prod(desc.shape)
    out = torch.empty(desc.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, numel, DRAW_CHUNK):
        m = min(DRAW_CHUNK, numel - i)
        x = torch.randn(m, generator=generator, dtype=torch.float32,
                        device=device)
        flat[i:i + m] = x.mul_(scale)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map over the leaves of a nested dict, and of trees of the same
    structure in `rest` (keys visited sorted, as JAX flattens dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict in sorted-key order (JAX's leaf order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_params(tree: Dict[str, Any], generator: torch.Generator,
                device: torch.device) -> Dict[str, Any]:
    """Materialize a descriptor tree; leaves are drawn in sorted-key order
    from ``generator``, which must live on ``device``."""
    return tree_map(lambda d: _materialize(d, generator, device), tree)


# --------------------------------------------------------------------------
# Numerics helpers
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: normalize over the head dim. x: (..., heads, head_dim)."""
    return rms_norm(x, scale, eps)


def activation_fn(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if kind == "squared_relu":
        return lambda x: F.relu(x).square()
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "swiglu":  # handled by caller (two projections)
        return F.silu
    raise ValueError(kind)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotate-half layout (the
    first half is x1), angle math in fp32, cast back to x.dtype."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * inv  # (B, S, d/2)
    sin, cos = ang.sin()[:, :, None, :], ang.cos()[:, :, None, :]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Generalized contraction: x (..., d) @ w (d, *out) -> (..., *out).

    Accumulates in fp32 and casts to x.dtype: fp32 inputs multiply in fp32
    (TF32 stays off), and a bf16 product accumulates in fp32 inside the
    GEMM before its bf16 result, as ``preferred_element_type`` does in JAX.
    """
    out_shape = x.shape[:-1] + w.shape[1:]
    w2 = w.reshape(w.shape[0], -1).to(x.dtype)
    y = torch.matmul(x, w2)
    return y.reshape(out_shape)
