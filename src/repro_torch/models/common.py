"""Shared building blocks: parameter descriptors, norms, RoPE, activations.

The PyTorch counterpart of the JAX package's ``models/common.py``.  The
descriptor tree is the single source of truth for parameter shapes, logical
axis names and initializers; ``init_params`` materializes it from a
``torch.Generator`` and ``param_pspecs`` resolves its names to specs under
the active axis env and mesh (``core/sharding.py``).  Weights keep the JAX
layout: ``dense`` takes ``w`` as ``(in, *out)``.
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
    # logical axis name per dim (None | "model" | "layers"), resolved by
    # the active AxisEnv; None: every dim replicated
    spec: Optional[Tuple[Optional[str], ...]] = None

    @property
    def names(self) -> Tuple[Optional[str], ...]:
        return self.spec if self.spec is not None else (None,) * len(
            self.shape)


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


def param_pspecs(tree):
    """Resolve the logical names of a descriptor tree to specs under the
    active AxisEnv and mesh (FSDP included)."""
    from repro_torch.core.sharding import resolve_param_spec
    return tree_map(lambda d: resolve_param_spec(d.shape, d.names), tree)


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


# --------------------------------------------------------------------------
# Vocab-parallel embedding gather
# --------------------------------------------------------------------------
class _VocabGather(torch.autograd.Function):
    """Rows `ids` of a table whose local shard holds vocab rows [lo, hi):
    the forward gathers the local rows, zeroes ids outside the range and
    sums the partial results over `groups` (the mesh dims the vocab is
    split over); the backward scatter-adds the output gradient into the
    local rows, with no communication (every rank holds the whole output
    gradient)."""

    @staticmethod
    def forward(ctx, table, ids, lo: int, groups):
        hi = lo + table.shape[0]
        inside = (ids >= lo) & (ids < hi)
        local = torch.where(inside, ids - lo, 0)
        out = table[local] * inside[..., None].to(table.dtype)
        for g in groups:
            torch.distributed.all_reduce(out, group=g)
        ctx.save_for_backward(local, inside)
        ctx.rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad):
        local, inside = ctx.saved_tensors
        g = grad * inside[..., None].to(grad.dtype)
        # the accumulating index_put of plain indexing's own backward
        # (deterministic on the card), so a whole table's gradient is
        # bit for bit the plain lookup's
        out = grad.new_zeros((ctx.rows, grad.shape[-1]))
        out.index_put_((local,), g, accumulate=True)
        return out, None, None, None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  For a DTensor table (vocab rows split over some
    mesh dims, the model axis of ``("model", None)``), a vocab-parallel
    gather: DTensor's own embedding op fails on a row-sharded table
    (its masked partial result reaches no matmul intact, and its
    backward cannot redistribute it).  A table dim 1 split by FSDP is
    gathered first.  The result is split over the mesh dims that split
    the ids (the batch) and replicated over the others."""
    from repro_torch.core.sharding import is_dtensor
    if not is_dtensor(table):
        return table[ids.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    want = [Shard(0) if p == Shard(0) else Replicate()
            for p in table.placements]
    vocab_dims = [i for i, p in enumerate(want) if p == Shard(0)]
    if is_dtensor(ids):
        # a mesh dim cannot split both the ids and the vocab
        id_pl = [Replicate() if i in vocab_dims else p
                 for i, p in enumerate(ids.placements)]
        ids = ids.redistribute(mesh, id_pl).to_local()
    else:
        id_pl = [Replicate()] * mesh.ndim
    # the table gradient: a partial sum over the mesh dims that split the
    # ids, its own rows over the vocab dims
    grad_pl = [Partial() if isinstance(id_pl[i], Shard) else want[i]
               for i in range(mesh.ndim)]
    local = table.redistribute(mesh, want).to_local(grad_placements=grad_pl)
    coord = mesh.get_coordinate()
    lo, span = 0, table.shape[0]
    for i in vocab_dims:      # mesh-dim-major chunks, as DTensor splits
        span //= mesh.size(i)
        lo += coord[i] * span
    out = _VocabGather.apply(local, ids.long(), lo,
                             [mesh.get_group(i) for i in vocab_dims])
    out_pl = [Shard(0) if isinstance(p, Shard) else Replicate()
              for p in id_pl]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


# --------------------------------------------------------------------------
# Vocab-parallel cross-entropy
# --------------------------------------------------------------------------
class _VocabCrossEntropy(torch.autograd.Function):
    """logsumexp(x) - x[label] by position over fp32 logits whose local
    shard holds vocab columns [lo, lo + V_local): the max, the sum of
    exp(x - max) and the gold logit are reduced over `groups` (the mesh
    dims the vocab is split over) as (B, S) partials.  The backward
    writes g * (softmax - onehot) into the local columns, with no
    communication.  Nothing of (B, S, V) beyond the local shard's fp32
    copy is ever allocated."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, groups):
        x = logits.float()
        m = x.amax(dim=-1)
        for g in groups:
            torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                         group=g)
        s = (x - m[..., None]).exp_().sum(dim=-1)
        inside = (labels >= lo) & (labels < lo + x.shape[-1])
        local = torch.where(inside, labels - lo, 0)
        gold = torch.where(inside, x.gather(-1, local[..., None])[..., 0],
                           0.0)
        for g in groups:
            torch.distributed.all_reduce(s, group=g)
            torch.distributed.all_reduce(gold, group=g)
        ctx.save_for_backward(logits, m, s, local, inside)
        return torch.log(s) + m - gold

    @staticmethod
    def backward(ctx, grad):
        logits, m, s, local, inside = ctx.saved_tensors
        # the cotangents in the order JAX's autodiff of logsumexp and of
        # the gold pick forms them: exp(x - max) * (g / sum), then - g
        p = (logits.float() - m[..., None]).exp_().mul_((grad / s)[..., None])
        p.scatter_add_(-1, local[..., None], -(grad * inside)[..., None])
        return p.to(logits.dtype), None, None, None


def vocab_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy by position, (B, S) fp32, of (B, S, V) logits against
    (B, S) labels: logsumexp of the fp32 logits less the gold logit.  One
    formula for plain tensors and DTensors.  DTensor logits keep their
    vocab dim split (over the mesh dims that split it) and their batch
    rows; each rank reduces its own columns and the partials are summed
    as (B, S), so no rank holds the whole vocab.  The result is a DTensor
    split like the logits' batch rows."""
    from repro_torch.core import sharding as SH
    if not SH.is_dtensor(logits):
        return _VocabCrossEntropy.apply(logits, labels.long(), 0, [])
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.dim() - 1
    want = [p if isinstance(p, Shard) and p.dim % logits.dim() in (0, last)
            else Replicate() for p in logits.placements]
    logits = logits.redistribute(mesh, want)
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in want]
    if SH.is_dtensor(labels):
        labels = labels.redistribute(mesh, rows).to_local()
    else:
        labels = labels[SH.local_slice(logits, 0)]
    groups = [mesh.get_group(i) for i, p in enumerate(want)
              if isinstance(p, Shard) and p.dim % logits.dim() == last]
    nll = _VocabCrossEntropy.apply(
        logits.to_local(grad_placements=want), labels.long(),
        SH.local_slice(logits, last).start, groups)
    return DTensor.from_local(nll, mesh, rows, run_check=False)
