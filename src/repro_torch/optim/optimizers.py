"""Optimizers over parameter trees (nested dicts of tensors), functional as
in the JAX package's ``optim/optimizers.py``: ``update`` returns new
parameter and state trees and leaves its inputs unchanged.

State trees mirror the parameters with float32 moments and an int32
``step`` and use the JAX package's keys (``mu``, ``nu``, ``f``/``r``/``c``/
``v``, ``step``), so a checkpoint carries them across the two packages.
A bf16 parameter updates in float32 and is cast back, as there.  Under a
mesh the moments of a DTensor parameter are DTensors laid out as it is
(``state_specs``: the moments take their parameters' specs, ``step`` is
replicated), and Adafactor's row and column statistics keep the splits
of the dims they keep.  Adafactor updates a DTensor leaf on each rank's
own shard: its row and column means, the mean of the row statistics and
the update's RMS add the ranks' partial sums over the mesh dims that
split the reduced dims, and no rank holds more of the leaf than its
shard.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # update(grads, state, params) -> (new params, new state)
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    # state_specs(param_specs) -> the state tree of specs
    state_specs: Callable[[Any], Any]
    # the update is elementwise within a leaf (AdamW, SGD), so it may run
    # on slices of a leaf; Adafactor's factored moments and update clip
    # read the whole leaf
    elementwise: bool = True


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """fp32 zeros of p's shape on p's device (a DTensor p: laid out as p)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def _stat_zeros(p: torch.Tensor, drop: int) -> torch.Tensor:
    """fp32 zeros of p's shape without dim `drop` (Adafactor's row or
    column statistics); for a DTensor p laid out as its spec with that
    dim removed (`adafactor`'s ``state_specs``): the other dims keep
    their splits, and a mesh dim that split `drop` holds it whole."""
    from repro_torch.core import sharding as SH
    shape = p.shape[:drop] + p.shape[drop + 1:]
    if not SH.is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pls = []
    for q in p.placements:
        d = q.dim % p.dim() if isinstance(q, Shard) else None
        pls.append(Replicate() if d is None or d == drop
                   else Shard(d - (d > drop)))
    mesh = p.device_mesh
    local = torch.zeros(SH.local_shape(shape, pls, mesh),
                        dtype=torch.float32, device=p.device)
    return DTensor.from_local(local, mesh, pls, run_check=False)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------------
def clip_scale(grads, max_norm: float):
    """(min(1, max_norm / (|grads| + 1e-9)), |grads|): the global norm
    summed over the leaves in leaf order in fp32."""
    gnorm = torch.sqrt(sum(g.float().square().sum()
                           for g in tree_leaves(grads)))
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0), gnorm


def clip_leaf(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / (|grads| + 1e-9)); returns
    (clipped grads, global norm), norms summed in leaf order in fp32."""
    scale, gnorm = clip_scale(grads, max_norm)
    return tree_map(lambda g: clip_leaf(g, scale), grads), gnorm


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Linear warmup to peak_lr over `warmup` steps, then cosine decay to
    floor * peak_lr at `total`; step is an int tensor, the rate fp32."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return sched


# ---------------------------------------------------------------------------
def sgd_momentum(lr: Callable, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_f32, params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"]
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
        lr_t = lr(step)
        new_p = tree_map(lambda p, m: (p.float() - lr_t * m).to(p.dtype),
                         params, mu)
        return new_p, {"mu": mu, "step": step + 1}

    def state_specs(pspecs):
        return {"mu": pspecs, "step": ()}

    return Optimizer(init, update, state_specs)


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_f32, params),
                "nu": tree_map(_zeros_f32, params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state["nu"], grads)
        lr_t = lr(step - 1)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype)

        return (tree_map(upd, params, mu, nu),
                {"mu": mu, "nu": nu, "step": step})

    def state_specs(pspecs):
        return {"mu": pspecs, "nu": pspecs, "step": ()}

    return Optimizer(init, update, state_specs)


class _Splits:
    """The process groups of the mesh dims that split each dim of a
    DTensor leaf (none for a plain tensor), and the means over a leaf's
    dims taken on its local shard.  Over a dim no mesh dim splits, the
    local mean (the plain update's own op); over a split dim, the local
    sum all-reduced over each splitting mesh dim in mesh-dim order, on
    every rank alike, then divided by the whole dim."""

    def __init__(self, p: torch.Tensor):
        from repro_torch.core import sharding as SH
        self.shape = tuple(p.shape)
        self.groups = []                       # (mesh dim, tensor dim, group)
        if SH.is_dtensor(p):
            from torch.distributed.tensor import Shard
            mesh = p.device_mesh
            for i, q in enumerate(p.placements):
                if isinstance(q, Shard) and mesh.size(i) > 1:
                    self.groups.append((i, q.dim % p.dim(),
                                        mesh.get_group(i)))

    def _sum(self, s: torch.Tensor, dims) -> torch.Tensor:
        import torch.distributed as dist
        for _, d, g in self.groups:
            if d in dims:
                dist.all_reduce(s, group=g)
        return s

    def mean(self, x: torch.Tensor, dim: int, of: int,
             keepdim: bool = False) -> torch.Tensor:
        """The mean of local `x` over its `dim`, the leaf's dim `of`."""
        of %= len(self.shape)
        if not any(d == of for _, d, _ in self.groups):
            return x.mean(dim=dim, keepdim=keepdim)
        return self._sum(x.sum(dim=dim, keepdim=keepdim), {of}) / \
            self.shape[of]

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of local `x`, shaped as the leaf's shard, over the
        whole leaf."""
        if not self.groups:
            return x.mean()
        return self._sum(x.sum(), {d for _, d, _ in self.groups}) / \
            math.prod(self.shape)


def adafactor(lr: Callable, eps: float = 1e-30,
              decay: float = 0.8) -> Optimizer:
    """Factored second moments for >=2D params (row/col statistics).  A
    DTensor leaf updates on each rank's shard (`_Splits`): the gradient
    laid out as the parameter, the statistics in their ``state_specs``
    layout, and each rank writes only its own elements."""
    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def mk(p):
            if _factored(p):
                return {"r": _stat_zeros(p, p.dim() - 1),
                        "c": _stat_zeros(p, p.dim() - 2)}
            return {"v": _zeros_f32(p)}
        return {"f": tree_map(mk, params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-decay)
        lr_t = lr(step - 1)

        def upd(p, g, f):
            from repro_torch.core import sharding as SH
            red = _Splits(p)
            if SH.is_dtensor(g) and g.placements != p.placements:
                g = g.redistribute(p.device_mesh, p.placements)
            g = SH.local(g).float()
            fl = {k: SH.local(v) for k, v in f.items()}
            g2 = g.square() + eps
            if _factored(p):
                n = p.dim()
                r = beta * fl["r"] + (1 - beta) * red.mean(g2, -1, of=n - 1)
                c = beta * fl["c"] + (1 - beta) * red.mean(g2, -2, of=n - 2)
                rmean = red.mean(r, -1, of=n - 2, keepdim=True)
                denom = torch.sqrt(
                    r[..., None] * c[..., None, :] /
                    torch.clamp(rmean[..., None], min=eps))
                nf = {"r": r, "c": c}
            else:
                v = beta * fl["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                nf = {"v": v}
            upd_ = g / torch.clamp(denom, min=1e-12)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(red.mean_all(upd_.square()) + 1e-12)
            upd_ = upd_ / torch.clamp(rms, min=1.0)
            new_p = (SH.local(p).float() - lr_t * upd_).to(p.dtype)
            return (SH.from_local_like(new_p, p),
                    {k: SH.from_local_like(v, f[k]) for k, v in nf.items()})

        out = tree_map(upd, params, grads, state["f"])
        return (tree_map(lambda o: o[0], out),
                {"f": tree_map(lambda o: o[1], out), "step": step})

    def state_specs(pspecs):
        def mk(spec):
            # row stats drop the last dim's split, col stats the 2nd-last
            if len(spec) >= 2:
                return {"r": spec[:-1], "c": spec[:-2] + spec[-1:]}
            return {"v": spec}
        return {"f": _spec_map(mk, pspecs), "step": ()}

    return Optimizer(init, update, state_specs, elementwise=False)


def _spec_map(fn, tree):
    """Map over the specs (tuples) of a nested dict."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def get_optimizer(name: str, lr_fn) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn)
    if name == "sgd":
        return sgd_momentum(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    raise ValueError(name)
