"""Optimizers over parameter trees (nested dicts of tensors), functional as
in the JAX package's ``optim/optimizers.py``: ``update`` returns new
parameter and state trees and leaves its inputs unchanged.

State trees mirror the parameters with float32 moments and an int32
``step`` and use the JAX package's keys (``mu``, ``nu``, ``f``/``r``/``c``/
``v``, ``step``), so a checkpoint carries them across the two packages.
A bf16 parameter updates in float32 and is cast back, as there.  The JAX
optimizers' sharding specs have no counterpart on one card and are not
ported.
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
    # the update is elementwise within a leaf (AdamW, SGD), so it may run
    # on slices of a leaf; Adafactor's factored moments and update clip
    # read the whole leaf
    elementwise: bool = True


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


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

    return Optimizer(init, update)


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

    return Optimizer(init, update)


def adafactor(lr: Callable, eps: float = 1e-30,
              decay: float = 0.8) -> Optimizer:
    """Factored second moments for >=2D params (row/col statistics)."""
    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1

    def init(params):
        def mk(p):
            if _factored(p):
                return {"r": _zeros_f32(p[..., 0]),
                        "c": _zeros_f32(p[..., 0, :])}
            return {"v": _zeros_f32(p)}
        return {"f": tree_map(mk, params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-decay)
        lr_t = lr(step - 1)

        def upd(p, g, f):
            g = g.float()
            g2 = g.square() + eps
            if _factored(p):
                r = beta * f["r"] + (1 - beta) * g2.mean(dim=-1)
                c = beta * f["c"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    r[..., None] * c[..., None, :] /
                    torch.clamp(r.mean(dim=-1, keepdim=True)[..., None],
                                min=eps))
                nf = {"r": r, "c": c}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                nf = {"v": v}
            upd_ = g / torch.clamp(denom, min=1e-12)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(upd_.square().mean() + 1e-12)
            upd_ = upd_ / torch.clamp(rms, min=1.0)
            return (p.float() - lr_t * upd_).to(p.dtype), nf

        out = tree_map(upd, params, grads, state["f"])
        return (tree_map(lambda o: o[0], out),
                {"f": tree_map(lambda o: o[1], out), "step": step})

    return Optimizer(init, update, elementwise=False)


def get_optimizer(name: str, lr_fn) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn)
    if name == "sgd":
        return sgd_momentum(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    raise ValueError(name)
