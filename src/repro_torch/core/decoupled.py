"""Decoupled model-parallel training with delayed gradients
(survey §Model parallelism, refs 79 Zhuang et al. / 80 Huo et al. DDG).

The PyTorch counterpart of the JAX package's ``core/decoupled.py``.  A
network is split into K sequential modules placed on K workers.
Synchronous backprop serializes them (backward locking); DDG breaks the
lock: at every tick each module

  * consumes the activation its predecessor produced LAST tick, and
  * updates with the output-gradient its successor produced LAST tick,

so all K modules compute concurrently and a gradient reaches module k
with staleness (K-1-k).  Single-controller, as in JAX: the per-module
forward and vector-Jacobian products inside one tick read only last
tick's buffers, the property that lets a deployment run them in
parallel.  A module's VJP is ``torch.autograd.grad`` on its forward; its
input is detached from last tick's output, the counterpart of
``stop_gradient``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass
class DDGState:
    params: List[Pytree]              # per-module parameters
    act_in: List[Optional[Pytree]]    # module k's input from last tick
    grad_out: List[Optional[Pytree]]  # dL/d(out_k) from last tick
    tick: int = 0


def ddg_init(params: Sequence[Pytree]) -> DDGState:
    K = len(params)
    return DDGState(list(params), [None] * K, [None] * K, 0)


def _sgd(p: Pytree, g: Pytree, lr: float) -> Pytree:
    return tree_map(lambda a, b: (a - lr * b).detach(), p, g)


def _vjp(fn: Callable, p: Pytree, x, want_x: bool):
    """(y, vjp): y = fn(p, x) and vjp(gy, loss=None) -> (grads of p
    mirroring it, grad of x or None).  With `loss`, the cotangent is that
    scalar's (gy ignored)."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    xin = x.detach().requires_grad_(True) if want_x else x
    y = fn(leaves, xin)
    flat = tree_leaves(leaves)

    def vjp(gy, loss=None):
        out, grad_out = (loss, None) if loss is not None else (y, gy)
        inputs = flat + ([xin] if want_x else [])
        gs = torch.autograd.grad(out, inputs, grad_outputs=grad_out,
                                 materialize_grads=True)
        it = iter(gs[:len(flat)])
        return (tree_map(lambda _: next(it), p),
                gs[-1] if want_x else None)
    return y, vjp


def ddg_tick(state: DDGState, fns: Sequence[Callable], loss_fn: Callable,
             batch, *, lr: float = 0.05) -> Tuple[DDGState, dict]:
    """One decoupled tick.

    fns[k](params_k, x) -> y.  loss_fn(y_last, batch) -> scalar.
    batch feeds module 0 via batch["x"]; the loss reads batch (labels).

    Within the tick, every module's computation depends only on LAST
    tick's buffers: the decoupling that removes backward locking."""
    K = len(fns)
    p = state.params

    # ---- forward wave: module k consumes last tick's activation -------
    new_act = list(state.act_in)
    outs: List[Optional[torch.Tensor]] = [None] * K
    vjps: List[Optional[Callable]] = [None] * K
    for k in range(K):
        x = batch["x"] if k == 0 else state.act_in[k]
        if x is None:
            continue  # pipeline not yet filled
        with torch.enable_grad():
            outs[k], vjps[k] = _vjp(fns[k], p[k], x, want_x=k > 0)
    for k in range(K - 1):
        if outs[k] is not None:
            new_act[k + 1] = outs[k].detach()

    # ---- backward wave: delayed output-gradients -----------------------
    new_grad = list(state.grad_out)
    loss_val = None
    grads: List[Optional[Pytree]] = [None] * K
    for k in range(K):
        if vjps[k] is None:
            continue
        if k == K - 1:
            # the head computes a FRESH loss gradient on ITS current input
            with torch.enable_grad():
                loss = loss_fn(outs[k], batch)
            loss_val = loss.detach()
            gp, gx = vjps[k](None, loss=loss)
        else:
            gout = state.grad_out[k]  # successor's signal, one tick stale
            if gout is None:
                continue
            gp, gx = vjps[k](gout)
        grads[k] = gp
        if k > 0:
            new_grad[k - 1] = gx  # arrives at the predecessor NEXT tick

    # ---- apply ---------------------------------------------------------
    new_params = [_sgd(p[k], grads[k], lr) if grads[k] is not None else p[k]
                  for k in range(K)]
    metrics = {"loss": loss_val,
               "active_modules": sum(g is not None for g in grads)}
    return DDGState(new_params, new_act, new_grad, state.tick + 1), metrics


def sequential_step(params: Sequence[Pytree], fns: Sequence[Callable],
                    loss_fn: Callable, batch, *, lr: float = 0.05):
    """Reference: joint (locked) backprop through all modules."""
    leaves = [tree_map(lambda t: t.detach().requires_grad_(True), pk)
              for pk in params]
    with torch.enable_grad():
        y = batch["x"]
        for pk, fn in zip(leaves, fns):
            y = fn(pk, y)
        loss = loss_fn(y, batch)
        flat = [t for pk in leaves for t in tree_leaves(pk)]
        gs = iter(torch.autograd.grad(loss, flat, materialize_grads=True))
    grads = [tree_map(lambda _: next(gs), pk) for pk in params]
    new = [_sgd(pk, gk, lr) for pk, gk in zip(params, grads)]
    return new, loss.detach()
