"""Data parallelism with the survey's aggregation / communication variants.

The PyTorch counterpart of the JAX package's ``core/data_parallel.py``.
The worker dimension is explicit, as there: per-worker state (params_w,
opt_states_w, EASGD replicas, gradients) carries a leading axis W, and
the W workers run on one device, one after another.  ``jax.vmap`` over W
becomes a loop over W whose results are stacked, ``lax.scan`` over K
local steps a loop over K, and the mean over W is the aggregation.

Implemented survey techniques (§Distributed deep learning / data parallelism):
  * synchronous S-SGD with All-Reduce aggregation            [refs 73, 92-94]
  * parameter-server aggregation (gather-to-root + broadcast) [ref 72, 67]
  * local SGD / bounded staleness (Downpour's async adaptation) [ref 67]
  * EASGD: elastic averaging against a center variable        [ref 68]
  * DETSGRAD: event-triggered communication                   [ref 69]
  * natural compression of gradient traffic                   [ref 75]
  * DBS: dynamic batch sizing by worker throughput            [ref 71]

``loss_fn(params, batch)`` is any differentiable torch function of a
parameter tree (for the LM: ``lambda p, b: lm_loss(p, cfg, b)``); its
gradients come from ``torch.autograd.grad``.  Each step function returns
(new_state..., metrics) where metrics hold ``comm_bytes`` and
``comm_events``, integers equal to the JAX package's.

Randomness is explicit, as in ``core/compression.py``: the compressed
aggregate takes ``noise``, a tree of float32 uniforms shaped like the
worker-stacked gradients, or a ``torch.Generator`` that draws them leaf
by leaf in sorted-key order.  The aggregate compresses with
``natural_compress``, which does not clip, as the JAX aggregate does; the
one byte an element in ``comm_bytes`` is the account of the wire format.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.core import sharding as SH
from repro_torch.core.compression import natural_compress, uniforms_like
from repro_torch.models.common import tree_leaves, tree_map

Pytree = Any
Noise = Union[Pytree, torch.Generator, None]


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def value_and_grad(loss_fn: Callable, params: Pytree, batch: Pytree):
    """(loss, grads) of loss_fn at params; grads mirror params (zeros
    where the loss does not reach a leaf, as in JAX), params untouched.
    A DTensor parameter's gradient comes back laid out as the parameter
    (its partial sums over the data axes reduced: the data-parallel
    all-reduce)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda p: _like(next(grads), p), params)


def _like(g, p):
    if not SH.is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def worker_mean(t: torch.Tensor) -> torch.Tensor:
    """The fp32 mean over the leading worker axis, computed as XLA computes
    ``jnp.mean``: the sum times 1/W, which rounds differently from the sum
    divided by W, so means equal the JAX package's bit for bit."""
    return t.float().sum(0) * (1.0 / t.shape[0])


def _row(tree: Pytree, i: int) -> Pytree:
    return tree_map(lambda t: t[i], tree)


def _stack(rows) -> Pytree:
    return tree_map(lambda *ts: torch.stack(ts), *rows)


def _num_workers(tree_w: Pytree) -> int:
    return tree_leaves(tree_w)[0].shape[0]


def per_worker_grads(loss_fn: Callable, params: Pytree, batches: Pytree):
    """batches have leading worker axis W; params are shared (replicated).
    Returns (losses (W,), grads with leading W).  The stacked gradients
    are filled a worker at a time, so at most one worker's unstacked
    gradients are held beside them."""
    W = _num_workers(batches)
    losses, grads_w = [], None
    for w in range(W):
        loss, g = value_and_grad(loss_fn, params, _row(batches, w))
        losses.append(loss)
        if grads_w is None:
            grads_w = tree_map(lambda t: t.new_empty((W,) + t.shape), g)
        tree_map(lambda dst, src: dst[w].copy_(src), grads_w, g)
        del g
    return torch.stack(losses), grads_w


# ---------------------------------------------------------------------------
# Aggregation modes (survey: parameter server vs All-Reduce)
# ---------------------------------------------------------------------------
def aggregate(grads_w: Pytree, mode: str = "allreduce",
              noise: Noise = None) -> Tuple[Pytree, Dict[str, Any]]:
    """grads_w: gradients with leading worker axis W.

    "allreduce": every worker ends with the mean (ring/torus collective —
      wire bytes per worker ≈ 2·P·(W-1)/W for reduce-scatter+all-gather).
    "ps": workers send to a root which averages and broadcasts (root link
      carries W·P in + W·P out — the PS bottleneck the survey describes).
    With `noise`, worker->aggregator traffic is natural-compressed
    (unbiased); each stacked leaf is compressed with its own uniforms and
    averaged before the next leaf is compressed.
    """
    W = _num_workers(grads_w)
    compressed = noise is not None
    if isinstance(noise, torch.Generator):
        mean = tree_map(lambda g: worker_mean(natural_compress(
            g, uniforms_like(g, noise))), grads_w)
    elif compressed:
        mean = tree_map(lambda g, u: worker_mean(natural_compress(g, u)),
                        grads_w, noise)
    else:
        mean = tree_map(worker_mean, grads_w)

    n_elems = sum(t.numel() // W for t in tree_leaves(grads_w))
    elem_bytes = 1 if compressed else 4
    if mode == "allreduce":
        per_worker = 2 * n_elems * (W - 1) // W * elem_bytes
        comm = {"comm_bytes": per_worker * W, "bottleneck_link_bytes": per_worker}
    elif mode == "ps":
        comm = {"comm_bytes": 2 * W * n_elems * elem_bytes,
                "bottleneck_link_bytes": 2 * W * n_elems * elem_bytes}
    else:
        raise ValueError(mode)
    comm["comm_events"] = W
    return mean, comm


def sync_step(loss_fn, params, opt, opt_state, batches_w, *,
              mode="allreduce", noise: Noise = None):
    """Synchronous S-SGD: one data-parallel step (survey Fig. 2)."""
    losses, grads_w = per_worker_grads(loss_fn, params, batches_w)
    g, comm = aggregate(grads_w, mode, noise)
    del grads_w
    new_params, new_state = opt.update(g, opt_state, params)
    metrics = {"loss": losses.mean(), **comm}
    return new_params, new_state, metrics


# ---------------------------------------------------------------------------
# Local SGD (bounded-staleness adaptation of Downpour's async updates)
# ---------------------------------------------------------------------------
def local_sgd_round(loss_fn, params_w, opt, opt_states_w, batches_wk, *,
                    sync: bool = True):
    """K local steps per worker, then (optionally) average.

    params_w: worker-stacked params (W, ...); batches_wk: (W, K, ...).
    The workers run one after another, so Downpour's asynchrony is
    reproduced as bounded staleness K, as in the JAX package.  After the
    average every worker's row is a copy of its own (the rows are real
    tensors, not views of one row).
    """
    W = _num_workers(params_w)
    K = tree_leaves(batches_wk)[0].shape[1]
    rows_p, rows_s, losses = [], [], []
    for w in range(W):
        p, s = _row(params_w, w), _row(opt_states_w, w)
        for k in range(K):
            batch = tree_map(lambda b: b[w, k], batches_wk)
            loss, g = value_and_grad(loss_fn, p, batch)
            p, s = opt.update(g, s, p)
            losses.append(loss)
        rows_p.append(p)
        rows_s.append(s)
    params_w, opt_states_w = _stack(rows_p), _stack(rows_s)
    del rows_p, rows_s
    comm_bytes = 0
    if sync:
        mean = tree_map(worker_mean, params_w)
        params_w = tree_map(
            lambda m, p: m.to(p.dtype).unsqueeze(0).repeat(
                (W,) + (1,) * m.dim()), mean, params_w)
        comm_bytes = 2 * tree_bytes(mean) * (W - 1)
    return params_w, opt_states_w, {"loss": torch.stack(losses).mean(),
                                    "comm_bytes": comm_bytes}


# ---------------------------------------------------------------------------
# EASGD (ref 68): elastic force against a center variable
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EASGDConfig:
    lr: float = 0.05
    rho: float = 0.1     # elastic coefficient (alpha = lr * rho)
    comm_every: int = 1  # tau: local steps between elastic updates


def easgd_round(loss_fn, params_w, center, batches_wk, cfg: EASGDConfig):
    """One communication round: tau local SGD steps then the elastic update.

      x_i <- x_i - lr*grad - alpha*(x_i - x~)
      x~  <- x~ + beta/W * sum_i (x_i - x~)       (beta = alpha * W)
    """
    alpha = cfg.lr * cfg.rho
    W = _num_workers(params_w)
    K = tree_leaves(batches_wk)[0].shape[1]
    rows, losses = [], []
    for w in range(W):
        p = _row(params_w, w)
        for k in range(K):
            loss, g = value_and_grad(loss_fn, p,
                                     tree_map(lambda b: b[w, k], batches_wk))
            p = tree_map(lambda x, gg: x - cfg.lr * gg, p, g)
            losses.append(loss)
        rows.append(p)
    params_w = _stack(rows)
    del rows
    # elastic move toward/of the center
    diff = tree_map(lambda p, c: p - c[None], params_w, center)
    params_w = tree_map(lambda p, d: p - alpha * d, params_w, diff)
    center = tree_map(lambda c, d: c + alpha * d.sum(0), center, diff)
    comm = 2 * tree_bytes(center) * W
    return params_w, center, {"loss": torch.stack(losses).mean(),
                              "comm_bytes": comm}


# ---------------------------------------------------------------------------
# DETSGRAD (ref 69): event-triggered parameter broadcast
# ---------------------------------------------------------------------------
def detsgrad_step(loss_fn, params_w, bcast_w, step, batches_w, *,
                  lr: float = 0.05, c0: float = 1.0, decay: float = 0.505):
    """Each worker broadcasts its params only when the drift since its last
    broadcast exceeds the (decaying) threshold; consensus uses the latest
    broadcast copies.  Returns per-step comm events (the paper's metric).

      trigger_i:  ||x_i - x^_i||_1 >= c0 / (step+1)^decay

    The threshold is computed in float32, as JAX computes it.
    """
    mean_bc = tree_map(lambda b: worker_mean(b).to(b.dtype), bcast_w)
    dev = tree_leaves(params_w)[0].device
    step_f = torch.as_tensor(step, device=dev).to(torch.float32)
    thresh = c0 / torch.pow(step_f + 1.0, decay)
    rows_p, rows_b, fires, losses = [], [], [], []
    for w in range(_num_workers(params_w)):
        # consensus step pulls toward the mean of broadcast copies
        p = tree_map(lambda x, m: 0.5 * x[w] + 0.5 * m, params_w, mean_bc)
        loss, g = value_and_grad(loss_fn, p, _row(batches_w, w))
        p = tree_map(lambda x, gg: x - lr * gg, p, g)
        bhat = _row(bcast_w, w)
        drift = 0
        for x, h in zip(tree_leaves(p), tree_leaves(bhat)):
            drift = drift + (x - h).abs().sum()
        fire = drift >= thresh
        rows_p.append(p)
        rows_b.append(tree_map(lambda x, h: torch.where(fire, x, h), p, bhat))
        fires.append(fire)
        losses.append(loss)
    n_fired = torch.stack(fires).sum()
    n_params = tree_bytes(mean_bc)
    metrics = {"loss": torch.stack(losses).mean(),
               "comm_events": n_fired,
               "comm_bytes": n_fired * n_params}
    return _stack(rows_p), _stack(rows_b), metrics


# ---------------------------------------------------------------------------
# DBS (ref 71): dynamic batch sizing from per-worker throughput
# ---------------------------------------------------------------------------
def dbs_partition(samples_per_sec, global_batch: int,
                  multiple: int = 1) -> torch.Tensor:
    """Split `global_batch` across workers proportional to throughput.

    Returns int32 batch sizes summing exactly to global_batch (largest-
    remainder rounding to `multiple`; ties in the remainder go to the
    lower worker index, by a stable sort as in JAX).  The rates are summed
    left to right in fp32, as XLA's CPU reduction adds them: torch's sum
    rounds like a float64 sum, and the last bit of the total can move a
    remainder past its neighbour's."""
    rates = torch.as_tensor(samples_per_sec, dtype=torch.float32)
    units = global_batch // multiple
    total = rates.new_zeros(())
    for r in rates:
        total = total + r
    rate = rates / total
    raw = rate * units
    base = torch.floor(raw).to(torch.int32)
    rem = units - base.sum()
    frac = raw - base
    rank = torch.argsort(torch.argsort(-frac, stable=True), stable=True)
    bump = (rank < rem).to(torch.int32)
    return (base + bump) * multiple


def dbs_epoch_time(samples_per_sec, split) -> torch.Tensor:
    """Synchronous epoch time = slowest worker (the survey's straggler cost)."""
    return torch.max(torch.as_tensor(split) / torch.as_tensor(samples_per_sec))
