"""Ape-X style prioritized experience replay (survey ref 104).

The port of the JAX package's ``rl/replay.py``.  A fixed-capacity ring
buffer holding transitions with per-item priorities p_i = |TD error|^alpha;
sampling is proportional to priority with importance-sampling weights
w_i = (N p_i)^-beta / max w.  The buffer is a tuple of tensors on one
device; add and update return a new buffer and leave the old one as it
was, as JAX's do.  The cursor and the size are host integers: they
follow from the batch sizes alone.

Sampling is explicit: ``replay_sample`` takes ``noise``, a generator or
the float32 uniforms (batch,) themselves, and inverts the priorities'
cumulative sum at ``total * (1 - u)``, which is how
``jax.random.choice(key, n, (batch,), p=p)`` draws.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple, Union

import torch

Pytree = Any


class Replay(NamedTuple):
    storage: Pytree              # dict of leaves (capacity, ...)
    priorities: torch.Tensor     # (capacity,) p^alpha, 0 = empty slot
    cursor: int                  # next write slot
    size: int                    # items stored


def replay_init(capacity: int, item_spec: Pytree) -> Replay:
    """``item_spec``: a dict of tensors shaped, typed and placed like one
    item's leaves."""
    storage = {k: torch.zeros((capacity,) + tuple(s.shape), dtype=s.dtype,
                              device=s.device)
               for k, s in item_spec.items()}
    dev = next(iter(storage.values())).device
    return Replay(storage, torch.zeros(capacity, device=dev), 0, 0)


def _ring_index(rep: Replay, n: int) -> torch.Tensor:
    cap = rep.priorities.shape[0]
    return (rep.cursor + torch.arange(n, device=rep.priorities.device)) % cap


def replay_add(rep: Replay, items: Pytree, priorities: torch.Tensor,
               *, alpha: float = 0.6) -> Replay:
    """Add a batch of n items (leaves (n, ...)) with |TD| priorities."""
    n = priorities.shape[0]
    cap = rep.priorities.shape[0]
    idx = _ring_index(rep, n)
    storage = {k: buf.index_put((idx,), items[k].to(buf.dtype))
               for k, buf in rep.storage.items()}
    prios = rep.priorities.index_put(
        (idx,), torch.pow(torch.abs(priorities) + 1e-6, alpha))
    return Replay(storage, prios, (rep.cursor + n) % cap,
                  min(rep.size + n, cap))


def replay_sample(rep: Replay, noise: Union[torch.Tensor, torch.Generator],
                  batch: int, *, beta: float = 0.4
                  ) -> Tuple[Pytree, torch.Tensor, torch.Tensor]:
    """Returns (items, indices, is_weights).  ``noise``: float32 uniforms
    in [0, 1) of shape (batch,), or a generator that draws them."""
    dev = rep.priorities.device
    if isinstance(noise, torch.Generator):
        noise = torch.rand(batch, generator=noise, dtype=torch.float32,
                           device=noise.device).to(dev)
    p = rep.priorities / torch.clamp(torch.sum(rep.priorities), min=1e-9)
    cum = torch.cumsum(p, 0)
    idx = torch.searchsorted(cum, cum[-1] * (1 - noise))
    items = {k: buf[idx] for k, buf in rep.storage.items()}
    n = float(max(rep.size, 1))
    w = torch.pow(n * torch.clamp(p[idx], min=1e-12), -beta)
    return items, idx, w / torch.max(w)


def replay_update_priorities(rep: Replay, idx, td_errors,
                             *, alpha: float = 0.6) -> Replay:
    prios = rep.priorities.index_put(
        (idx,), torch.pow(torch.abs(td_errors) + 1e-6, alpha))
    return rep._replace(priorities=prios)
