"""Serve step builders: prefill and decode ticks over the model.

The PyTorch counterpart of the serve half of the JAX package's
``launch/steps.py``.  PyTorch runs eagerly, so a builder returns a plain
closure where the JAX one returns a function for ``jax.jit``.  The train
step is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    def prefill_step(params, batch):
        logits, _, cache = MD.forward(
            params, cfg, batch["tokens"],
            extra_embeds=batch.get("extra_embeds"),
            return_cache=True, cache_len=cache_len)
        return logits[:, -1:], cache
    return prefill_step


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocab dim that returns the FIRST max index on ties,
    written out as the JAX version does (bf16 logits over a large vocab do
    tie, and the two packages must pick the same token)."""
    m = logits.max(dim=-1, keepdim=True).values
    V = logits.shape[-1]
    iota = torch.arange(V, device=logits.device, dtype=torch.int32)
    cand = torch.where(logits >= m, iota, V)
    return cand.min(dim=-1).values.to(torch.int32)


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = MD.decode_step(params, cfg, tokens, pos, cache)
        nxt = sharded_argmax(logits[:, -1])[:, None]
        return nxt, new_cache
    return serve_step


def make_serve_cb_step(cfg: ModelConfig) -> Callable:
    """Continuous-batching decode tick: one token for EVERY pool slot.
    Retired slots are no-ops: their cache rows are kept and their token is
    passed through unchanged."""
    def serve_cb_step(params, cache, tokens, pos, active):
        logits, new_cache = MD.decode_step(params, cfg, tokens, pos, cache,
                                           active=active)
        nxt = sharded_argmax(logits[:, -1])[:, None]
        nxt = torch.where(active[:, None], nxt, tokens)
        return nxt, new_cache
    return serve_cb_step


def make_paged_serve_cb_step(cfg: ModelConfig, logical_len: int) -> Callable:
    """Paged-pool variant of the continuous-batching tick: the cache's KV
    leaves are a shared page pool and each slot reads/writes through its
    block-table row.  logical_len is the dense cache_len the pool
    replaces."""
    def serve_cb_paged_step(params, cache, tokens, pos, active,
                            block_tables):
        logits, new_cache = MD.decode_step(params, cfg, tokens, pos, cache,
                                           active=active,
                                           block_tables=block_tables,
                                           logical_len=logical_len)
        nxt = sharded_argmax(logits[:, -1])[:, None]
        nxt = torch.where(active[:, None], nxt, tokens)
        return nxt, new_cache
    return serve_cb_paged_step
