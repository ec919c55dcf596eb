"""Step builders: the train step, prefill and decode ticks over the model.

The PyTorch counterpart of the JAX package's ``launch/steps.py``.
PyTorch runs eagerly, so a builder returns a plain closure where the JAX
one returns a function for ``jax.jit``.  The sharding specs and abstract
inputs of the JAX module belong to meshes and ahead-of-time lowering,
which the port does not have yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from repro_torch.core.compression import wire_roundtrip
from repro_torch.models import model as MD
from repro_torch.models.common import torch_dtype, tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import clip_by_global_norm


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def loss_and_grads(params, cfg: ModelConfig, batch):
    """(loss, grads) of ``lm_loss``: the port's ``jax.value_and_grad``.
    grads mirror params (a parameter that the loss does not reach gets
    zeros, as in JAX); params themselves are left untouched."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = MD.lm_loss(leaves, cfg, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def apply_grads(opt, params, opt_state, grads, max_norm: float = 1.0):
    """Clip to the global norm, then one optimizer update.  Returns
    (params, opt_state, gnorm)."""
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    params, opt_state = opt.update(grads, opt_state, params)
    return params, opt_state, gnorm


def make_train_step(cfg: ModelConfig, opt,
                    compress_grads: bool = False) -> Callable:
    """compress_grads: every gradient leaf goes through the natural-
    compression wire format and back before the optimizer (survey ref 75;
    the nc_pack/nc_unpack kernels on the card)."""
    def train_step(params, opt_state, batch,
                   noise: Optional[Union[Any, torch.Generator]] = None):
        """noise (compress_grads only): a tree of uniforms shaped like the
        params, or a generator to draw them from, one leaf after another
        in sorted-key order.  Without it, a generator seeded with the
        optimizer's step count draws fresh noise each step, as the JAX
        step folds its step counter into a fixed key."""
        loss, grads = loss_and_grads(params, cfg, batch)
        if compress_grads:
            if noise is None:
                step = opt_state["step"]
                noise = torch.Generator(device=step.device).manual_seed(
                    int(step))
            grads = wire_roundtrip(grads, noise)
        params, opt_state, gnorm = apply_grads(opt, params, opt_state, grads)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}
    return train_step


def make_extra(cfg: ModelConfig, B: int,
               device: torch.device) -> Optional[torch.Tensor]:
    """The stub modality frontends' output, zeros in the compute dtype as
    the JAX launchers give them (its ``batch_abstract`` shapes): vlm
    patches (B, num_patches, 1024), audio frames (B, encoder_seq,
    d_model); None for the text-only families."""
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.arch_type == "vlm":
        return torch.zeros((B, cfg.num_patches, MD.VISION_EMBED_DIM),
                           dtype=dt, device=device)
    if cfg.arch_type == "audio":
        return torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                           device=device)
    return None


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
