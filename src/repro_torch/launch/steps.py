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
from repro_torch.core.data_parallel import value_and_grad
from repro_torch.models import model as MD
from repro_torch.models.common import torch_dtype
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import clip_leaf, clip_scale


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def loss_and_grads(params, cfg: ModelConfig, batch):
    """(loss, grads) of ``lm_loss``: the port's ``jax.value_and_grad``.
    grads mirror params (a parameter that the loss does not reach gets
    zeros, as in JAX); params themselves are left untouched."""
    return value_and_grad(lambda p, b: MD.lm_loss(p, cfg, b), params, batch)


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _index(tree, sl):
    """The view `t[sl]` of every tensor of a tree."""
    if isinstance(tree, dict):
        return {k: _index(v, sl) for k, v in tree.items()}
    return tree[sl]


def _copy_into(dst, src) -> None:
    """Write the leaves of `src` into the tensors of `dst`, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


# elements of a leaf that an elementwise update takes at once: its fp32
# temporaries stay at 256 MB each however large the leaf (a stacked
# (L, ...) leaf of phi-3-vision-4.2b holds 1.6 G elements)
UPDATE_CHUNK = 1 << 26


def leaf_slices(p: torch.Tensor, elementwise: bool) -> list:
    """Row ranges of `p`'s leading dim of at most UPDATE_CHUNK elements,
    or the whole leaf."""
    if not elementwise or p.dim() == 0 or p.numel() <= UPDATE_CHUNK:
        return [...]
    rows = max(1, UPDATE_CHUNK // (p.numel() // p.shape[0]))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def apply_grads(opt, params, opt_state, grads, max_norm: float = 1.0):
    """Clip to the global norm, then one optimizer update, in place: the
    leaves of `params` and `opt_state` are overwritten, a leaf at a time
    (an elementwise optimizer's in slices of UPDATE_CHUNK elements), what
    the JAX launcher's `donate_argnums=(0, 1)` lets XLA do.  Returns
    (params, opt_state, gnorm), the same objects.  A whole-tree update
    would hold the old and the new parameters and moments at once (for
    AdamW 2 x (2 + 8) bytes a bf16 parameter); this one, the temporaries
    of one slice.  The bits are the whole-tree update's: an update reads
    nothing beyond the leaf, or the slice, it writes."""
    scale, gnorm = clip_scale(grads, max_norm)
    step = opt_state["step"]
    moments = [k for k in opt_state if k != "step"]
    new_step = None
    for path in _leaf_paths(params):
        p, g = _at(params, path), _at(grads, path)
        leaf = {k: _at(opt_state[k], path) for k in moments}
        for sl in leaf_slices(p, opt.elementwise):
            sub = {k: {"x": _index(v, sl)} for k, v in leaf.items()}
            sub["step"] = step
            new_p, new_s = opt.update({"x": clip_leaf(g[sl], scale)}, sub,
                                      {"x": p[sl]})
            p[sl].copy_(new_p["x"])
            for k in moments:
                _copy_into(_index(leaf[k], sl), new_s[k]["x"])
            new_step = new_s["step"]
    step.copy_(new_step)
    return params, opt_state, gnorm


def make_train_step(cfg: ModelConfig, opt,
                    compress_grads: bool = False) -> Callable:
    """compress_grads: every gradient leaf goes through the natural-
    compression wire format and back before the optimizer (survey ref 75;
    the nc_pack/nc_unpack kernels on the card).  The step updates its
    params and opt_state in place (`apply_grads`), so a caller must not
    hold on to them expecting the old values."""
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
