"""Top-level decoder LM, dense family.

The PyTorch counterpart of the JAX package's ``models/model.py``.  Per-layer
parameters are stacked ``(L, ...)`` leaves as there; the layer
``lax.scan`` becomes a Python loop over layer slices.  KV caches are
updated in place where the JAX code donates the cache buffer.

Public entry points:
  model_descs / init_model
  forward(params, cfg, tokens, ...)           -> (logits, aux, cache|None)
  decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
  cache_specs / init_cache / write_cache_slot
  paged_leaf_names / init_paged_cache / write_paged_cache
  lm_loss(params, cfg, batch)                 -> scalar loss
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import mlp as M
from repro_torch.models.common import (ParamDesc, dense, init_params,
                                       rms_norm, torch_dtype, tree_map)
from repro_torch.models.config import ModelConfig

_PORTED = ("dense",)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in _PORTED:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet (ROADMAP.md "
            f"queue 1, other model families); ported: {_PORTED}")


# ---------------------------------------------------------------------------
# Parameter descriptor trees
# ---------------------------------------------------------------------------
def _stack(tree, L: int):
    return tree_map(lambda d: ParamDesc((L,) + d.shape, d.dtype, d.init,
                                        d.fan_in), tree)


def _norm_desc(cfg):
    return ParamDesc((cfg.d_model,), cfg.param_dtype, init="ones")


def _attn_mlp_block_descs(cfg: ModelConfig):
    return {"ln1": _norm_desc(cfg), "attn": A.attn_descs(cfg),
            "ln2": _norm_desc(cfg), "mlp": M.mlp_descs(cfg)}


def block_descs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    return _attn_mlp_block_descs(cfg)


def model_descs(cfg: ModelConfig) -> Dict[str, Any]:
    dt = cfg.param_dtype
    return {
        "embed": ParamDesc((cfg.vocab_size, cfg.d_model), dt,
                           init="small_normal"),
        "blocks": _stack(block_descs(cfg), cfg.num_layers),
        "final_norm": _norm_desc(cfg),
        "lm_head": ParamDesc((cfg.d_model, cfg.vocab_size), dt,
                             fan_in=cfg.d_model),
    }


def init_model(cfg: ModelConfig, generator: torch.Generator):
    """Random weights drawn from `generator`, on the generator's device."""
    return init_params(model_descs(cfg), generator, generator.device)


def _layer(blocks, i: int):
    return tree_map(lambda t: t[i], blocks)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def _attn_sublayer(p, x, positions, cfg):
    """Pre-norm attention sublayer; also returns the rope'd (k, v) for the
    decode cache (the layout `attention_decode` writes)."""
    pre = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = A._project_qkv(p["attn"], pre, positions, cfg)
    B, S = pre.shape[:2]
    window = (cfg.sliding_window
              if cfg.attention_kind == "sliding_window" else None)
    out = A.gqa_attend(q, k, v, cfg, causal=True, window=window)
    y = dense(out.reshape(B, S, -1), p["attn"]["wo"])
    return x + y, (k, v)


def _apply_attn_mlp(p, x, positions, cfg):
    x, kv = _attn_sublayer(p, x, positions, cfg)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + M.mlp(p["mlp"], h, cfg), kv


def _block(p, x, positions, cfg):
    return _apply_attn_mlp(p, x, positions, cfg)[0]


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra_embeds=None, return_cache: bool = False,
            cache_len: Optional[int] = None):
    """tokens: (B, S) int.  Returns (logits (B, S, V), aux_loss scalar,
    cache|None); the cache is {"k", "v"}: (L, B, cache_len, Hk, dh).

    With ``cfg.remat == "block"`` and autograd recording, each layer runs
    under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
    of the scan body): its activations are recomputed in the backward."""
    _require_ported(cfg)
    if extra_embeds is not None:
        raise NotImplementedError("modality prefixes are not ported yet "
                                  "(ROADMAP.md queue 1, other families)")
    B, S = tokens.shape
    cdt = torch_dtype(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(cdt)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    C = cache_len or S
    if C < S:
        raise ValueError(f"cache_len {C} < seq {S}")
    cache = None
    if return_cache:
        cache = A.init_kv_cache(cfg, B, C, cfg.num_layers, cdt, x.device)
    remat = (cfg.remat == "block" and torch.is_grad_enabled()
             and not return_cache)
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block, lp, x, positions, cfg, use_reentrant=False)
            continue
        x, (k, v) = _apply_attn_mlp(lp, x, positions, cfg)
        if return_cache:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = dense(x, params["lm_head"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------
def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos, cache,
                *, active=None, block_tables=None, logical_len=None):
    """tokens: (B,1) int; pos: () current sequence length, or (B,) — one
    position per row (continuous batching).

    active: optional (B,) bool (vector pos only) — rows where it is False
    are retired slots whose cache does not change.  block_tables: optional
    (B, n_max) int — PAGED mode over the pools of `init_paged_cache`;
    logical_len is the dense cache_len the pool replaces.

    The cache is updated in place.  Returns (logits (B,1,V), cache)."""
    _require_ported(cfg)
    if active is not None and torch.as_tensor(pos).dim() != 1:
        raise ValueError("active mask requires a per-row pos vector")
    x = params["embed"][tokens.long()].to(torch_dtype(cfg.compute_dtype))
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        pre = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _, _ = A.attention_decode(lp["attn"], pre, cache["k"][i],
                                     cache["v"][i], pos, cfg, active=active,
                                     block_tables=block_tables,
                                     logical_len=logical_len)
        x = x + y
        pre2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + M.mlp(lp["mlp"], pre2, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return dense(x, params["lm_head"]), cache


# ---------------------------------------------------------------------------
# Cache construction (for serving)
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    """name -> (shape, dtype) of the dense decode cache."""
    _require_ported(cfg)
    if cfg.attention_kind == "sliding_window":
        cache_len = min(cache_len, cfg.sliding_window)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    cdt = torch_dtype(cfg.compute_dtype)
    return {"k": (shape, cdt), "v": (shape, cdt)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: torch.device):
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in cache_specs(cfg, batch, cache_len).items()}


def paged_leaf_names(cfg: ModelConfig) -> tuple:
    """Cache leaves that page (position-indexed KV)."""
    _require_ported(cfg)
    return ("k", "v")


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, device: torch.device):
    """KV leaves as shared page pools (L, num_pages + 1, P, Hk, dh); the
    last page is the trash page of `attention.init_paged_kv_cache`.  The
    dense family has no per-slot leaves, so num_slots sizes nothing."""
    if cfg.attention_kind == "sliding_window":
        raise ValueError("paged KV does not support sliding-window caches")
    paged_leaf_names(cfg)
    del num_slots
    return A.init_paged_kv_cache(cfg, num_pages, page_size, cfg.num_layers,
                                 torch_dtype(cfg.compute_dtype), device)


def write_paged_cache(pool_cache, request_cache, slot, page_ids, cfg):
    """Install one request's B=1 prefill cache (prefilled to a page
    multiple) into the pools, in place: whole pages onto `page_ids`."""
    del slot  # the dense family has no per-slot leaves
    page_ids = torch.as_tensor(page_ids, device=pool_cache["k"].device).long()
    npg = page_ids.shape[0]
    for name in paged_leaf_names(cfg):
        pool, one = pool_cache[name], request_cache[name]
        stack, _, P = pool.shape[:3]
        pages = one[:, 0].reshape((stack, npg, P) + tuple(pool.shape[3:]))
        pool[:, page_ids] = pages.to(pool.dtype)
    return pool_cache


def write_cache_slot(pool_cache, request_cache, slot):
    """Scatter one request's B=1 cache into batch row `slot`, in place."""
    for name, pool in pool_cache.items():
        pool[:, slot] = request_cache[name][:, 0].to(pool.dtype)
    return pool_cache


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """batch: {"tokens": (B,S), "labels": (B,S), optional "extra_embeds"}.
    Mean next-token cross-entropy over fp32 logits, plus aux_weight * aux."""
    logits, aux, _ = forward(params, cfg, batch["tokens"],
                             extra_embeds=batch.get("extra_embeds"))
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (logz - gold).mean() + aux_weight * aux
