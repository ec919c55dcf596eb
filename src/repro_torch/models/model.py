"""Top-level models: decoder LM (dense / moe / vlm), encoder-decoder
(audio), hybrid (Zamba2-style Mamba2 layers with one shared
attention+MLP block) and RWKV6 (ssm).

The PyTorch counterpart of the JAX package's ``models/model.py``.  Per-layer
parameters are stacked ``(L, ...)`` leaves as there; the layer
``lax.scan`` becomes a Python loop over layer slices.  KV caches and
recurrent states are updated in place where the JAX code donates the cache
buffer.

Public entry points:
  model_descs / init_model
  forward(params, cfg, tokens, ...)           -> (logits, aux, cache|None)
  decode_step(params, cfg, tokens, pos, cache) -> (logits, cache)
  verify_step(params, cfg, tokens, pos, cache) -> (logits, cache)
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
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM
from repro_torch.core import sharding as SH
from repro_torch.core.sharding import shard
from repro_torch.models.common import (ParamDesc, dense, embed_lookup,
                                       init_params, param_pspecs, rms_norm,
                                       torch_dtype, tree_map,
                                       vocab_cross_entropy)
from repro_torch.models.config import ModelConfig

# the attention families: a position-indexed K/V cache, one per layer
_ATTN = ("dense", "vlm", "moe", "audio")


# ---------------------------------------------------------------------------
# Parameter descriptor trees
# ---------------------------------------------------------------------------
VISION_EMBED_DIM = 1024  # stub ViT output dim (CLIP ViT-L) for VLM backbones


def _stack(tree, L: int):
    return tree_map(lambda d: ParamDesc((L,) + d.shape, d.dtype, d.init,
                                        d.fan_in, ("layers",) + d.names),
                    tree)


def _norm_desc(cfg):
    return ParamDesc((cfg.d_model,), cfg.param_dtype, init="ones",
                     spec=(None,))


def _attn_mlp_block_descs(cfg: ModelConfig, cross: bool = False):
    d = {"ln1": _norm_desc(cfg), "attn": A.attn_descs(cfg),
         "ln2": _norm_desc(cfg), "mlp": M.mlp_descs(cfg)}
    if cross:
        d["lnc"] = _norm_desc(cfg)
        d["cross"] = A.attn_descs(cfg)
    return d


def block_descs(cfg: ModelConfig) -> Dict[str, Any]:
    at = cfg.arch_type
    if at in ("dense", "vlm"):
        return _attn_mlp_block_descs(cfg)
    if at == "audio":
        return _attn_mlp_block_descs(cfg, cross=True)
    if at == "moe":
        return {"ln1": _norm_desc(cfg), "attn": A.attn_descs(cfg),
                "ln2": _norm_desc(cfg), "moe": M.moe_descs(cfg)}
    if at == "hybrid":
        return {"ln": _norm_desc(cfg), "ssm": SSM.ssm_descs(cfg)}
    if at == "ssm":
        return RW.rwkv_descs(cfg)
    raise ValueError(f"unknown arch_type {at!r}")


def model_descs(cfg: ModelConfig) -> Dict[str, Any]:
    dt = cfg.param_dtype
    descs = {
        # vocab-parallel: rows on the model axis (`_embed`)
        "embed": ParamDesc((cfg.vocab_size, cfg.d_model), dt,
                           init="small_normal", spec=("model", None)),
        "blocks": _stack(block_descs(cfg), cfg.num_layers),
        "final_norm": _norm_desc(cfg),
        "lm_head": ParamDesc((cfg.d_model, cfg.vocab_size), dt,
                             fan_in=cfg.d_model, spec=(None, "model")),
    }
    if cfg.arch_type == "hybrid":
        # one attention+MLP block, applied after every hybrid_attn_every
        # layers with the same weights each time (not stacked)
        descs["shared"] = _attn_mlp_block_descs(cfg)
    if cfg.arch_type == "audio":
        descs["enc_blocks"] = _stack(_attn_mlp_block_descs(cfg),
                                     cfg.num_encoder_layers)
        descs["enc_final_norm"] = _norm_desc(cfg)
    if cfg.arch_type == "vlm":
        descs["vproj"] = ParamDesc((VISION_EMBED_DIM, cfg.d_model), dt,
                                   fan_in=VISION_EMBED_DIM,
                                   spec=(None, None))
    return descs


def n_prefix(cfg: ModelConfig) -> int:
    """Positions a request's modality prefix takes in its cache (the vlm
    patches, ahead of the prompt); the logits do not include them."""
    return cfg.num_patches if cfg.arch_type == "vlm" else 0


def init_model(cfg: ModelConfig, generator: torch.Generator):
    """Random weights drawn from `generator`, on the generator's device."""
    return init_params(model_descs(cfg), generator, generator.device)


def model_abstract(cfg: ModelConfig):
    """The parameters as ``device="meta"`` tensors (shapes and dtypes)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype),
                                          device="meta"), model_descs(cfg))


def model_pspecs(cfg: ModelConfig):
    """The parameters' specs under the active AxisEnv and mesh."""
    return param_pspecs(model_descs(cfg))


def distribute_params(params, cfg: ModelConfig, mesh):
    """Whole parameters (the same on every rank: `init_model` from one
    seed, or `bridge.params_from_numpy`) as DTensors laid out by
    `model_pspecs` over `mesh`, so their values do not depend on the
    mesh.  Call under the AxisEnv the step runs in."""
    with SH.use_mesh(mesh):
        specs = model_pspecs(cfg)
    return tree_map(lambda t, sp: SH.distribute(t, sp, mesh), params, specs)


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
    q = shard(q, "batch", None, "model", None)
    k = shard(k, "batch", None, "model", None)
    v = shard(v, "batch", None, "model", None)
    out = A.gqa_attend(q, k, v, cfg, causal=True, window=window)
    out = shard(out, "batch", None, "model", None)
    y = dense(out.reshape(B, S, -1), p["attn"]["wo"])
    return x + shard(y, "batch", "seq", None), (k, v)


def _ffn(p, h, cfg):
    """The layer's feed-forward half on the normed h: (y, aux) -- the MoE
    layer with its load-balance loss, or the dense MLP (aux None)."""
    if "moe" in p:
        return M.moe(p["moe"], h, cfg)
    return M.mlp(p["mlp"], h, cfg), None


def _apply_attn_mlp(p, x, positions, cfg, enc=None):
    """(x, (k, v), aux) of one attention + feed-forward layer; with the
    encoder output `enc` (audio) a cross-attention sublayer sits between
    them, and (k, v) also carries its encoder K/V: (k, v, ck, cv)."""
    x, kv = _attn_sublayer(p, x, positions, cfg)
    if enc is not None:
        h = rms_norm(x, p["lnc"], cfg.norm_eps)
        ekv = A.encoder_kv(p["cross"], enc, cfg)
        x = x + A.attention(p["cross"], h, positions, cfg, encoder_kv=ekv)
        kv = kv + ekv
    y, aux = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return shard(x + y, "batch", "seq", None), kv, aux


def _block(p, x, positions, cfg, enc=None):
    """(x, aux): the unit that block remat recomputes."""
    x, _, aux = _apply_attn_mlp(p, x, positions, cfg, enc)
    return x, aux


def _shared_after(i: int, cfg: ModelConfig) -> bool:
    """Hybrid: is the shared block applied after layer i?  Its j-th
    application (j = i // k) owns shared-cache slot j."""
    return (i + 1) % cfg.hybrid_attn_every == 0


def _hybrid_layer(lp, shared, x, positions, cfg, with_shared: bool):
    """One Mamba2 layer, then the shared block where it applies (the unit
    that block remat recomputes)."""
    pre = rms_norm(x, lp["ln"], cfg.norm_eps)
    x = x + SSM.ssm_block(lp["ssm"], pre, cfg)[0]
    return _block(shared, x, positions, cfg)[0] if with_shared else x


def _encode_audio(params, cfg, frames, remat):
    """The encoder over the frame embeddings (B, Te, d_model): full
    (non-causal) self-attention with rope over the frame positions."""
    B, Te, _ = frames.shape
    enc_pos = torch.arange(Te, device=frames.device)[None].expand(B, Te)
    h = frames
    for i in range(cfg.num_encoder_layers):
        lp = _layer(params["enc_blocks"], i)
        h = (checkpoint(_encoder_layer, lp, h, enc_pos, cfg,
                        use_reentrant=False)
             if remat else _encoder_layer(lp, h, enc_pos, cfg))
    return rms_norm(h, params["enc_final_norm"], cfg.norm_eps)


def _encoder_layer(lp, h, enc_pos, cfg):
    h1 = rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + A.attention(lp["attn"], h1, enc_pos, cfg, causal=False)
    h2 = rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + M.mlp(lp["mlp"], h2, cfg)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra_embeds=None, return_cache: bool = False,
            cache_len: Optional[int] = None, sharded_cache: bool = False):
    """tokens: (B, S) int.  extra_embeds: the modality frontend's stub
    output — audio: (B, T_enc, d_model) frame embeddings; vlm: (B, P,
    1024) patches, projected and prepended to the tokens (positions and
    the cache include them; the logits do not).

    Returns (logits (B, S, V), aux_loss scalar, cache|None); the cache is
    `init_cache`'s (dense: {"k", "v"}: (L, B, cache_len, Hk, dh); audio
    adds the cross-attention K/V "ck", "cv" (L, B, T_enc, Hk, dh); ssm:
    the recurrent state) holding the prefill.

    Under a mesh the cache comes back whole on every rank, or with
    `sharded_cache` (the serve path) as DTensors laid out as the serve
    caches are (`serve_cache_names`): each rank writes only its own
    shard, and no whole cache is gathered.

    With ``cfg.remat == "block"`` and autograd recording, each layer runs
    under ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``
    of the scan body): its activations are recomputed in the backward."""
    at = cfg.arch_type
    x = embed_lookup(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    x = shard(x, "batch", None, None)
    n_prefix = 0
    if at == "vlm":
        if extra_embeds is None:
            raise ValueError("arch_type vlm needs extra_embeds (patches)")
        patches = dense(extra_embeds.to(x.dtype), params["vproj"])
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    C = cache_len or S
    if C < S and at != "ssm":
        raise ValueError(f"cache_len {C} < seq {S}")
    remat = (cfg.remat == "block" and torch.is_grad_enabled()
             and not return_cache)
    if at == "ssm":
        x, aux, cache = _run_rwkv(params, cfg, x, return_cache, remat,
                                  sharded_cache)
    elif at == "hybrid":
        x, aux, cache = _run_hybrid(params, cfg, x, positions,
                                    return_cache, C, remat, sharded_cache)
    else:
        enc = (_encode_audio(params, cfg, extra_embeds, remat)
               if at == "audio" else None)
        x, aux, cache = _run_dense(params, cfg, x, positions, return_cache,
                                   C, remat, enc, sharded_cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard(dense(x, params["lm_head"]), "batch", None, "model")
    if n_prefix:
        logits = logits[:, n_prefix:]
    return logits, aux, cache


def _put_kv(leaf, index, t, sharded: bool) -> None:
    """leaf[index] = t for a K/V leaf, in place: with `sharded` each rank
    writes its own shard of t as the serve cache lays it out
    (`A.cache_rows`: every row, this rank's heads); else t whole."""
    if sharded:
        SH.local(leaf)[index] = A.cache_rows(t, leaf.shape[-2])
    else:
        leaf[index] = SH.whole(t)


def _put_state(leaf, index, t) -> None:
    """leaf[index] = t whole, in place, for a recurrent-state leaf (plain,
    or a serve cache's replicated DTensor: each rank writes its copy)."""
    SH.local(leaf)[index] = SH.whole(t)


def _run_dense(params, cfg, x, positions, return_cache, C, remat, enc,
               sharded=False):
    """The dense, vlm, MoE and audio stacks; aux sums the MoE layers'
    losses.  Audio (enc given): each layer's cross-attention K/V go to the
    cache as "ck"/"cv"."""
    B, S, _ = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if return_cache and sharded:
        cache = init_cache(cfg, B, C, x.device, mesh=SH.get_mesh())
    elif return_cache:
        cache = A.init_kv_cache(cfg, B, C, cfg.num_layers, x.dtype, x.device)
        if enc is not None:
            shape = (cfg.num_layers, B, enc.shape[1], cfg.num_kv_heads,
                     cfg.head_dim)
            cache["ck"] = torch.zeros(shape, dtype=x.dtype, device=x.device)
            cache["cv"] = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        if remat:
            x, a = checkpoint(_block, lp, x, positions, cfg, enc,
                              use_reentrant=False)
        else:
            x, kv, a = _apply_attn_mlp(lp, x, positions, cfg, enc)
            if return_cache:
                for n, t in zip(("k", "v", "ck", "cv"), kv):
                    _put_kv(cache[n], (i, slice(None), slice(0, t.shape[1])),
                            t, sharded)
        if a is not None:
            aux = aux + a
    return x, aux, cache


def _run_rwkv(params, cfg, x, return_cache, remat, sharded=False):
    """The RWKV6 stack; the cache is the final recurrent state of every
    layer (`init_cache`'s "wkv", "tm", "cm")."""
    cache = None
    if return_cache and sharded:
        cache = init_cache(cfg, x.shape[0], 1, x.device, mesh=SH.get_mesh())
    elif return_cache:
        cache = RW.init_rwkv_state(cfg, x.shape[0], cfg.num_layers, x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(_rwkv_layer, lp, x, cfg, use_reentrant=False)
            continue
        x, st = RW.rwkv_block(lp, x, cfg)
        if return_cache:
            for n, t in st.items():
                _put_state(cache[n], i, t)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


def _rwkv_layer(lp, x, cfg):
    return RW.rwkv_block(lp, x, cfg)[0]


def _run_hybrid(params, cfg, x, positions, return_cache, C, remat,
                sharded=False):
    """Zamba2-style: the Mamba2 layers in order, the SHARED attention+MLP
    block (the same weights each time) after every hybrid_attn_every of
    them.  The cache: "ssm" (L,B,H,N,P) fp32 final states, "conv"
    {"x","B","C"} (L,B,W-1,.) rings, "sk"/"sv" (L // k, B, C, Hk, dh) the
    shared block's rope'd K/V, one slot per application."""
    B, S, _ = x.shape
    shared = params["shared"]
    cache = (init_cache(cfg, B, C, x.device,
                        mesh=SH.get_mesh() if sharded else None)
             if return_cache else None)
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        with_shared = _shared_after(i, cfg)
        if remat:
            x = checkpoint(_hybrid_layer, lp, shared, x, positions, cfg,
                           with_shared, use_reentrant=False)
            continue
        pre = rms_norm(x, lp["ln"], cfg.norm_eps)
        y, (st, conv) = SSM.ssm_block(lp["ssm"], pre, cfg)
        x = x + y
        if return_cache:
            _put_state(cache["ssm"], i, st)
            for n, ring in conv.items():
                _put_state(cache["conv"][n], i, ring)
        if with_shared:
            x, (k, v), _ = _apply_attn_mlp(shared, x, positions, cfg)
            if return_cache:
                j = i // cfg.hybrid_attn_every
                _put_kv(cache["sk"], (j, slice(None), slice(0, S)), k, sharded)
                _put_kv(cache["sv"], (j, slice(None), slice(0, S)), v, sharded)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


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

    Audio: each layer's cross-attention reads the cached encoder K/V
    ("ck", "cv"), which never change.  ssm: rows whose `active` is False
    keep their recurrent state bit for bit.

    The cache is updated in place.  Returns (logits (B,1,V), cache)."""
    at = cfg.arch_type
    # per-row registers are replicated (the engine's are plain tensors)
    pos, active, block_tables = (SH.whole(t) for t in (pos, active,
                                                        block_tables))
    if active is not None and torch.as_tensor(pos).dim() != 1:
        raise ValueError("active mask requires a per-row pos vector")
    if block_tables is not None and at == "ssm":
        raise ValueError("arch_type ssm has no KV cache to page")
    x = embed_lookup(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    x = shard(x, "batch", None, None)
    if at == "hybrid":
        x = _decode_hybrid(params, cfg, x, pos, cache, active=active,
                           block_tables=block_tables,
                           logical_len=logical_len)
    elif at == "ssm":
        x = _decode_rwkv(params, cfg, x, cache, active)
    else:
        for i in range(cfg.num_layers):
            lp = _layer(params["blocks"], i)
            pre = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, _, _ = A.attention_decode(lp["attn"], pre, cache["k"][i],
                                         cache["v"][i], pos, cfg,
                                         active=active,
                                         block_tables=block_tables,
                                         logical_len=logical_len)
            x = x + y
            if at == "audio":
                # the reference passes zeroed copies of the self-attention
                # cache here (`ck * 0`), which the cross read never uses
                hc = rms_norm(x, lp["lnc"], cfg.norm_eps)
                y, _, _ = A.attention_decode(
                    lp["cross"], hc, None, None, pos, cfg,
                    encoder_kv_cache=(cache["ck"][i], cache["cv"][i]))
                x = x + y
            pre2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            # under a mesh the MLP's down projection leaves partial sums
            x = shard(x + _ffn(lp, pre2, cfg)[0], "batch", None, None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return shard(dense(x, params["lm_head"]), "batch", None, "model"), cache


def _decode_rwkv(params, cfg, x, cache, active):
    """One token through the RWKV6 stack; layer i's state is cache rows
    [i], updated in place (inactive rows keep theirs)."""
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        st = {n: cache[n][i] for n in ("wkv", "tm", "cm")}
        x, new = RW.rwkv_block(lp, x, cfg, state=st)
        for n, t in new.items():
            if active is not None:
                keep = active.reshape((-1,) + (1,) * (t.dim() - 1))
                t = torch.where(keep, t.to(st[n].dtype), st[n])
            _put_state(st[n], ..., t)
    return x


def _decode_hybrid(params, cfg, x, pos, cache, *, active=None,
                   block_tables=None, logical_len=None):
    """One token through the hybrid stack, the cache updated in place.
    Layer i's SSM state and conv ring are cache rows [i]; the shared
    block's j-th application (after layer i = j*k + k - 1) reads and
    writes shared-cache slot j only.  Rows whose `active` is False keep
    their state and ring bit for bit (their KV writes are the attention's
    own no-ops)."""
    shared = params["shared"]
    keep = None if active is None else active.reshape(-1, 1, 1, 1)
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        pre = rms_norm(x, lp["ln"], cfg.norm_eps)
        rings = {n: r[i] for n, r in cache["conv"].items()}
        y, (st, new_rings) = SSM.ssm_block(lp["ssm"], pre, cfg,
                                           state=cache["ssm"][i],
                                           conv_cache=rings)
        if keep is not None:
            st = torch.where(keep, st, cache["ssm"][i])
            new_rings = {n: torch.where(keep[:, :, :, 0], r, rings[n])
                         for n, r in new_rings.items()}
        _put_state(cache["ssm"], i, st)
        for n, r in new_rings.items():
            _put_state(rings[n], ..., r)
        x = shard(x + y, "batch", None, None)
        if _shared_after(i, cfg):
            j = i // cfg.hybrid_attn_every
            pre = rms_norm(x, shared["ln1"], cfg.norm_eps)
            y, _, _ = A.attention_decode(shared["attn"], pre, cache["sk"][j],
                                         cache["sv"][j], pos, cfg,
                                         active=active,
                                         block_tables=block_tables,
                                         logical_len=logical_len)
            x = x + y
            pre2 = rms_norm(x, shared["ln2"], cfg.norm_eps)
            x = shard(x + M.mlp(shared["mlp"], pre2, cfg), "batch", None,
                      None)
    return x


def verify_step(params, cfg: ModelConfig, tokens: torch.Tensor, pos, cache,
                *, active=None, block_tables=None, logical_len=None):
    """Speculative-decoding verify: score S candidate tokens per row in one
    pass.  tokens: (B,S) int — row b's candidates occupy positions
    pos[b] .. pos[b]+S-1; logits[:, i] is the next-token distribution
    after candidate i, what S sequential `decode_step` calls give.

    The attention-only decoder family only: the recurrent families would
    need state snapshots to roll back, not just a position register.  The
    cache is updated in place.  Returns (logits (B,S,V), cache)."""
    at = cfg.arch_type
    if at not in ("dense", "vlm", "moe"):
        raise ValueError(f"verify_step: unsupported arch_type {at}")
    pos, active, block_tables = (SH.whole(t) for t in (pos, active,
                                                        block_tables))
    x = embed_lookup(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype))
    x = shard(x, "batch", None, None)
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        pre = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _, _ = A.attention_verify(lp["attn"], pre, cache["k"][i],
                                     cache["v"][i], pos, cfg, active=active,
                                     block_tables=block_tables,
                                     logical_len=logical_len)
        x = x + y
        pre2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + _ffn(lp, pre2, cfg)[0], "batch", None, None)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return shard(dense(x, params["lm_head"]), "batch", None, "model"), cache


# ---------------------------------------------------------------------------
# Cache construction (for serving)
# ---------------------------------------------------------------------------
def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                kv_heads: Optional[int] = None):
    """name -> (shape, dtype) of the dense decode cache; the hybrid's
    "conv" leaf is itself a dict {"x","B","C"}.  A sliding-window cache
    is a ring of min(cache_len, window) slots.  kv_heads: the KV heads a
    K/V leaf stores (default num_kv_heads; `A.kv_store_heads` under a
    mesh)."""
    at = cfg.arch_type
    L = cfg.num_layers
    if cfg.attention_kind == "sliding_window":
        cache_len = min(cache_len, cfg.sliding_window)
    cdt = torch_dtype(cfg.compute_dtype)
    kv = (kv_heads or cfg.num_kv_heads, cfg.head_dim)
    if at == "ssm":
        return RW.rwkv_state_specs(cfg, batch, L)
    if at == "hybrid":
        base = SSM.ssm_state_specs(cfg, batch, L)
        shape = (L // cfg.hybrid_attn_every, batch, cache_len) + kv
        return {"ssm": base["state"], "conv": base["conv"],
                "sk": (shape, cdt), "sv": (shape, cdt)}
    if at not in _ATTN:
        raise ValueError(f"unknown arch_type {at!r}")
    shape = (L, batch, cache_len) + kv
    specs = {"k": (shape, cdt), "v": (shape, cdt)}
    if at == "audio":
        cross = (L, batch, cfg.encoder_seq) + kv
        specs.update(ck=(cross, cdt), cv=(cross, cdt))
    return specs


KV_LEAVES = ("k", "v", "ck", "cv", "sk", "sv")


def serve_cache_names(cfg: ModelConfig, specs, paged: bool = False) -> Any:
    """Logical names of a serve cache's leaves (`specs` gives the tree's
    structure): a dense cache's K/V leaves (L, B, C, H, dh) split their
    slots as the batch and their head dim over "model" (where the stored
    heads divide it); in paged mode the page pools and the per-slot K/V
    rows split only their heads, every page and slot on every data rank
    (the host's block tables and slot registers are replicated).  Every
    other leaf (recurrent state) is replicated (`A` module docstring)."""
    pools = paged_leaf_names(cfg) if paged else ()

    def names(n, leaf):
        if isinstance(leaf, dict):
            return {k: names(k, v) for k, v in leaf.items()}
        nd = len(leaf[0]) if isinstance(leaf, tuple) else leaf.dim()
        if n not in KV_LEAVES:
            return (None,) * nd
        rows = None if paged or n in pools else "batch"
        return ("layers", rows) + (None,) * (nd - 4) + ("model", None)
    return {n: names(n, leaf) for n, leaf in specs.items()}


def _zeros(specs, device: torch.device, mesh=None, cfg=None,
           paged: bool = False):
    """Zeros of `specs`; with a DeviceMesh, DTensors laid out as the serve
    caches are (`serve_cache_names`), each rank allocating its shard."""
    if not SH.is_device_mesh(mesh):
        return tree_map(lambda s: torch.zeros(s[0], dtype=s[1],
                                              device=device), specs)
    with SH.use_mesh(mesh):
        return tree_map(
            lambda s, nm: SH.zeros(s[0], s[1],
                                   SH.resolve_spec(tuple(s[0]), nm), mesh,
                                   device),
            specs, serve_cache_names(cfg, specs, paged))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: torch.device, mesh=None):
    """The dense decode cache; with a DeviceMesh (the serve path under a
    mesh) DTensors laid out by `serve_cache_names`, storing
    `A.kv_store_heads` K/V heads."""
    heads = None
    if SH.is_device_mesh(mesh):
        with SH.use_mesh(mesh):
            heads = A.kv_store_heads(cfg)
    return _zeros(cache_specs(cfg, batch, cache_len, heads), device, mesh,
                  cfg)


def paged_leaf_names(cfg: ModelConfig) -> tuple:
    """Cache leaves that page (position-indexed KV); every other leaf —
    the audio cross-KV (fixed encoder length), the hybrid's SSM state and
    conv ring, the RWKV state — stays a per-slot batch row."""
    if cfg.arch_type in _ATTN:
        return ("k", "v")
    if cfg.arch_type == "hybrid":
        return ("sk", "sv")
    return ()


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, device: torch.device, mesh=None):
    """KV leaves as shared page pools (stack, num_pages + 1, P, Hk, dh).
    The last page is the trash page: no block table names it, and retired
    slots' decode writes land there instead of being dropped (PyTorch has
    no drop-mode scatter); pages [:num_pages] are the pool proper.
    Per-slot leaves (the audio cross-KV, the hybrid's SSM state and conv
    ring) keep num_slots batch rows.  With a DeviceMesh, DTensors as
    `init_cache` gives them (the pools store `A.kv_store_heads` heads)."""
    if cfg.attention_kind == "sliding_window":
        raise ValueError("paged KV does not support sliding-window caches")
    names = paged_leaf_names(cfg)
    if not names:
        raise ValueError(f"arch_type {cfg.arch_type} has no KV to page")
    heads = None
    if SH.is_device_mesh(mesh):
        with SH.use_mesh(mesh):
            heads = A.kv_store_heads(cfg)
    specs = dict(cache_specs(cfg, num_slots, page_size, heads))
    for name in names:
        (stack, *_, He, dh), dt = specs[name]
        specs[name] = ((stack, num_pages + 1, page_size, He, dh), dt)
    return _zeros(specs, device, mesh, cfg, paged=True)


def _local_like(t: torch.Tensor, leaf, whole_dim: Optional[int] = None
                ) -> torch.Tensor:
    """t as it goes into `leaf`: its local shard for a DTensor leaf (the
    whole t repeated on its head dim where the leaf stores more K/V
    heads; `whole_dim` kept whole, t's rows of a slot-split leaf), or
    t."""
    if SH.is_dtensor(t):
        return t.to_local().to(leaf.dtype)
    t = t.to(leaf.device, leaf.dtype)
    if leaf.dim() >= 2 and t.dim() == leaf.dim() \
            and leaf.shape[-2] != t.shape[-2]:
        t = t.repeat_interleave(leaf.shape[-2] // t.shape[-2], dim=-2)
    if not SH.is_dtensor(leaf):
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor
    pl = [Replicate() if getattr(p, "dim", None) == whole_dim else p
          for p in leaf.placements]
    return distribute_tensor(t, leaf.device_mesh, pl,
                             src_data_rank=None).to_local()


def _write_rows(pool, one, slot) -> None:
    """Batch row `slot` of every (stack, batch, ...) leaf of `pool` <- the
    B=1 `one`, in place (leaves may be nested dicts: the conv ring); for
    a DTensor leaf on each rank's own shard (of a slot-split leaf, only
    the rank that holds the row writes it)."""
    if isinstance(pool, dict):
        for n in pool:
            _write_rows(pool[n], one[n], slot)
        return
    mine = SH.local_slice(pool, 1)
    if mine.start <= slot < mine.stop:
        SH.local(pool)[:, slot - mine.start] = _local_like(one, pool,
                                                           1)[:, 0]


def write_paged_cache(pool_cache, request_cache, slot, page_ids, cfg):
    """Install one request's B=1 prefill cache (prefilled to a page
    multiple) into the pools, in place: KV leaves as whole pages onto
    `page_ids`, per-slot leaves into batch row `slot`."""
    names = paged_leaf_names(cfg)
    page_ids = torch.as_tensor(page_ids,
                               device=pool_cache[names[0]].device).long()
    npg = page_ids.shape[0]
    for name, pool in pool_cache.items():
        one = request_cache[name]
        if name not in names:
            _write_rows(pool, one, slot)
            continue
        local = SH.local(pool)
        stack, _, P = local.shape[:3]
        one = _local_like(one, pool)
        pages = one[:, 0].reshape((stack, npg, P) + tuple(local.shape[3:]))
        local[:, page_ids] = pages
    return pool_cache


def write_cache_slot(pool_cache, request_cache, slot):
    """Scatter one request's B=1 cache into batch row `slot`, in place."""
    _write_rows(pool_cache, request_cache, slot)
    return pool_cache


def install_pages(leaf, page_ids: torch.Tensor, pages) -> None:
    """leaf[:, page_ids[:n]] <- pages (stack, n, P, Hk, dh) host pages
    of a harvested slot, in place (each rank its shard of a DTensor
    pool, the K/V heads repeated where the pool stores more)."""
    n = pages.shape[1]
    SH.local(leaf)[:, page_ids[:n]] = _local_like(torch.as_tensor(pages),
                                                  leaf)


def harvest(leaf, index, kv_heads: Optional[int] = None) -> torch.Tensor:
    """leaf[index] whole, on the host; `index` keeps every dim (pages, or
    a range of slots).  With `kv_heads`, a K/V leaf that stores repeated
    heads gives each KV head once."""
    t = SH.whole(SH.from_local_like(SH.local(leaf)[index], leaf))
    if kv_heads and t.shape[-2] != kv_heads:
        t = t[..., ::t.shape[-2] // kv_heads, :]
    return t.to("cpu", copy=True)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """batch: {"tokens": (B,S), "labels": (B,S), optional "extra_embeds"}.
    Mean next-token cross-entropy over fp32 logits, plus aux_weight * aux."""
    logits, aux, _ = forward(params, cfg, batch["tokens"],
                             extra_embeds=batch.get("extra_embeds"))
    # vocab-parallel: the logits keep their vocab split (no rank holds
    # the whole (B, S, V) or its gradient)
    nll = vocab_cross_entropy(logits, batch["labels"])
    return nll.mean() + aux_weight * aux
