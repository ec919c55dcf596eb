"""Grouped-query attention: batched (prefill) and one-token decode.

The PyTorch counterpart of the JAX package's ``models/attention.py``.
Projections are stored flattened (d_model, heads*head_dim), as there.
Cross-attention, the sliding-window ring buffer and the q-chunked path
are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.common import (ParamDesc, apply_rope, dense,
                                       head_rms_norm)
from repro_torch.models.config import ModelConfig

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attn_descs(cfg: ModelConfig,
               dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d = cfg.d_model
    descs = {
        "wq": ParamDesc((d, cfg.q_dim), dt, fan_in=d),
        "wk": ParamDesc((d, cfg.kv_dim), dt, fan_in=d),
        "wv": ParamDesc((d, cfg.kv_dim), dt, fan_in=d),
        "wo": ParamDesc((cfg.q_dim, d), dt, fan_in=cfg.q_dim),
    }
    if cfg.qk_norm:
        descs["q_scale"] = ParamDesc((cfg.head_dim,), dt, init="ones")
        descs["k_scale"] = ParamDesc((cfg.head_dim,), dt, init="ones")
    return descs


def _project_qkv(p, x, positions, cfg: ModelConfig):
    B, S, _ = x.shape
    q = dense(x, p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = dense(x, p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = dense(x, p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_scale"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_scale"], cfg.norm_eps)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,S,Hq,dh), k: (B,T,Hk,dh) -> scores (B,Hk,G,S,T) in fp32."""
    B, S, Hq, dh = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, S, Hk, Hq // Hk, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return scores * (dh ** -0.5)


def _gqa_out(probs, v):
    """probs: (B,Hk,G,S,T) fp32; v: (B,T,Hk,dh) -> (B,S,Hq,dh)."""
    B, Hk, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hk * G, -1)


def causal_mask(S: int, T: int, offset: int = 0,
                window: Optional[int] = None,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """(S,T) bool mask; query i (global pos offset+i) attends key j<=pos,
    and with `window` only the last `window` positions."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def gqa_attend(q, k, v, cfg: ModelConfig, *, causal: bool = True,
               window: Optional[int] = None) -> torch.Tensor:
    """Backend dispatch for batched GQA attention: the flash kernel
    wrapper (cfg.use_flash_kernel) or the flat softmax."""
    S = q.shape[1]
    if cfg.use_flash_kernel and S > 1:
        from repro_torch.kernels import ops as K
        return K.flash_attention(q, k, v, causal=causal, window=window)
    if cfg.attn_q_chunk and S > cfg.attn_q_chunk:
        raise NotImplementedError("q-chunked attention is not ported yet "
                                  "(ROADMAP.md queue 1, attention)")
    scores = _gqa_scores(q, k)
    if causal:
        T = k.shape[1]
        m = causal_mask(S, T, T - S, window, device=q.device)
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v)


# --------------------------------------------------------------------------
# Decode (one new token against a KV cache)
# --------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, layers: int,
                  dtype: torch.dtype, device: torch.device):
    shape = (layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_gather(pool, bt, C):
    """pool: (Np,P,Hk,dh); bt: (B,n_max) page ids -> (B,C,Hk,dh) view.
    Positions past a row's length read whatever the page holds; callers
    mask them with NEG_INF, an exact softmax zero."""
    B = bt.shape[0]
    Hk, dh = pool.shape[2], pool.shape[3]
    return pool[bt.long()].reshape(B, -1, Hk, dh)[:, :C]


def attention_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     active=None, block_tables=None, logical_len=None):
    """x: (B,1,d); cache_k/v: (B,C,Hk,dh) views into the layer-stacked
    cache; pos: () current length, or (B,) — one position per row.

    The new K/V are written IN PLACE into cache_k/cache_v (the JAX engine
    donates the cache buffer to the same update).  active: optional (B,)
    bool (vector pos only): rows where it is False are retired slots whose
    cache must not change — their dense write puts back the row's own old
    value, and their paged write goes to the trash page.

    block_tables: optional (B, n_max) int — PAGED mode: cache_k/v are the
    shared pool (Np+1, P, Hk, dh) of `model.init_paged_cache` and row b's
    position q lives in pool[block_tables[b, q // P], q % P].  logical_len
    bounds the gathered view (the dense cache_len it replaces).

    Returns (y, cache_k, cache_v)."""
    B = x.shape[0]
    paged = block_tables is not None
    ring = cfg.attention_kind == "sliding_window"
    if paged and ring:
        raise ValueError("paged KV does not support sliding-window caches")
    if ring:
        raise NotImplementedError("the sliding-window ring cache is not "
                                  "ported yet (ROADMAP.md queue 1)")
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.dim() == 1
    if paged and not per_row:
        raise ValueError("paged KV requires a per-row pos vector")
    pos_b = (pos if per_row else pos.expand(B)).long()  # (B,)
    q, k1, v1 = _project_qkv(p, x, pos_b[:, None], cfg)
    if paged:
        Np, P = cache_k.shape[0] - 1, cache_k.shape[1]   # page Np: trash
        n_max = block_tables.shape[1]
        C = logical_len if logical_len is not None else n_max * P
        j = pos_b // P
        page = block_tables.long().gather(
            1, j.clamp(max=n_max - 1)[:, None])[:, 0]
        keep = j < n_max
        if active is not None:
            keep = keep & active
        page = torch.where(keep, page, Np)
        # in place, where the JAX engine donates the pool to this update
        cache_k[page, pos_b % P] = k1[:, 0].to(cache_k.dtype)
        cache_v[page, pos_b % P] = v1[:, 0].to(cache_v.dtype)
        if cfg.use_paged_kernel:
            from repro_torch.kernels import ops as K
            out = K.paged_attention(q[:, 0], cache_k, cache_v,
                                    block_tables.int(), pos_b.int(),
                                    logical_len=C)
            y = dense(out.reshape(B, 1, -1), p["wo"])
            return y, cache_k, cache_v
        k = _paged_gather(cache_k, block_tables, C)
        v = _paged_gather(cache_v, block_tables, C)
    else:
        C = cache_k.shape[1]
        if per_row:
            rows = torch.arange(B, device=x.device)
            slot = pos_b.clamp(max=C - 1)
            keep = pos_b < C
            if active is not None:
                keep = keep & active
            keep = keep[:, None, None]
            # in place (the JAX engine donates the cache); a retired row
            # writes its own old value back: rows are distinct, so no
            # write collides with another row's
            cache_k[rows, slot] = torch.where(keep, k1[:, 0].to(cache_k.dtype),
                                              cache_k[rows, slot])
            cache_v[rows, slot] = torch.where(keep, v1[:, 0].to(cache_v.dtype),
                                              cache_v[rows, slot])
        else:
            cache_k.index_copy_(1, pos.reshape(1).long(), k1.to(cache_k.dtype))
            cache_v.index_copy_(1, pos.reshape(1).long(), v1.to(cache_v.dtype))
        k, v = cache_k, cache_v
    valid = torch.arange(C, device=x.device)[None, :] <= pos_b[:, None]
    scores = _gqa_scores(q, k)  # (B,Hk,G,1,C)
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v)
    y = dense(out.reshape(B, 1, -1), p["wo"])
    return y, cache_k, cache_v


def attention_verify(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     active=None, block_tables=None, logical_len=None):
    """Draft-verify attention: S candidate tokens per row in one pass.

    x: (B,S,d); row b's candidates sit at positions pos[b] .. pos[b]+S-1
    (pos: (B,) per-row vector).  All S keys/values are written IN PLACE,
    as `attention_decode` writes its one, and query i attends the cache
    plus candidates 0..i: exactly what S sequential decode calls see.
    Rejected candidates leave stale KV past the accepted prefix, which the
    next round overwrites before any query can see it.

    Dense cache (B,C,Hk,dh), or paged pool (Np+1,P,Hk,dh) + block_tables
    as in `attention_decode`.  An inactive row writes its own old value
    back (dense) or to the trash page (paged); a position past the cache
    is masked and never written.  In paged mode with cfg.use_paged_kernel
    the attention reads through the paged kernel: one launch of B*S query
    rows, row (b, i) at position pos[b] + i through table row b.

    Returns (y (B,S,d), cache_k, cache_v)."""
    B, S, _ = x.shape
    paged = block_tables is not None
    if cfg.attention_kind == "sliding_window":
        raise ValueError("attention_verify: sliding-window caches "
                         "unsupported")
    pos = torch.as_tensor(pos, device=x.device)
    if pos.dim() != 1:
        raise ValueError("attention_verify requires a per-row pos vector")
    qpos = pos.long()[:, None] + torch.arange(S, device=x.device)[None]
    q, k1, v1 = _project_qkv(p, x, qpos, cfg)
    if paged:
        Np, P = cache_k.shape[0] - 1, cache_k.shape[1]   # page Np: trash
        n_max = block_tables.shape[1]
        C = logical_len if logical_len is not None else n_max * P
        j = qpos // P
        page = block_tables.long().gather(1, j.clamp(max=n_max - 1))
        keep = j < n_max
        if active is not None:
            keep = keep & active[:, None]
        page = torch.where(keep, page, Np)
        # distinct (page, offset) targets apart from the trash page, whose
        # contents nothing reads
        cache_k[page, qpos % P] = k1.to(cache_k.dtype)
        cache_v[page, qpos % P] = v1.to(cache_v.dtype)
        if cfg.use_paged_kernel:
            from repro_torch.kernels import ops as K
            # a query past the cache attends every cached position, as
            # the plain path's mask gives it
            rows = qpos.clamp(max=C - 1).reshape(-1).int()
            bt = block_tables.int().repeat_interleave(S, dim=0)
            out = K.paged_attention(q.reshape(B * S, *q.shape[2:]), cache_k,
                                    cache_v, bt, rows, logical_len=C)
            y = dense(out.reshape(B, S, -1), p["wo"])
            return y, cache_k, cache_v
        k = _paged_gather(cache_k, block_tables, C)
        v = _paged_gather(cache_v, block_tables, C)
    else:
        C = cache_k.shape[1]
        rows = torch.arange(B, device=x.device)
        # candidate by candidate, so that a clamped position past the
        # cache writes back what an earlier candidate left at C - 1
        for i in range(S):
            slot = qpos[:, i].clamp(max=C - 1)
            keep = qpos[:, i] < C
            if active is not None:
                keep = keep & active
            keep = keep[:, None, None]
            cache_k[rows, slot] = torch.where(
                keep, k1[:, i].to(cache_k.dtype), cache_k[rows, slot])
            cache_v[rows, slot] = torch.where(
                keep, v1[:, i].to(cache_v.dtype), cache_v[rows, slot])
        k, v = cache_k, cache_v
    valid = torch.arange(C, device=x.device)[None, None] <= qpos[:, :, None]
    scores = _gqa_scores(q, k)  # (B,Hk,G,S,C)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v)
    y = dense(out.reshape(B, S, -1), p["wo"])
    return y, cache_k, cache_v
