"""Grouped-query attention: batched (prefill) and one-token decode.

The PyTorch counterpart of the JAX package's ``models/attention.py``.
Projections are stored flattened (d_model, heads*head_dim), as there.
Batched attention dispatches to the flash kernel, the q-chunked path or
the flat softmax; cross-attention reads encoder K/V computed once
(`encoder_kv`); decode writes a dense cache, a sliding-window ring of
`window` slots, or a paged pool.

Under a mesh the serve path's caches (``launch/steps.cache_pspecs`` with
serve=True) split their KV-head dim over "model"; a dense cache splits
its slots over the batch axes as the batch is split, while a page pool
is replicated over them: every page on every data rank, so the host's
block tables and slot registers need no sharding.  Where the model axes
do not divide the KV heads but the heads divide them (and the query
heads), each KV head is stored once a rank whose query heads read it:
the cache holds `kv_store_heads` heads, every KV head repeated, as most
GPU servers replicate KV heads under tensor parallelism.  Otherwise the
heads stay whole.  A decode or verify step writes its new K/V into each
rank's local shard (a pool's rows gathered over the batch axes first),
then attends this rank's own rows and heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import sharding as SH
from repro_torch.core.sharding import shard
from repro_torch.models.common import (ParamDesc, apply_rope, dense,
                                       head_rms_norm)
from repro_torch.models.config import ModelConfig

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attn_descs(cfg: ModelConfig,
               dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d = cfg.d_model
    descs = {
        "wq": ParamDesc((d, cfg.q_dim), dt, fan_in=d, spec=(None, "model")),
        "wk": ParamDesc((d, cfg.kv_dim), dt, fan_in=d, spec=(None, "model")),
        "wv": ParamDesc((d, cfg.kv_dim), dt, fan_in=d, spec=(None, "model")),
        "wo": ParamDesc((cfg.q_dim, d), dt, fan_in=cfg.q_dim,
                        spec=("model", None)),
    }
    if cfg.qk_norm:
        descs["q_scale"] = ParamDesc((cfg.head_dim,), dt, init="ones",
                                     spec=(None,))
        descs["k_scale"] = ParamDesc((cfg.head_dim,), dt, init="ones",
                                     spec=(None,))
    return descs


def _split_heads(t, H: int, dh: int):
    """(B, S, H*dh) -> (B, S, H, dh).  Under a mesh whose model axes do
    not divide H, the projection's split of H*dh is undone first (DTensor
    cannot split a sharded dim unevenly)."""
    B, S = t.shape[:2]
    if SH.is_dtensor(t) and SH.resolve_spec((H,), ("model",))[0] is None:
        t = shard(t, "batch", None, None)
    return t.reshape(B, S, H, dh)


def _project_qkv(p, x, positions, cfg: ModelConfig):
    H, Hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(dense(x, p["wq"]), H, dh)
    k = _split_heads(dense(x, p["wk"]), Hk, dh)
    v = _split_heads(dense(x, p["wv"]), Hk, dh)
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


def _cross_q(p, x, cfg: ModelConfig):
    """The cross-attention query of x (B,S,d): no rope, as the encoder's
    keys carry the frames' positions."""
    q = _split_heads(dense(x, p["wq"]), cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_scale"], cfg.norm_eps)
    return q


def attention(p, x, positions, cfg: ModelConfig, *,
              encoder_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True) -> torch.Tensor:
    """Batched attention. x: (B,S,d).  encoder_kv: (k, v) of
    `encoder_kv` -> cross-attention (never causal)."""
    B, S, _ = x.shape
    if encoder_kv is not None:
        q, (k, v) = _cross_q(p, x, cfg), encoder_kv
        causal = False
    else:
        q, k, v = _project_qkv(p, x, positions, cfg)
    window = (cfg.sliding_window
              if cfg.attention_kind == "sliding_window" else None)
    q = shard(q, "batch", None, "model", None)
    k = shard(k, "batch", None, "model", None)
    v = shard(v, "batch", None, "model", None)
    out = gqa_attend(q, k, v, cfg, causal=causal, window=window)
    out = shard(out, "batch", None, "model", None)
    y = dense(out.reshape(B, S, -1), p["wo"])
    return shard(y, "batch", "seq", None)


def gqa_attend(q, k, v, cfg: ModelConfig, *, causal: bool = True,
               window: Optional[int] = None) -> torch.Tensor:
    """Backend dispatch for batched GQA attention: the flash kernel
    wrapper (cfg.use_flash_kernel), the q-chunked path (cfg.attn_q_chunk)
    or the flat softmax."""
    S = q.shape[1]
    if cfg.use_flash_kernel and S > 1:
        from repro_torch.kernels import ops as K
        return K.flash_attention(q, k, v, causal=causal, window=window)
    # under a mesh, on each rank's own rows and heads
    return SH.local_heads(
        lambda q, k, v: _gqa_plain(q, k, v, cfg, causal, window), q, k, v)


def _gqa_plain(q, k, v, cfg: ModelConfig, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    S = q.shape[1]
    if cfg.attn_q_chunk and S > cfg.attn_q_chunk:
        return _gqa_chunked(q, k, v, cfg, causal=causal, window=window)
    scores = _gqa_scores(q, k)
    if causal:
        T = k.shape[1]
        m = causal_mask(S, T, T - S, window, device=q.device)
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v)


def _gqa_chunked(q, k, v, cfg: ModelConfig, *, causal: bool,
                 window: Optional[int]) -> torch.Tensor:
    """q-chunked attention: the scores exist only for one block of
    attn_q_chunk query rows at a time.  As in the reference, query i of
    the prompt sits at key position i (not T - S + i as in the flat path:
    the same for the S == T prefill, the only caller).  The last block is
    short where the JAX code pads it; softmax rows are independent, so
    the kept rows are the same."""
    S, T = q.shape[1], k.shape[1]
    Qc = min(cfg.attn_q_chunk, S)
    kpos = torch.arange(T, device=q.device)[None, :]
    outs = []
    for lo in range(0, S, Qc):
        qb = q[:, lo:lo + Qc]
        scores = _gqa_scores(qb, k)  # (B,Hk,G,Qc,T)
        if causal:
            qpos = lo + torch.arange(qb.shape[1], device=q.device)[:, None]
            m = kpos <= qpos
            if window is not None:
                m &= kpos > qpos - window
            scores = torch.where(m, scores, NEG_INF)
        outs.append(_gqa_out(torch.softmax(scores, dim=-1), v))
    return torch.cat(outs, dim=1)


def encoder_kv(p, enc_x, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output (cached at prefill)."""
    k = _split_heads(dense(enc_x, p["wk"]), cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(dense(enc_x, p["wv"]), cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = head_rms_norm(k, p["k_scale"], cfg.norm_eps)
    return k, v


# --------------------------------------------------------------------------
# Decode (one new token against a KV cache)
# --------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, layers: int,
                  dtype: torch.dtype, device: torch.device):
    shape = (layers, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_store_heads(cfg: ModelConfig) -> int:
    """KV heads a serve cache stores under the active mesh and env: Hk,
    or the model shard count where it is a multiple of Hk that also
    divides the query heads (each KV head repeated for the ranks that
    read it)."""
    m = SH.axis_size(SH.get_axis_env().resolve("model"))
    Hk = cfg.num_kv_heads
    if m <= 1 or Hk % m == 0:
        return Hk
    if m % Hk == 0 and cfg.num_heads % m == 0:
        return m
    return Hk


def cache_rows(t, He: int, split_rows: bool = True):
    """New K/V `t` (B, ..., Hk, dh) as they go into a cache of He stored
    heads: on each rank its local shard of the cache's layout (its rows
    split as the batch is, or with `split_rows` False every row, as a
    page pool takes them; this rank's heads), KV heads repeated to He.  A
    plain tensor stays whole (repeated where He > Hk)."""
    R = He // t.shape[-2]
    if not SH.is_dtensor(t):
        return t.repeat_interleave(R, dim=-2) if R > 1 else t
    names = (("batch" if split_rows else None,) + (None,) * (t.dim() - 3)
             + ("model", None))
    if R == 1:
        return SH.shard(t, *names).to_local()
    whole = SH.shard(t, *(None,) * t.dim()).to_local()
    whole = whole.repeat_interleave(R, dim=-2)
    spec = SH.resolve_spec(tuple(whole.shape), names)
    return SH.distribute(whole, spec, t.device_mesh).to_local()


def _rows_split(cache) -> bool:
    """Is the (B, ...) cache view split over its rows (a dense serve
    cache under a mesh whose batch axes divide B)?"""
    return SH.is_dtensor(cache) and any(
        getattr(pl, "dim", None) == 0 for pl in cache.placements)


def _local_q(q, cache_k):
    """(q's local shard, its rows): q (B, S, Hq, dh) laid out with its
    heads as the cache's heads are (split over "model", or whole), its
    rows over the batch axes."""
    if not SH.is_dtensor(q):
        return q, q, slice(None)
    split = SH.is_dtensor(cache_k) and any(
        getattr(pl, "dim", None) in (cache_k.dim() - 2, -2)
        for pl in cache_k.placements)
    q = SH.shard(q, "batch", None, "model" if split else None, None)
    return q, q.to_local(), SH.local_slice(q, 0)


def _paged_gather(pool, bt, C):
    """pool: (Np,P,Hk,dh); bt: (B,n_max) page ids -> (B,C,Hk,dh) view.
    Positions past a row's length read whatever the page holds; callers
    mask them with NEG_INF, an exact softmax zero."""
    B = bt.shape[0]
    Hk, dh = pool.shape[2], pool.shape[3]
    return pool[bt.long()].reshape(B, -1, Hk, dh)[:, :C]


def _attn_out(p, out, qd, S: int):
    """The output projection of a decode or verify attention: `out` (this
    rank's rows and heads, (B, S, Hq, dh)) laid out as q was, then wo."""
    out = SH.from_local_like(out, qd)
    y = dense(out.reshape(out.shape[0], S, -1), p["wo"])
    return shard(y, "batch", None, None)


def attention_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     encoder_kv_cache=None, active=None, block_tables=None,
                     logical_len=None):
    """x: (B,1,d); cache_k/v: (B,C,Hk,dh) views into the layer-stacked
    cache; pos: () current length, or (B,) — one position per row.

    The new K/V are written IN PLACE into cache_k/cache_v (the JAX engine
    donates the cache buffer to the same update).  active: optional (B,)
    bool (vector pos only): rows where it is False are retired slots whose
    cache must not change — their dense write puts back the row's own old
    value, and their paged write goes to the trash page.

    encoder_kv_cache: (k, v) (B,T,Hk,dh) of `encoder_kv` — the
    cross-attention read: every encoder position is visible, and nothing
    is written (cache_k/v are not read and may be None).

    block_tables: optional (B, n_max) int — PAGED mode: cache_k/v are the
    shared pool (Np+1, P, Hk, dh) of `model.init_paged_cache` and row b's
    position q lives in pool[block_tables[b, q // P], q % P].  logical_len
    bounds the gathered view (the dense cache_len it replaces).

    With a sliding window the dense cache is a ring of C = window slots:
    position q lives in slot q mod C, and once q >= C every slot holds one
    of the last C positions.

    Under a mesh the caches are DTensors split on their head dim (the
    module docstring): the writes land in each rank's shard, and the
    attention runs on this rank's rows and heads (the paged kernel on
    the local pool).  A cache may store more heads than Hk
    (`kv_store_heads`); the new K/V are repeated to match.

    Returns (y, cache_k, cache_v)."""
    B = x.shape[0]
    paged = block_tables is not None
    ring = cfg.attention_kind == "sliding_window"
    if paged and ring:
        raise ValueError("paged KV does not support sliding-window caches")
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.dim() == 1
    if paged and not per_row:
        raise ValueError("paged KV requires a per-row pos vector")
    pos_b = (pos if per_row else pos.expand(B)).long()  # (B,)
    if encoder_kv_cache is not None:
        k, v = encoder_kv_cache
        qd, q, mine = _local_q(_cross_q(p, x, cfg), k)
        if not _rows_split(k):
            k, v = SH.local(k)[mine], SH.local(v)[mine]
        else:
            k, v = SH.local(k), SH.local(v)
        probs = torch.softmax(_gqa_scores(q, k), dim=-1)
        return _attn_out(p, _gqa_out(probs, v), qd, 1), cache_k, cache_v
    q, k1, v1 = _project_qkv(p, x, pos_b[:, None], cfg)
    He = cache_k.shape[-2]
    # my heads; a pool takes every row, a dense cache my rows
    k1, v1 = (cache_rows(t, He, split_rows=not paged) for t in (k1, v1))
    qd, q, mine = _local_q(q, cache_k)
    ck, cv = SH.local(cache_k), SH.local(cache_v)
    pos_r = pos_b[mine]                              # my rows' positions
    if paged:
        Np, P = ck.shape[0] - 1, ck.shape[1]         # page Np: trash
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
        ck[page, pos_b % P] = k1[:, 0].to(ck.dtype)
        cv[page, pos_b % P] = v1[:, 0].to(cv.dtype)
        bt = block_tables[mine]
        if cfg.use_paged_kernel:
            from repro_torch.kernels import ops as K
            out = K.paged_attention(q[:, 0], ck, cv, bt.int(), pos_r.int(),
                                    logical_len=C)
            return _attn_out(p, out[:, None], qd, 1), cache_k, cache_v
        k = _paged_gather(ck, bt, C)
        v = _paged_gather(cv, bt, C)
    else:
        C = ck.shape[1]
        if per_row:
            mc = SH.local_slice(cache_k, 0)          # the rows I hold
            pc = pos_b[mc]
            rows = torch.arange(ck.shape[0], device=x.device)
            if ring:
                slot, keep = pc % C, torch.ones_like(pc, dtype=bool)
            else:
                slot, keep = pc.clamp(max=C - 1), pc < C
            if active is not None:
                keep = keep & active[mc]
            keep = keep[:, None, None]
            # in place (the JAX engine donates the cache); a retired row
            # writes its own old value back: rows are distinct, so no
            # write collides with another row's
            ck[rows, slot] = torch.where(keep, k1[:, 0].to(ck.dtype),
                                         ck[rows, slot])
            cv[rows, slot] = torch.where(keep, v1[:, 0].to(cv.dtype),
                                         cv[rows, slot])
        else:
            slot = (pos % C if ring else pos).reshape(1).long()
            ck.index_copy_(1, slot, k1.to(ck.dtype))
            cv.index_copy_(1, slot, v1.to(cv.dtype))
        k, v = (ck, cv) if _rows_split(cache_k) else (ck[mine], cv[mine])
    idx = torch.arange(C, device=x.device)[None, :]
    if ring:
        valid = (idx <= (pos_r % C)[:, None]) | (pos_r[:, None] >= C)
    else:
        valid = idx <= pos_r[:, None]
    scores = _gqa_scores(q, k)  # (B,Hk,G,1,C)
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _attn_out(p, _gqa_out(probs, v), qd, 1), cache_k, cache_v


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
    as in `attention_decode`, which also says how a mesh splits them.  An
    inactive row writes its own old value back (dense) or to the trash
    page (paged); a position past the cache is masked and never written.
    In paged mode with cfg.use_paged_kernel the attention reads through
    the paged kernel: one launch of B*S query rows, row (b, i) at
    position pos[b] + i through table row b.

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
    He = cache_k.shape[-2]
    # my heads; a pool takes every row, a dense cache my rows
    k1, v1 = (cache_rows(t, He, split_rows=not paged) for t in (k1, v1))
    qd, q, mine = _local_q(q, cache_k)
    ck, cv = SH.local(cache_k), SH.local(cache_v)
    qpos_r = qpos[mine]
    if paged:
        Np, P = ck.shape[0] - 1, ck.shape[1]         # page Np: trash
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
        ck[page, qpos % P] = k1.to(ck.dtype)
        cv[page, qpos % P] = v1.to(cv.dtype)
        bt = block_tables[mine]
        if cfg.use_paged_kernel:
            from repro_torch.kernels import ops as K
            # a query past the cache attends every cached position, as
            # the plain path's mask gives it
            Bl = q.shape[0]
            rows = qpos_r.clamp(max=C - 1).reshape(-1).int()
            bt = bt.int().repeat_interleave(S, dim=0)
            out = K.paged_attention(q.reshape(Bl * S, *q.shape[2:]), ck, cv,
                                    bt, rows, logical_len=C)
            return (_attn_out(p, out.reshape(Bl, S, *out.shape[1:]), qd, S),
                    cache_k, cache_v)
        k = _paged_gather(ck, bt, C)
        v = _paged_gather(cv, bt, C)
    else:
        C = ck.shape[1]
        mc = SH.local_slice(cache_k, 0)              # the rows I hold
        qc = qpos[mc]
        rows = torch.arange(ck.shape[0], device=x.device)
        # candidate by candidate, so that a clamped position past the
        # cache writes back what an earlier candidate left at C - 1
        for i in range(S):
            slot = qc[:, i].clamp(max=C - 1)
            keep = qc[:, i] < C
            if active is not None:
                keep = keep & active[mc]
            keep = keep[:, None, None]
            ck[rows, slot] = torch.where(
                keep, k1[:, i].to(ck.dtype), ck[rows, slot])
            cv[rows, slot] = torch.where(
                keep, v1[:, i].to(cv.dtype), cv[rows, slot])
        k, v = (ck, cv) if _rows_split(cache_k) else (ck[mine], cv[mine])
    valid = torch.arange(C, device=x.device)[None, None] <= qpos_r[:, :, None]
    scores = _gqa_scores(q, k)  # (B,Hk,G,S,C)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _attn_out(p, _gqa_out(probs, v), qd, S), cache_k, cache_v
