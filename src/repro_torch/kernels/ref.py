"""Plain PyTorch versions of the attention kernels.

The same semantics as the JAX package's ``kernels/ref.py`` oracles:
scores in fp32, probabilities cast to ``v.dtype`` before the PV product,
masked scores set to ``NEG_INF`` (so a fully masked row averages
uniformly, where the kernels emit 0).  The CPU path of every wrapper in
``kernels.ops`` runs these, and the tests and ``chip_smoke.py`` hold the
CUDA kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hq,dh); k,v: (B,T,Hk,dh), Hq % Hk == 0.  fp32 softmax.
    Queries end at key position T-1.  Returns (B,S,Hq,dh) in q.dtype."""
    B, S, Hq, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    sc = scale if scale is not None else dh ** -0.5
    qg = q.reshape(B, S, Hk, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * sc
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        m = kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, dh).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        pos: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,dh) one decode token per row; k/v_pool: (Np,P,Hk,dh);
    block_tables: (B,n_max) page ids; pos: (B,) — attend idx <= pos[b]."""
    B, Hq, dh = q.shape
    _, P, Hk, _ = k_pool.shape
    G = Hq // Hk
    bt = block_tables.long()
    C = bt.shape[1] * P
    sc = scale if scale is not None else dh ** -0.5
    k = k_pool[bt].reshape(B, C, Hk, dh)
    v = v_pool[bt].reshape(B, C, Hk, dh)
    qg = q.reshape(B, Hk, G, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * sc
    valid = (torch.arange(C, device=q.device)[None, :]
             <= pos.long()[:, None])                          # (B,C)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v.dtype), v)
    return out.reshape(B, Hq, dh).to(q.dtype)
