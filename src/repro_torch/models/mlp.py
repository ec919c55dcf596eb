"""Dense MLP (swiglu / squared_relu / gelu) and GShard-style
Mixture-of-Experts with capacity routing.

The PyTorch counterpart of the JAX package's ``models/mlp.py``.  The MoE
layer keeps the reference's semantics step by step: group-wise routing,
an fp32 router, top-k with renormalised gates, the Switch load-balance
loss, sort-based position-in-expert, capacity C = max(int(cf*n*k/E), k)
with dropped choices sent to a trash row, and dispatch / combine as
batched gathers around the expert products.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sharding as SH
from repro_torch.core.sharding import shard
from repro_torch.models.common import ParamDesc, dense
from repro_torch.models.config import ModelConfig


def mlp_descs(cfg: ModelConfig, d_ff: Optional[int] = None,
              dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    descs = {
        "w1": ParamDesc((d, ff), dt, fan_in=d, spec=(None, "model")),
        "w2": ParamDesc((ff, d), dt, fan_in=ff, spec=("model", None)),
    }
    if cfg.activation == "swiglu":
        descs["w3"] = ParamDesc((d, ff), dt, fan_in=d, spec=(None, "model"))
    return descs


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(dense(x, p["w1"])) * dense(x, p["w3"])
    elif cfg.activation == "squared_relu":
        h = F.relu(dense(x, p["w1"])).square()
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, p["w1"]), approximate="tanh")
    h = shard(h, "batch", None, "model")
    return dense(h, p["w2"])


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------
def moe_descs(cfg: ModelConfig,
              dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d, E, ffe = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    descs = {
        # the router stays fp32 in a bf16 model, as in the reference
        "router": ParamDesc((d, E), "float32", fan_in=d, spec=(None, None)),
        # experts on the model axis: expert parallelism
        "w1": ParamDesc((E, d, ffe), dt, fan_in=d,
                        spec=("model", None, None)),
        "w2": ParamDesc((E, ffe, d), dt, fan_in=ffe,
                        spec=("model", None, None)),
    }
    if cfg.activation == "swiglu":
        descs["w3"] = ParamDesc((E, d, ffe), dt, fan_in=d,
                                spec=("model", None, None))
    if cfg.moe_dense_residual:
        descs["dense"] = mlp_descs(cfg, cfg.dense_residual_d_ff, dt)
    return descs


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(cfg.capacity_factor * num_tokens * cfg.top_k / cfg.num_experts)
    return max(cap, cfg.top_k)


def top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last dim: values descending, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_slots(eidx: torch.Tensor, num_experts: int, capacity: int):
    """Capacity slots of every (token, choice), per group.  eidx: (G, n*k)
    expert ids in (token, choice) order.  A stable sort groups the choices
    by expert in token order, so position-in-expert = rank - segment
    start; a choice at position >= C is dropped to the trash row E*C.
    Returns (rows (G, n*k): the slot of each choice, slot_to_src
    (G, E*C + 1): the choice each slot holds, n*k where none does)."""
    G, nk = eidx.shape
    E, C = num_experts, capacity
    order = torch.sort(eidx, dim=1, stable=True).indices
    sorted_e = eidx.gather(1, order)
    iota = torch.arange(nk, device=eidx.device).expand(G, nk)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, iota, 0), dim=1).values
    pos = torch.empty_like(eidx).scatter_(1, order, iota - seg_start)
    rows = torch.where(pos < C, eidx * C + pos, E * C)
    # kept choices own distinct slots; only the trash slot E*C is written
    # more than once, and it is sliced off, so a nondeterministic scatter
    # cannot change a kept slot
    slot_to_src = torch.full((G, E * C + 1), nk, dtype=eidx.dtype,
                             device=eidx.device)
    slot_to_src.scatter_(1, rows, iota)
    return rows, slot_to_src


def _experts(p, eb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The expert products, batched over experts.  eb: (G, E, C, d) ->
    (G, E, C, d): gecd,edf->gecf then gecf,efd->gecd as (E, G*C, .)
    batched matrix products over the stacked (E, ...) weights."""
    G, E, C, d = eb.shape
    xe = eb.transpose(0, 1).reshape(E, G * C, d)
    dt = eb.dtype
    h = torch.bmm(xe, p["w1"].to(dt))
    if cfg.activation == "swiglu":
        h = F.silu(h) * torch.bmm(xe, p["w3"].to(dt))
    else:
        h = F.relu(h).square()
    out = torch.bmm(h, p["w2"].to(dt))
    return out.reshape(E, G, C, d).transpose(0, 1)


def moe(p, x: torch.Tensor, cfg: ModelConfig, groups: Optional[int] = None):
    """x: (B,S,d) -> (y, aux_loss).  GShard-style GROUP-WISE routing:
    tokens are routed within independent groups (default: one group per
    sequence when S > 1, else all B rows one group; cfg.moe_groups
    overrides), each with its own capacity C = max(int(cf*n*k/E), k)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    N = B * S
    if groups is None:
        groups = cfg.moe_groups or None
    G = groups if groups is not None else (B if S > 1 else 1)
    if N % G:
        raise ValueError(f"moe: {N} tokens do not split into {G} groups")
    n = N // G
    C = moe_capacity(cfg, n)
    # routing is per group: each rank routes its own groups (all of them
    # where the group dim is not split), on local tensors
    xg = shard(x.reshape(G, n, d), "batch", None, None)
    grp = _GroupLayout(xg)

    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(grp.local(probs), k)               # (G, n, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # Switch-style load-balance auxiliary loss (global statistics)
    density = grp.wrap(F.one_hot(idx[..., 0], E).float()).mean(dim=(0, 1))
    aux = E * torch.sum(density * probs.mean(dim=(0, 1)))

    rows, slot_to_src = moe_slots(idx.reshape(-1, n * k), E, C)
    # dispatch: slot <- its choice's token (choice j of token t is source
    # t*k + j, as in the reference's token-repeated rows); empty slots
    # read the zero row n
    src = slot_to_src[:, :E * C]
    tok = torch.where(src < n * k, src // k, n)
    xl = grp.local(xg)
    Gl = xl.shape[0]
    xpad = torch.cat([xl, xl.new_zeros(Gl, 1, d)], dim=1)
    eb = xpad.gather(1, tok[:, :, None].expand(Gl, E * C, d))
    eb = grp.wrap(eb.reshape(Gl, E, C, d))
    eb = shard(eb, "batch", "model", None, None)  # <- all-to-all (d -> E)
    out = shard(_experts(p, eb, cfg), "batch", "model", None, None)

    # combine: each choice reads its slot (dropped ones the zero row E*C);
    # all-to-all back (E -> d) first
    flat = torch.cat([out.reshape(G, E * C, d),
                      grp.wrap(xl.new_zeros(Gl, 1, d))], dim=1)
    flat = shard(flat, "batch", None, "model")
    fl = grp.local(flat)
    dl = fl.shape[-1]
    gathered = fl.gather(1, rows[:, :, None].expand(Gl, n * k, dl))
    # the gate product under DTensor, whose backward sums the gate's
    # gradient over the mesh dims that split d
    gathered = grp.wrap(gathered.reshape(Gl, n, k, dl), like=flat, d_dim=3)
    y = torch.sum(gathered * grp.wrap(gate)[..., None].to(out.dtype), dim=2)
    y = y.reshape(B, S, d)
    if cfg.moe_dense_residual:
        y = y + mlp(p["dense"], x, cfg)
    return shard(y, "batch", "seq", None), aux


class _GroupLayout:
    """The MoE's routing tensors are each rank's own groups: the local
    rows of the group dim of `xg`, laid out as ("batch", None, None).
    `local` takes a DTensor's local tensor; `wrap` makes a local (G_l,
    ...) tensor a DTensor again, with xg's placements (or those of
    `like`, of the same rank).  Without a mesh both are identities."""

    def __init__(self, xg):
        self.xg = xg if SH.is_dtensor(xg) else None

    def local(self, t):
        return t.to_local() if self.xg is not None else t

    def wrap(self, t, like=None, d_dim=None):
        """`like`'s split of its last dim goes to dim `d_dim` of t."""
        if self.xg is None:
            return t
        from torch.distributed.tensor import DTensor, Shard
        like = self.xg if like is None else like
        pl = like.placements
        if d_dim is not None:
            pl = [Shard(d_dim) if isinstance(q, Shard) and q.dim != 0 else q
                  for q in pl]
        return DTensor.from_local(t, like.device_mesh, pl, run_check=False)
