"""RWKV6 (Finch) block: data-dependent per-channel decay linear attention.

The PyTorch counterpart of the JAX package's ``models/rwkv.py``.  Prefill
runs the exact WKV recurrence as a loop over time in fp32, where the JAX
package runs a ``lax.scan`` (its module names a Pallas ``kernels/wkv6.py``
that does not exist, so there is no TPU kernel to port here); decode is
the O(1) recurrent update.

State per layer: wkv (B,H,K,V) fp32 + token-shift caches (B,d) x2.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sharding as SH
from repro_torch.core.sharding import shard
from repro_torch.models.common import ParamDesc, dense, rms_norm, torch_dtype
from repro_torch.models.config import ModelConfig


def rwkv_descs(cfg: ModelConfig,
               dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d, ff, r = cfg.d_model, cfg.d_ff, cfg.rwkv_decay_lora
    H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        # time-mix coefficients (token shift interpolation) for r,k,v,w,g
        "mix": ParamDesc((5, d), dt, init="small_normal", spec=(None, None)),
        "wr": ParamDesc((d, d), dt, fan_in=d, spec=(None, "model")),
        "wk": ParamDesc((d, d), dt, fan_in=d, spec=(None, "model")),
        "wv": ParamDesc((d, d), dt, fan_in=d, spec=(None, "model")),
        "wg": ParamDesc((d, d), dt, fan_in=d, spec=(None, "model")),
        "wo": ParamDesc((d, d), dt, fan_in=d, spec=("model", None)),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x@A)@B)), fp32
        # leaves in a bf16 model, as in the reference
        "w0": ParamDesc((d,), "float32", init="zeros", spec=(None,)),
        "wA": ParamDesc((d, r), dt, fan_in=d, spec=(None, None)),
        "wB": ParamDesc((r, d), dt, init="small_normal", spec=(None, None)),
        "u": ParamDesc((H, K), "float32", init="small_normal",
                       spec=(None, None)),
        "ln_x": ParamDesc((d,), dt, init="ones", spec=(None,)),
        # channel mix
        "mix_cm": ParamDesc((2, d), dt, init="small_normal",
                            spec=(None, None)),
        "ck": ParamDesc((d, ff), dt, fan_in=d, spec=(None, "model")),
        "cv": ParamDesc((ff, d), dt, fan_in=ff, spec=("model", None)),
        "ln1": ParamDesc((d,), dt, init="ones", spec=(None,)),
        "ln2": ParamDesc((d,), dt, init="ones", spec=(None,)),
    }


def _token_shift(x, prev):
    """shifted[t] = x[t-1]; shifted[0] = prev (or 0). x: (B,S,d),
    prev: (B,d)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def wkv_step(state, r, k, v, w, u):
    """One-token recurrent update. r,k,w: (B,H,K); v: (B,H,V); state
    (B,H,K,V) fp32.  Returns (y (B,H,V), new state)."""
    kv = k[..., None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, ..., None] * kv)
    return y, state * w[..., None] + kv


def wkv_scan(r, k, v, w, u):
    """The exact WKV6 recurrence, one step a token, in fp32.

    r,k,w: (B,S,H,K); v: (B,S,H,V); u: (H,K).
      y_t = r_t . (S_{t-1} + u * k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns y: (B,S,H,V) fp32, final state (B,H,K,V) fp32."""
    B, S, H, K = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    state = torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(S):
        y, state = wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def rwkv_block(p, x, cfg: ModelConfig, state=None):
    """x: (B,S,d).  state: None (prefill) or dict (decode, S == 1).

    Returns (y, new_state) with new_state =
      {"wkv": (B,H,K,V) f32, "tm": (B,d), "cm": (B,d)}."""
    B, S, d = x.shape
    H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
    prev_tm = state["tm"] if state is not None else None
    prev_cm = state["cm"] if state is not None else None

    # ---- time mix ----
    xa = rms_norm(x, p["ln1"], cfg.norm_eps)
    xs = _token_shift(xa, prev_tm)
    mix = p["mix"].to(x.dtype)  # (5,d)

    def mixed(i):
        return xa + (xs - xa) * mix[i]
    r = dense(mixed(0), p["wr"]).reshape(B, S, H, K)
    k = dense(mixed(1), p["wk"]).reshape(B, S, H, K)
    v = dense(mixed(2), p["wv"]).reshape(B, S, H, K)
    g = F.silu(dense(mixed(4), p["wg"]))
    lora = torch.tanh(dense(mixed(3), p["wA"]).float()) @ p["wB"].float()
    logw = -torch.exp(torch.clamp(p["w0"].float() + lora, -8.0, 8.0))
    w = torch.exp(logw).reshape(B, S, H, K)  # in (0,1)

    heads = ("batch", None, "model", None)
    r, k, v, w = (shard(t, *heads) for t in (r, k, v, w))
    if state is None or S > 1:
        if state is not None:  # as in the reference
            raise NotImplementedError("chunked continuation not needed")
        # under a mesh, on each rank's own rows and heads
        y, wkv_new = SH.local_map(
            wkv_scan, (r, k, v, w, p["u"]), (heads,) * 4 + (("model", None),),
            [((B, S, H, K), heads),
             ((B, H, K, K), ("batch", "model", None, None))])
    else:
        yv, wkv_new = wkv_step(state["wkv"], r[:, 0].float(),
                               k[:, 0].float(), v[:, 0].float(),
                               w[:, 0].float(), p["u"].float())
        y = yv[:, None]
    y = y.reshape(B, S, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    x = x + shard(dense(y, p["wo"]), "batch", None, None)

    # ---- channel mix ----
    xc = rms_norm(x, p["ln2"], cfg.norm_eps)
    xs2 = _token_shift(xc, prev_cm)
    mix_cm = p["mix_cm"].to(x.dtype)
    xk = xc + (xs2 - xc) * mix_cm[0]
    h = shard(F.relu(dense(xk, p["ck"])).square(), "batch", None, "model")
    y_final = x + shard(dense(h, p["cv"]), "batch", None, None)
    return y_final, {"wkv": wkv_new, "tm": xa[:, -1], "cm": xc[:, -1]}


def rwkv_state_specs(cfg: ModelConfig, batch: int, layers: int):
    """name -> (shape, dtype) of the recurrent state, stacked by layer."""
    H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
    cdt = torch_dtype(cfg.compute_dtype)
    return {"wkv": ((layers, batch, H, K, K), torch.float32),
            "tm": ((layers, batch, cfg.d_model), cdt),
            "cm": ((layers, batch, cfg.d_model), cdt)}


def init_rwkv_state(cfg: ModelConfig, batch: int, layers: int,
                    device: torch.device):
    return {n: torch.zeros(shape, dtype=dt, device=device)
            for n, (shape, dt) in rwkv_state_specs(cfg, batch,
                                                   layers).items()}
