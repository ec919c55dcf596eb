"""Mamba2 (State-Space Duality) block: chunked prefill, recurrent decode.

The PyTorch counterpart of the JAX package's ``models/ssm.py``.  The
prefill runs the SSD block decomposition (Dao & Gu 2024): a within-chunk
decay-masked quadratic term plus an (N,P) state carried across chunks,
with ``cfg.use_ssd_kernel`` through ``kernels.ops.ssd_scan`` (the CUDA
kernel for CUDA tensors) and otherwise through its plain version, the
math the JAX model runs.  Decode is the O(1) recurrent form with a conv
ring state.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import sharding as SH
from repro_torch.core.sharding import shard
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models.common import (ParamDesc, dense, rms_norm,
                                       torch_dtype, tree_map)
from repro_torch.models.config import ModelConfig


def ssm_descs(cfg: ModelConfig,
              dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d, din, n, h, w = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv_width)
    return {
        "wz": ParamDesc((d, din), dt, fan_in=d, spec=(None, "model")),
        "wx": ParamDesc((d, din), dt, fan_in=d, spec=(None, "model")),
        "wB": ParamDesc((d, n), dt, fan_in=d, spec=(None, None)),
        "wC": ParamDesc((d, n), dt, fan_in=d, spec=(None, None)),
        "wdt": ParamDesc((d, h), dt, fan_in=d, spec=(None, "model")),
        "conv_x": ParamDesc((w, din), dt, init="small_normal",
                            spec=(None, "model")),
        "conv_B": ParamDesc((w, n), dt, init="small_normal",
                            spec=(None, None)),
        "conv_C": ParamDesc((w, n), dt, init="small_normal",
                            spec=(None, None)),
        "A_log": ParamDesc((h,), "float32", init="zeros", spec=(None,)),
        "D": ParamDesc((h,), "float32", init="ones", spec=(None,)),
        "dt_bias": ParamDesc((h,), "float32", init="zeros", spec=(None,)),
        "norm": ParamDesc((din,), dt, init="ones", spec=(None,)),
        "wo": ParamDesc((din, d), dt, fan_in=din, spec=("model", None)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B,S,C), w: (W,C), cache: (B,W-1,C) or
    None (zeros).  Returns (silu(conv), new cache = the last W-1 inputs)."""
    W = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, :S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out), xp[:, -(W - 1):]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, D: torch.Tensor,
                chunk: int, use_kernel: bool = False):
    """SSD core.  x: (B,S,H,P); dt: (B,S,H) (post-softplus, fp32); b, c:
    (B,S,N).  The chunk scan runs through ``ops.ssd_scan`` when
    ``use_kernel`` (no autograd there) and its plain version otherwise;
    then ``+ D * x``.  Any S: the last chunk may be ragged, where the JAX
    package asserts a whole number of chunks; the scan pads it exactly
    (zero inputs, zero log decay).  Returns y (B,S,H,P) in x.dtype and the
    final state (B,H,N,P) fp32."""
    loga = (-dt * A_log.exp()[None, None]).float()   # (B,S,H)
    xe = (x * dt[..., None]).to(x.dtype)               # dt-scaled input
    if use_kernel:
        from repro_torch.kernels import ops as K
        y, final = K.ssd_scan(xe, loga, b, c, chunk=chunk)
    else:
        y, final = ssd_scan_ref(xe, loga, b, c, chunk)
    y = y + D[None, None, :, None] * x.float()
    return y.to(x.dtype), final


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig, state=None,
              conv_cache=None):
    """Mamba2 block.  x: (B,S,d).

    Prefill (state None): chunked SSD.  Decode (S == 1 with state (B,H,N,P)
    and conv_cache {"x","B","C"} given): the recurrent update.  Returns
    (y, (new_state, new_conv_cache)); the caches given are not modified."""
    B, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z = dense(x, p["wz"])
    xr = dense(x, p["wx"])
    braw = dense(x, p["wB"])
    craw = dense(x, p["wC"])
    dt = F.softplus(dense(x, p["wdt"]).float() + p["dt_bias"][None, None])

    if state is not None and S == 1:
        xc, ncx = _causal_conv(xr, p["conv_x"], conv_cache["x"])
        bc, ncb = _causal_conv(braw, p["conv_B"], conv_cache["B"])
        cc, ncc = _causal_conv(craw, p["conv_C"], conv_cache["C"])
        xh = xc.reshape(B, H, P)
        a = torch.exp(-dt[:, 0] * p["A_log"].exp()[None])   # (B,H)
        xe = xh.float() * dt[:, 0, :, None]
        new_state = state * a[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", bc[:, 0].float(), xe)
        y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), new_state)
        y = y + p["D"][None, :, None] * xh.float()
        y = y.reshape(B, 1, H * P).to(x.dtype)
    else:
        xc, ncx = _causal_conv(xr, p["conv_x"])
        bc, ncb = _causal_conv(braw, p["conv_B"])
        cc, ncc = _causal_conv(craw, p["conv_C"])
        heads = ("batch", None, "model", None)
        xh = shard(xc.reshape(B, S, H, P), *heads)
        # under a mesh, on each rank's own rows and heads
        rows = ("batch", None, None)
        y, new_state = SH.local_map(
            lambda *a: ssd_chunked(*a, cfg.ssm_chunk, cfg.use_ssd_kernel),
            (xh, dt, p["A_log"], bc, cc, p["D"]),
            (heads, heads[:3], ("model",), rows, rows, ("model",)),
            [((B, S, H, P), heads),
             ((B, H, cfg.ssm_state, P), ("batch", "model", None, None))])
        y = y.reshape(B, S, H * P)
    new_conv = {"x": ncx, "B": ncb, "C": ncc}

    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = shard(dense(y, p["wo"]), "batch", "seq", None)
    return out, (new_state, new_conv)


def ssm_state_specs(cfg: ModelConfig, batch: int, layers: int):
    """name -> (shape, dtype): the SSM state (fp32) and the conv ring."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W = cfg.ssm_conv_width
    cdt = torch_dtype(cfg.compute_dtype)
    return {
        "state": ((layers, batch, H, N, P), torch.float32),
        "conv": {
            "x": ((layers, batch, W - 1, cfg.ssm_d_inner), cdt),
            "B": ((layers, batch, W - 1, N), cdt),
            "C": ((layers, batch, W - 1, N), cdt),
        },
    }


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int,
                   device: torch.device):
    return tree_map(lambda s: torch.zeros(s[0], dtype=s[1], device=device),
                    ssm_state_specs(cfg, batch, layers))
