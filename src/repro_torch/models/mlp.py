"""Dense MLP (swiglu / squared_relu / gelu).

The PyTorch counterpart of the dense half of the JAX package's
``models/mlp.py``; Mixture-of-Experts is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDesc, dense
from repro_torch.models.config import ModelConfig


def mlp_descs(cfg: ModelConfig, d_ff: Optional[int] = None,
              dtype: Optional[str] = None) -> Dict[str, ParamDesc]:
    dt = dtype or cfg.param_dtype
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    descs = {
        "w1": ParamDesc((d, ff), dt, fan_in=d),
        "w2": ParamDesc((ff, d), dt, fan_in=ff),
    }
    if cfg.activation == "swiglu":
        descs["w3"] = ParamDesc((d, ff), dt, fan_in=d)
    return descs


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(dense(x, p["w1"])) * dense(x, p["w3"])
    elif cfg.activation == "squared_relu":
        h = F.relu(dense(x, p["w1"])).square()
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(x, p["w1"]), approximate="tanh")
    return dense(h, p["w2"])
