"""Carry parameter trees between the JAX package and the port.

The JAX ``init_model`` tree, turned into numpy arrays by its caller
(``jax.tree_util.tree_map(np.asarray, params)``), maps one to one onto the
port's parameters: the same nested keys, the same stacked ``(L, ...)``
layer leaves, weights kept ``(in, out)``.  The port never imports JAX; the
parity tests use this to feed both packages the same weights.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

# leaves the port's descriptors keep fp32 whatever the param dtype (the
# MoE router, `models/mlp.py::moe_descs`; the Mamba2 scalars,
# `models/ssm.py`; the RWKV6 decay base and bonus, `models/rwkv.py`): a
# cast leaves them fp32
FP32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias", "w0", "u"})


def _leaf_to_torch(a, device: torch.device,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no torch view
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on `device` (the CUDA card unless given), cast to `dtype` when given,
    apart from the leaves named in FP32_LEAVES, which become fp32.  A
    tuple stays a tuple."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: (_leaf_to_torch(v, dev, torch.float32)
                    if dtype is not None and k in FP32_LEAVES
                    else params_from_numpy(v, dev, dtype))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev, dtype) for v in tree)
    return _leaf_to_torch(tree, dev, dtype)


def params_to_numpy(tree: Any) -> Any:
    """The reverse: nested dicts and lists of tensors -> the same tree of
    float numpy arrays (bfloat16 widened to float32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
