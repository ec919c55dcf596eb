"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each module defines CONFIG (the exact published architecture) and SMOKE (a
reduced same-family variant for CPU tests), as in the JAX package.  Only
the architectures ported so far are registered.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen3-0.6b": "qwen3_0p6b",
    "qwen3-1.7b": "qwen3_1p7b",
    "deepseek-7b": "deepseek_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "arctic-480b": "arctic_480b",
    "zamba2-1.2b": "zamba2_1p2b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
