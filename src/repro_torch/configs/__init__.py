"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each module defines CONFIG (the exact published architecture) and SMOKE (a
reduced same-family variant for CPU tests), as in the JAX package, whose
ten architectures are all registered here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from repro_torch.models.config import ModelConfig

_MODULES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen3-1.7b": "qwen3_1p7b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "nemotron-4-340b": "nemotron4_340b",
    "qwen3-0.6b": "qwen3_0p6b",
    "deepseek-7b": "deepseek_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "whisper-tiny": "whisper_tiny",
    "arctic-480b": "arctic_480b",
    "rwkv6-1.6b": "rwkv6_1p6b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


# ---------------------------------------------------------------------------
# Input shapes: name -> (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | decode_cb


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    # continuous-batching decode: per-slot position vector + active mask
    "decode_cb_32k": InputShape("decode_cb_32k", 32_768, 128, "decode_cb"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_plan(arch: str, shape: str) -> Optional[ModelConfig]:
    """The config to use for (arch, shape), or None if skipped.

    long_500k needs sub-quadratic state: the ssm and hybrid families run
    as they are; the attention archs run the sliding-window variant
    (window 4096, name suffix "-swa"); whisper-tiny is skipped (full
    encoder-decoder attention, a 448-token decoder context by its spec).
    """
    cfg = get_config(arch)
    if shape != "long_500k":
        return cfg
    if arch == "whisper-tiny":
        return None
    if cfg.arch_type in ("ssm", "hybrid"):
        return cfg
    return cfg.with_(attention_kind="sliding_window", sliding_window=4096,
                     name=cfg.name + "-swa")
