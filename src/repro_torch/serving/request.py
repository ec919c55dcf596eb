"""Request / slot state for the continuous-batching engine (a copy of the
JAX package's ``serving/request.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request.

    prompt: token ids (list/1-D array, length >= 1)
    max_new_tokens: generation budget (includes the token sampled from the
        prompt's last logit, matching the static serve path)
    eos_id: stop token; None = run to the budget
    extra_embeds: optional modality-frontend output for vlm/audio backbones,
        batch dim 1: (1, P, 1024) patches or (1, T_enc, d_model) frames
    kv_seed: optional harvested KV (`engine.MigratedKV`) attached by a
        drain/readmit path; a paged engine installs it instead of
        re-prefilling the prompt
    """
    rid: int
    prompt: Any
    max_new_tokens: int
    eos_id: Optional[int] = None
    extra_embeds: Optional[Any] = None
    kv_seed: Optional[Any] = None


def validate_budget(req: "Request", n_prefix: int, cache_len: int) -> None:
    """Reject a request whose prompt + modality prefix + generation budget
    cannot fit one cache slot (shared by engine- and fleet-level submit:
    a fleet must never route a request its engines would refuse)."""
    plen = len(np.asarray(req.prompt))
    if plen + n_prefix + req.max_new_tokens > cache_len:
        raise ValueError(
            f"request {req.rid}: prompt {plen} + prefix {n_prefix} "
            f"+ gen {req.max_new_tokens} exceeds cache_len {cache_len}")


@dataclasses.dataclass
class FinishedRequest:
    rid: int
    prompt_len: int
    tokens: List[int]          # generated ids, EOS included if hit
    finish_reason: str         # "eos" | "length"
    admitted_tick: int
    finished_tick: int
