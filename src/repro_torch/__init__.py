"""PyTorch/CUDA port of the ``repro`` JAX package.

Mirrors the JAX package's module and function names.  Entry points run on
the CUDA card unless the caller asks for the CPU (``device="cpu"``), where
every kernel wrapper takes its plain PyTorch version.

Importing the package itself does not import torch, so that its
stdlib-only parts (``repro_torch.obs``) load in worker processes that
have no torch.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Union

if TYPE_CHECKING:
    import torch

DeviceLike = Union[str, "torch.device", None]


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Without a card and without an explicit device this raises
    instead of quietly running on the CPU."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return torch.device("cuda")
