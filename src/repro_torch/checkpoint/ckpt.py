"""Checkpoints of parameter and optimizer trees, in the JAX package's layout.

Layout (that of the JAX package's ``checkpoint/ckpt.py``, so checkpoints
load across the two packages): ``<dir>/step_<N>/`` holding one ``.npy``
per leaf, named by its ``__``-joined dict keys, and ``manifest.json``
(step, metadata, each leaf's shape and logical dtype).  numpy has no
bfloat16, so a bf16 leaf is stored as float32 and cast back on restore
from the manifest's dtype.  Writes are atomic: leaves go to a tmp dir
that one rename makes visible, so a killed run never leaves a half
checkpoint that restores silently.

Not ported yet: the asynchronous writer (``async_ckpt.py``) and the
elastic fleet's rewind floor and failure-injection hooks.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Pytree = Any

_SEP = "__"
# the leaf types of parameter and optimizer trees, by numpy's names
_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int32: "int32"}


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path key: leaf}, keys in sorted order (JAX's leaf order)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for k in sorted(tree):
        flat.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix
                             else str(k)))
    return flat


def _unflatten_like(like: Pytree, flat: Dict[str, Any],
                    prefix: str = "") -> Pytree:
    if not isinstance(like, dict):
        return flat[prefix]
    return {k: _unflatten_like(like[k], flat,
                               f"{prefix}{_SEP}{k}" if prefix else str(k))
            for k in sorted(like)}


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy leaf as stored, logical dtype name)."""
    t = t.detach().cpu()
    name = _NP_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy(), name


def sweep_tmp(ckpt_dir: str) -> list:
    """Clean up debris of killed runs: remove orphaned ``.tmp_step_*``
    dirs, and resolve ``.old_step_*`` dirs (a checkpoint displaced by an
    overwrite) — put back if the replacement never committed, deleted if
    it did.  One trainer owns a ckpt_dir (single writer)."""
    base = pathlib.Path(ckpt_dir)
    swept = []
    if base.exists():
        for p in base.glob(".tmp_step_*"):
            shutil.rmtree(p)
            swept.append(str(p))
        for p in base.glob(".old_step_*"):
            dest = base / p.name[len(".old_"):]
            if dest.exists():      # replacement committed: old copy is junk
                shutil.rmtree(p)
            else:                  # killed mid-replace: the old copy IS the
                os.rename(p, dest)  # newest committed state — put it back
            swept.append(str(p))
    return swept


def _complete_steps(base: pathlib.Path) -> list:
    return sorted((int(p.name.split("_")[1]), p) for p in base.glob("step_*")
                  if (p / "manifest.json").exists())


def gc_checkpoints(ckpt_dir: str, keep_last: int) -> list:
    """Delete all but the newest `keep_last` complete checkpoints."""
    base = pathlib.Path(ckpt_dir)
    if keep_last <= 0 or not base.exists():
        return []
    removed = []
    for _, p in _complete_steps(base)[:-keep_last]:
        shutil.rmtree(p)
        removed.append(str(p))
    return removed


def _commit(tmp: pathlib.Path, final: pathlib.Path) -> None:
    """The commit point: rename tmp -> final.  An existing step is first
    displaced to ``.old_<name>`` (never deleted before the new copy
    lands); `sweep_tmp` repairs a kill between the two renames."""
    old = None
    if final.exists():
        old = final.parent / f".old_{final.name}"
        if old.exists():
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old)


def save_checkpoint(ckpt_dir: str, step: int, tree: Pytree,
                    metadata: Optional[Dict] = None) -> str:
    """Write `tree` as step `step`, one leaf at a time (peak host memory
    about one leaf).  Every save sweeps tmp dirs left by killed runs."""
    base = pathlib.Path(ckpt_dir)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    base.mkdir(parents=True, exist_ok=True)
    sweep_tmp(ckpt_dir)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _host(leaf)
        np.save(tmp / f"{key}.npy", arr)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    _commit(tmp, final)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = _complete_steps(base)
    return steps[-1][0] if steps else None


def restore_checkpoint(ckpt_dir: str, like: Pytree) -> Tuple[Pytree, Dict]:
    """Load the newest checkpoint into the structure of `like`, a tree of
    tensors whose shapes must match; each leaf comes back with its `like`
    leaf's dtype and device.  Returns (tree, metadata)."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = {}
    for key, want in _flatten(like).items():
        arr = np.load(d / f"{key}.npy")
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(want.shape)}")
        out[key] = torch.from_numpy(arr).to(device=want.device,
                                            dtype=want.dtype)
    return _unflatten_like(like, out), manifest["metadata"]
