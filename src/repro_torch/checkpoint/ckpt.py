"""Checkpoints of parameter and optimizer trees, in the JAX package's layout.

Layout (that of the JAX package's ``checkpoint/ckpt.py``, so checkpoints
load across the two packages): ``<dir>/step_<N>/`` holding one ``.npy``
per leaf, named by its ``__``-joined dict keys, and ``manifest.json``
(step, metadata, each leaf's shape and logical dtype).  numpy has no
bfloat16, so a bf16 leaf is stored as float32 and cast back on restore
from the manifest's dtype.  Writes are atomic: leaves go to a tmp dir
that one rename makes visible, so a killed run never leaves a half
checkpoint that restores silently.

The write path is built from stages shared with the asynchronous writer
(`checkpoint/async_ckpt.py`): per-leaf host copies (`iter_snapshot`), the
manifest, the tmp sweep (`stage_dirs`), the atomic commit
(`commit_staged`) and retention (`gc_checkpoints`), so both savers write
the same bytes.  They differ only in data flow: the blocking
`save_checkpoint` streams one leaf at a time (peak host memory about one
leaf), the asynchronous one stages the whole snapshot first
(`host_snapshot` + `write_staged`), the host copy that lets a background
thread write while training goes on.

A tree with DTensor leaves (a mesh's state) is saved by every rank of
the mesh in the same leaf order: each leaf is made whole on every rank
(a collective), rank 0 writes it and the other ranks drop it at once, so
the files are those of the same tree saved whole.  A restore into such a
tree reads each leaf and keeps the rank's own shard, with no collective.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sharding as SH

Pytree = Any

_SEP = "__"
# the leaf types of parameter and optimizer trees, by numpy's names
_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int32: "int32"}
_TORCH_DTYPES = {name: dt for dt, name in _NP_NAMES.items()}


def _children(tree: Pytree):
    """(key, child) pairs of a dict (keys sorted) or a list/tuple (its
    indices), as JAX flattens them; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path key: leaf}, keys in JAX's leaf order ("pi__0__w" for a list
    inside a dict)."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for k, v in kids:
        flat.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return flat


def _unflatten_like(like: Pytree, flat: Dict[str, Any],
                    prefix: str = "") -> Pytree:
    kids = _children(like)
    if kids is None:
        return flat[prefix]
    vals = [_unflatten_like(v, flat, f"{prefix}{_SEP}{k}" if prefix else k)
            for k, v in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    return type(like)(vals)


def _load_leaf(step_dir: pathlib.Path, key: str, manifest: Dict,
               device: "torch.device") -> torch.Tensor:
    """Load one leaf as saved, cast to the manifest's logical dtype (a
    bf16 leaf is stored as fp32), on `device`."""
    arr = np.load(step_dir / f"{key}.npy")
    dtype = _TORCH_DTYPES[manifest["leaves"][key]["dtype"]]
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def sweep_tmp(ckpt_dir: str) -> list:
    """Clean up debris of killed runs: remove orphaned ``.tmp_step_*``
    dirs, and resolve ``.old_step_*`` dirs (a checkpoint displaced by
    `commit_staged` mid-overwrite) — put back if the replacement never
    committed, deleted if it did.  One trainer owns a ckpt_dir (single
    writer): a tmp dir is live only inside this process's own save."""
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


def gc_checkpoints(ckpt_dir: str, keep_last: int,
                   on_remove: Optional[Callable[[str], None]] = None,
                   floor: Optional[int] = None) -> list:
    """Delete all but the newest `keep_last` complete checkpoints.

    `on_remove(path)` fires after each directory is deleted (the async
    writer's mid-GC failure point rides on it).  `floor` is the fleet's
    rewind floor: the newest checkpoint at or below it is the step a
    multi-host recovery would restore, so retention exempts it (at most
    keep_last + 1 dirs survive)."""
    base = pathlib.Path(ckpt_dir)
    if keep_last <= 0 or not base.exists():
        return []
    steps = _complete_steps(base)
    protected = None
    if floor is not None:
        eligible = [s for s, _ in steps if s <= floor]
        protected = max(eligible) if eligible else None
    removed = []
    for s, p in steps[:-keep_last]:
        if protected is not None and s == protected:
            continue
        shutil.rmtree(p)
        removed.append(str(p))
        if on_remove is not None:
            on_remove(str(p))
    return removed


# ---------------------------------------------------------------------------
# The write stages (shared by the blocking and async savers)
# ---------------------------------------------------------------------------
def mesh_rank(tree: Pytree) -> Optional[int]:
    """This rank in the default process group when `tree` holds a DTensor
    leaf (every rank of the mesh saves it, rank 0 writes), else None."""
    if not any(SH.is_dtensor(t) for t in _flatten(tree).values()):
        return None
    import torch.distributed as dist
    return dist.get_rank()


def mesh_barrier() -> None:
    """Every rank of the default group waits here for the others (after
    a mesh save: until rank 0 has committed)."""
    import torch.distributed as dist
    dist.barrier()


def iter_snapshot(tree: Pytree) -> Iterator[Tuple[str, np.ndarray, str]]:
    """Yield (key, host numpy leaf as stored, logical dtype) one leaf at a
    time.  Each leaf is copied to the host on the calling thread (a copy
    even of a CPU tensor), so a yielded leaf never sees a later in-place
    update of the tensor it came from.  A DTensor leaf is made whole on
    every rank first (a collective: every rank runs this over the same
    tree); only rank 0 yields, the other ranks drop each whole leaf at
    once and yield nothing."""
    keep = mesh_rank(tree) in (None, 0)
    for key, t in _flatten(tree).items():
        t = SH.whole(t)
        if not keep:
            continue
        name = _NP_NAMES[t.dtype]
        stored = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        yield key, t.detach().to("cpu", stored, copy=True).numpy(), name


def host_snapshot(step: int, tree: Pytree, metadata: Optional[Dict] = None
                  ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Stage the WHOLE tree to the host: ({key: numpy leaf}, manifest).
    This holds a full host copy at once, the price of handing the write to
    a background thread; the blocking saver streams instead."""
    flat_host: Dict[str, np.ndarray] = {}
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, arr, dtype in iter_snapshot(tree):
        flat_host[key] = arr
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
    return flat_host, manifest


def _fsync_path(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_staged(tmp: pathlib.Path, flat_host: Dict[str, np.ndarray],
                 manifest: Dict, *, fsync: bool = False) -> None:
    """Serialize a host snapshot into an (already created) tmp dir."""
    for key, arr in flat_host.items():
        np.save(tmp / f"{key}.npy", arr)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if fsync:
        fsync_staged(tmp)


def fsync_staged(tmp: pathlib.Path) -> None:
    """Flush every staged file and the dir itself (durability before the
    rename makes the checkpoint visible)."""
    for p in tmp.iterdir():
        _fsync_path(p)
    _fsync_path(tmp)


def stage_dirs(ckpt_dir: str, step: int
               ) -> Tuple[pathlib.Path, pathlib.Path]:
    """Open the staging area for one save (both savers' prologue): sweep
    debris, create the tmp dir, return (tmp, final)."""
    base = pathlib.Path(ckpt_dir)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    base.mkdir(parents=True, exist_ok=True)
    sweep_tmp(ckpt_dir)
    tmp.mkdir(parents=True)
    return tmp, final


def commit_staged(tmp: pathlib.Path, final: pathlib.Path,
                  *, fsync: bool = False,
                  failpoint: Optional[Callable[[str], None]] = None) -> None:
    """The commit point: rename tmp -> final.  Before the rename the
    checkpoint is invisible (latest_step and restore ignore tmp dirs);
    after it the checkpoint is complete.

    An existing step is never deleted before the new copy lands: it is
    first displaced to ``.old_<name>`` by rename, and `sweep_tmp` repairs
    a kill between the two renames.  `failpoint("mid_replace")` injects
    exactly there."""
    old = None
    if final.exists():
        old = final.parent / f".old_{final.name}"
        if old.exists():
            shutil.rmtree(old)
        os.rename(final, old)
        if failpoint is not None:
            failpoint("mid_replace")
    os.rename(tmp, final)
    if fsync:
        _fsync_path(final.parent)
    if old is not None:
        shutil.rmtree(old)


def save_checkpoint(ckpt_dir: str, step: int, tree: Pytree,
                    metadata: Optional[Dict] = None, keep_last: int = 0,
                    floor: Optional[int] = None) -> str:
    """Write `tree` as step `step`, one leaf at a time (peak host memory
    about one leaf).  Every save sweeps tmp dirs left by killed runs.
    keep_last > 0 enables retention: after the save only the newest
    `keep_last` checkpoints survive, plus the newest step at or below
    `floor`, the fleet's rewind floor (`gc_checkpoints`).  A mesh's tree
    (DTensor leaves) is saved by every rank: rank 0 writes, commits and
    collects, and no rank returns before rank 0 has committed."""
    rank = mesh_rank(tree)
    try:
        if rank:                     # the others gather with rank 0
            for _ in iter_snapshot(tree):
                pass
            return str(pathlib.Path(ckpt_dir) / f"step_{step:08d}")
        tmp, final = stage_dirs(ckpt_dir, step)
        manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
        for key, arr, dtype in iter_snapshot(tree):  # stream, leaf by leaf
            np.save(tmp / f"{key}.npy", arr)
            manifest["leaves"][key] = {"shape": list(arr.shape),
                                       "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        commit_staged(tmp, final)
        if keep_last:
            gc_checkpoints(ckpt_dir, keep_last, floor=floor)
        return str(final)
    finally:
        if rank is not None:
            mesh_barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = _complete_steps(base)
    return steps[-1][0] if steps else None


def restore_checkpoint(ckpt_dir: str, like: Pytree,
                       step: Optional[int] = None) -> Tuple[Pytree, Dict]:
    """Load checkpoint `step` (default the newest) into the structure of
    `like`, a tree of tensors whose shapes must match; each leaf comes
    back with its `like` leaf's dtype and device, and a DTensor leaf as
    this rank's shard of it, laid out as its `like` leaf (no collective;
    one whole leaf on the host at a time).  Returns (tree, metadata)."""
    if step is None:
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
        if SH.is_dtensor(want):
            arr = np.ascontiguousarray(SH.own_part(arr, want))
        out[key] = SH.from_local_like(
            torch.from_numpy(arr).to(device=want.device, dtype=want.dtype),
            want)
    return _unflatten_like(like, out), manifest["metadata"]
