"""Resharding engine: remap training state from W to W' workers.

The PyTorch counterpart of the JAX package's ``elastic/reshard.py``.
Per-worker state carries an explicit leading worker axis
(`core/data_parallel.py`: params_w, opt_states_w, EASGD replicas are all
(W, ...) stacked trees), so resharding is row surgery on axis 0:

  * survivors keep their row **bit-exactly** (pure gather, no arithmetic);
  * joiners get a row from an init policy: "mean" of the survivors (the
    fp32 mean cast back to the leaf's dtype: the newcomer starts at the
    consensus point), "donor" (clone of a named survivor), or a callable
    for fresh state (e.g. zero optimizer moments).

Checkpoints interoperate across worker counts and across the two
packages: `save_stacked` records the worker-id -> row mapping in the
manifest metadata (the files are byte-identical to the JAX package's),
and `restore_stacked` rebuilds the stacked tree for whatever membership
exists at restore time, carrying shared ids bit-exactly and initialising
the rest.  Replicated (sync all-reduce) state needs no row surgery —
resharding there is just re-planning the data split, which
`assign_shards`/`plan_split` cover.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.checkpoint.ckpt import (_flatten, _load_leaf,
                                         _unflatten_like, latest_step,
                                         save_checkpoint)
from repro_torch.core import sharding as SH
from repro_torch.core.data_parallel import dbs_partition, worker_mean
from repro_torch.models.common import tree_map

Pytree = Any
InitPolicy = Union[str, Callable[[Any], Any]]  # "mean" | "donor" | fn(leaf)


def _rows(leaf_w: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
    """Rows `idx` of the worker axis; a DTensor's (the worker axis never
    split) gathered from its local shard, laid out as it is."""
    local = SH.local(leaf_w)
    rows = local[torch.as_tensor(list(idx), dtype=torch.long,
                                 device=local.device)]
    return SH.from_local_like(rows, leaf_w)


def take_rows(tree_w: Pytree, idx: Sequence[int]) -> Pytree:
    """Gather rows of every leaf along the worker axis (bit-exact)."""
    return tree_map(lambda l: _rows(l, idx), tree_w)


def _init_row(leaf_w, survivors_rows, policy: InitPolicy, donor_pos: int):
    if callable(policy):
        return policy(leaf_w[0])
    if policy == "donor":
        return survivors_rows[donor_pos]
    if policy == "mean":
        return worker_mean(survivors_rows).to(leaf_w.dtype)
    raise ValueError(f"unknown init policy {policy!r}")


def reshard_stacked(tree_w: Pytree, old_ids: Sequence[int],
                    new_ids: Sequence[int], *, init: InitPolicy = "mean",
                    donor: Optional[int] = None) -> Pytree:
    """Remap a (W, ...)-stacked tree from membership old_ids to new_ids.

    Rows for ids present in both memberships are gathered bit-exactly; ids
    only in `new_ids` (joiners) are built by the init policy.  Requires at
    least one survivor — a full-cluster loss is a checkpoint restore, not
    a reshard.
    """
    old_index = {wid: i for i, wid in enumerate(old_ids)}
    if len(old_index) != len(tuple(old_ids)):
        raise ValueError("duplicate worker ids in old membership")
    survivors = [wid for wid in new_ids if wid in old_index]
    if not survivors:
        raise ValueError("no surviving workers: restore from checkpoint")
    surv_idx = [old_index[w] for w in survivors]
    donor_pos = survivors.index(donor) if donor in survivors else 0

    def remap(leaf_w):
        surv_rows = _rows(leaf_w, surv_idx)
        rows, s = [], 0
        for wid in new_ids:
            if wid in old_index:
                rows.append(surv_rows[s])
                s += 1
            else:
                rows.append(_init_row(leaf_w, surv_rows, init, donor_pos))
        return torch.stack(rows, dim=0)

    return tree_map(remap, tree_w)


# ---------------------------------------------------------------------------
# Data re-assignment + batch re-planning
# ---------------------------------------------------------------------------
def assign_shards(alive_ids: Sequence[int]) -> Dict[int, Tuple[int, int]]:
    """worker id -> (shard_id, num_shards): dense ranks over the sorted
    alive set, so a death re-spreads the data stream over survivors."""
    ids = sorted(alive_ids)
    return {wid: (rank, len(ids)) for rank, wid in enumerate(ids)}


def plan_split(global_batch: int, rates: Dict[int, float],
               multiple: int = 1) -> Dict[int, int]:
    """Throughput-proportional batch split over the alive workers (DBS,
    survey ref 71).  Returns worker id -> batch rows, summing exactly to
    `global_batch`."""
    ids = sorted(rates)
    split = dbs_partition([rates[w] for w in ids], global_batch, multiple)
    return {wid: int(n) for wid, n in zip(ids, split.tolist())}


# ---------------------------------------------------------------------------
# Elastic checkpoints (worker-count-agnostic)
# ---------------------------------------------------------------------------
def save_stacked(ckpt_dir: str, step: int, tree_w: Pytree,
                 worker_ids: Sequence[int], *, replicated: Pytree = None,
                 metadata: Optional[Dict] = None,
                 keep_last: int = 0, checkpointer=None) -> str:
    """Checkpoint worker-stacked state + optional replicated state (e.g.
    the EASGD center), recording the id->row mapping for elastic restore.

    `checkpointer` (an `AsyncCheckpointer` on `ckpt_dir`) moves the write
    off-thread: the call returns after the host snapshot and the save
    commits in the background (the checkpointer's own `keep_last` governs
    retention).  Either way the on-disk layout is identical, so
    `restore_stacked` needs no changes."""
    meta = dict(metadata or {})
    meta["worker_ids"] = [int(w) for w in worker_ids]
    tree = {"stacked": tree_w}
    if replicated is not None:
        tree["replicated"] = replicated
    if checkpointer is not None:
        return checkpointer.save(step, tree, meta)
    return save_checkpoint(ckpt_dir, step, tree, meta, keep_last=keep_last)


def restore_stacked(ckpt_dir: str, abstract_row: Pytree,
                    new_ids: Sequence[int], *,
                    step: Optional[int] = None, init: InitPolicy = "mean",
                    abstract_replicated: Pytree = None
                    ) -> Tuple[Pytree, Pytree, Dict]:
    """Restore a `save_stacked` checkpoint onto a possibly different
    membership.  `abstract_row` describes ONE worker's row: a tree of
    tensors, their shapes and the device each leaf is restored onto (the
    dtype is the manifest's).  The
    checkpointed W is read from the manifest, rows for surviving ids are
    carried bit-exactly, and joiners use the init policy.

    Returns (stacked_tree for new_ids, replicated_tree or None, metadata).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    old_ids = manifest["metadata"]["worker_ids"]

    out = {}
    for key, want in _flatten({"stacked": abstract_row}).items():
        leaf = _load_leaf(d, key, manifest, want.device)
        if tuple(leaf.shape[1:]) != tuple(want.shape):
            raise ValueError(f"{key}: row shape {tuple(leaf.shape[1:])} != "
                             f"expected {tuple(want.shape)}")
        out[key] = leaf
    stacked = _unflatten_like({"stacked": abstract_row}, out)["stacked"]
    stacked = reshard_stacked(stacked, old_ids, new_ids, init=init)

    replicated = None
    if abstract_replicated is not None:
        abs_rep = {"replicated": abstract_replicated}
        rep_out = {key: _load_leaf(d, key, manifest, want.device)
                   for key, want in _flatten(abs_rep).items()}
        replicated = _unflatten_like(abs_rep, rep_out)["replicated"]
    return stacked, replicated, manifest["metadata"]
