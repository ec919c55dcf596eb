"""Per-mode recovery policies: what happens to training state when the
membership changes.

The port of the JAX package's ``elastic/recovery.py``.  The right
recovery depends on how the data-parallel mode distributes state
(`core.data_parallel`):

* **Sync all-reduce** (`SyncCheckpointRestore`): params and optimizer
  state are replicated, but a mid-step death kills the collective, and
  there is no per-worker replica to fall back on.  Recovery restores the
  last checkpoint, rewinds the step counter and re-plans the batch split
  over the survivors; the cost is the lost steps, bounded by the
  checkpoint cadence.

* **Local SGD / parameter server** (`BoundedStalenessContinuation`):
  every worker owns a full (params, optimizer) replica stacked on the
  leading W axis.  A death drops that row; the survivors' replicas are
  each a valid model and the next averaging round re-synchronises them,
  so training continues with no rewind.  A joiner starts at the survivor
  mean, the consensus point.

* **EASGD** (`EASGDCenterSurvival`): the center variable *is* the model
  and lives outside any worker, so a death loses one elastic replica
  only.  A joiner clones the center (zero elastic force at birth).

* **Serving** (`ServingDrainReadmit`): a serving engine's state is its
  caches plus the per-slot request lifecycle.  Recovery keeps the tokens
  the host had already harvested (and streamed to clients) and requeues
  each in-flight request as a *prefix continuation* (prompt = original
  prompt + emitted tokens, budget = remaining budget).  A paged engine's
  drain also carries the harvested KV (`serving.engine.MigratedKV`),
  which the receiving engine installs instead of re-prefilling the
  prefix.  Greedy decoding is slot-local and deterministic, so stitching
  the preserved prefix back on reconstructs the uninterrupted output.

The port's train step updates params and moments in place
(`launch.steps.apply_grads`), so `SyncCheckpointRestore.recover` hands
back tensors read fresh from the checkpoint's files: they alias neither
a saver's host snapshot nor the live (torn) state passed in as the
template.  An asynchronous save holds its host snapshot before `save`
returns, so the step after it may overwrite the live tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, AsyncCheckpointError,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.elastic.reshard import reshard_stacked
from repro_torch.models.common import tree_map

# repro_torch.serving types are imported inside ServingDrainReadmit:
# serving.fleet imports this module, so a top-level import would cycle

Pytree = Any


@dataclasses.dataclass
class SyncCheckpointRestore:
    """Checkpoint/restore recovery for the synchronous all-reduce mode.

    async_save=True puts saves on an `AsyncCheckpointer` writer thread:
    `checkpoint` then costs the caller only the device->host snapshot.
    `recover` first waits out any in-flight save, so the rewind target is
    always the last *committed* step, never a half-written one; if the
    in-flight save failed (its error lands in `writer_errors`), recovery
    falls back to the previous committed checkpoint.

    coordinator (a `cluster.Coordinator`) makes recovery multi-host
    consistent: every save/recover reports this host's last committed
    step, and the rewind target becomes the coordinator's fleet-wide
    MINIMUM over surviving hosts.  With a single reporting host this is
    exactly the local behaviour.  Under a mesh's ranks the committed
    step reported is rank 0's on every rank (`Transport.on_rank0`):
    rank 0 alone writes a mesh's saves, so only its writer knows what
    has committed, and every rank must rewind to the same step."""
    ckpt_dir: str
    keep_last: int = 3
    async_save: bool = False
    coordinator: Optional[Any] = None
    host: int = 0
    saved_step: int = -1

    def __post_init__(self):
        self._ckpt = (AsyncCheckpointer(self.ckpt_dir,
                                        keep_last=self.keep_last,
                                        floor_fn=self._gc_floor)
                      if self.async_save else None)
        self.writer_errors: list = []

    def _gc_floor(self) -> Optional[int]:
        """Retention floor for this host's GC: the fleet minimum over the
        OTHER hosts' committed steps, so keep_last never collects the
        checkpoint a fleet-wide rewind would land on.  Excluding self
        keeps the single-reporting-host case floor-free."""
        if self.coordinator is None:
            return None
        return self.coordinator.rewind_step(exclude=self.host)

    def checkpoint(self, step: int, params: Pytree, opt_state: Pytree,
                   metadata: Optional[Dict] = None) -> str:
        meta = dict(metadata or {})
        meta["step"] = step
        tree = {"params": params, "opt": opt_state}
        if self._ckpt is not None:
            path = self._ckpt.save(step, tree, meta)
        else:
            path = save_checkpoint(self.ckpt_dir, step, tree, meta,
                                   keep_last=self.keep_last,
                                   floor=self._gc_floor())
        self.saved_step = step
        self._report_commit()
        return path

    def _report_commit(self) -> None:
        """Tell the coordinator what this host has durably committed
        (async: only what the writer has renamed in; blocking: the save
        just made)."""
        if self.coordinator is None:
            return
        committed = self.coordinator.transport.on_rank0(
            lambda: (self._ckpt.last_committed_step()
                     if self._ckpt is not None else self.saved_step))
        self.coordinator.report_commit(self.host, committed)

    def recover(self, params: Pytree, opt_state: Pytree
                ) -> Tuple[Pytree, Pytree, int]:
        """Restore the latest committed checkpoint; the live (possibly
        torn) state is only the template of shapes, dtypes and devices.
        Returns (params, opt, step), new tensors read from the files."""
        step = None
        if self._ckpt is not None:
            try:
                self._ckpt.wait()      # never restore an in-flight save
            except AsyncCheckpointError as e:
                self.writer_errors.append(e)
            step = self._ckpt.last_committed_step()
        if self.coordinator is not None:
            # multi-host consistency: refresh our own floor, then rewind
            # to the fleet-wide minimum committed step
            self._report_commit()
            step = self.coordinator.rewind_step()
        tree, meta = restore_checkpoint(
            self.ckpt_dir, {"params": params, "opt": opt_state}, step=step)
        return tree["params"], tree["opt"], int(meta["step"])

    def wait(self) -> None:
        """Barrier: all handed-over saves durable (no-op when blocking).
        Raises `AsyncCheckpointError` if a background save failed."""
        if self._ckpt is not None:
            self._ckpt.wait()

    def close(self) -> None:
        """Shut the writer down; unlike `wait`, never raises: late writer
        failures land in `writer_errors` (close sits on error paths where
        a deferred I/O error must not mask the real one)."""
        if self._ckpt is not None:
            try:
                self._ckpt.close()
            except AsyncCheckpointError as e:
                self.writer_errors.append(e)


@dataclasses.dataclass
class BoundedStalenessContinuation:
    """Survivor continuation for local-SGD / parameter-server replicas.

    join_init: how a joiner's row is built ("mean" of survivors is the
    consensus point; "donor" clones the lowest-id survivor)."""
    join_init: str = "mean"

    def apply(self, stacked: Dict[str, Pytree], old_ids: Sequence[int],
              new_ids: Sequence[int]) -> Dict[str, Pytree]:
        """stacked: dict of (W, ...)-stacked trees (e.g. params_w, opt_w),
        all resharded with the same row mapping."""
        return {k: reshard_stacked(v, old_ids, new_ids, init=self.join_init)
                for k, v in stacked.items()}


@dataclasses.dataclass
class EASGDCenterSurvival:
    """EASGD recovery: the center survives; replicas churn around it."""

    def apply(self, params_w: Pytree, center: Pytree,
              old_ids: Sequence[int], new_ids: Sequence[int]
              ) -> Tuple[Pytree, Pytree]:
        old_index = {wid: i for i, wid in enumerate(old_ids)}
        survivors = [w for w in new_ids if w in old_index]
        if not survivors and not new_ids:
            raise ValueError("empty membership")

        def remap(p_w, c):
            rows = [p_w[old_index[w]] if w in old_index else c
                    for w in new_ids]
            return torch.stack(rows, dim=0)

        return tree_map(remap, params_w, center), center


@dataclasses.dataclass
class ServingDrainReadmit:
    """Drained in-flight requests become prefix continuations; finished
    continuations are stitched back together.

    The policy owns the per-request delivery ledger: `emitted[rid]` is
    every token the client has already received across all of the
    request's incarnations (a request can be drained more than once).
    `readmit` turns an engine's drain output into continuation Requests
    sorted by rid (submission order); `stitch` rebuilds the client-visible
    FinishedRequest from the preserved prefix + the continuation's tail."""
    emitted: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    originals: Dict[int, Any] = dataclasses.field(default_factory=dict)
    readmitted: int = 0

    def readmit(self, drained: Sequence[Any]) -> List[Any]:
        """drained: `ServeEngine.drain()` output (DrainedRequest records).
        Returns continuation requests in rid (= submission) order."""
        from repro_torch.serving.request import Request

        out = []
        for d in sorted(drained, key=lambda d: d.request.rid):
            req = d.request
            rid = req.rid
            if rid not in self.originals:
                self.originals[rid] = req
                self.emitted[rid] = []
            orig = self.originals[rid]
            self.emitted[rid].extend(d.emitted)
            prefix = self.emitted[rid]
            remaining = orig.max_new_tokens - len(prefix)
            if remaining <= 0:
                raise ValueError(f"rid {rid} drained after completion")
            # the harvested KV rides with the continuation; a queued
            # continuation drains with its seed still attached: keep it
            kv = d.kv if d.kv is not None else req.kv_seed
            if prefix:
                prompt = np.concatenate([
                    np.asarray(orig.prompt, np.int32),
                    np.asarray(prefix, np.int32)])
                cont = Request(rid=rid, prompt=prompt,
                               max_new_tokens=remaining, eos_id=orig.eos_id,
                               extra_embeds=orig.extra_embeds, kv_seed=kv)
            else:
                cont = orig  # nothing delivered yet: re-admit verbatim
            self.readmitted += 1
            out.append(cont)
        return out

    def stitch(self, fin: Any) -> Any:
        """Merge a finished (possibly continuation) request with its
        preserved prefix; untouched requests pass through unchanged."""
        from repro_torch.serving.request import FinishedRequest

        if fin.rid not in self.originals:
            return fin
        orig = self.originals.pop(fin.rid)
        prefix = self.emitted.pop(fin.rid)
        return FinishedRequest(
            rid=fin.rid,
            prompt_len=len(np.asarray(orig.prompt)),
            tokens=prefix + fin.tokens,
            finish_reason=fin.finish_reason,
            admitted_tick=fin.admitted_tick,
            finished_tick=fin.finished_tick)
