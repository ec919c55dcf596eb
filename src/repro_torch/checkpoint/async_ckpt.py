"""Asynchronous checkpointing: non-blocking saves on a background writer.

The port of the JAX package's ``checkpoint/async_ckpt.py``, with the same
writer thread, double buffer, failure points and obs spans and counters.
A blocking `save_checkpoint` makes the train loop wait for the device to
host copy AND serialization AND file I/O.  The `AsyncCheckpointer` splits
the save at the host-snapshot boundary (`ckpt.host_snapshot`): the caller
pays only the copy of every leaf to the host — which also makes the
snapshot immune to any later in-place update of the tensors — and a
dedicated writer thread serializes, writes, fsyncs, renames and GCs off
the critical path.

Commit protocol (the blocking saver's, through the same `write_staged` /
`commit_staged` stages, so the files are the same bytes and restore needs
no change):

  1. sweep orphaned ``.tmp_step_*`` dirs (debris of killed runs)
  2. create ``.tmp_step_<N>/``; np.save every leaf + manifest.json
  3. fsync each file and the tmp dir (durability before visibility)
  4. atomic rename ``.tmp_step_<N>`` -> ``step_<N>``  <- THE commit point
  5. fsync the parent dir; record N as the last committed step
  6. retention GC (`keep_last`)

A crash before (4) leaves only an orphaned tmp dir that `latest_step` and
`restore_checkpoint` never see and the next save sweeps; a crash at or
after (4) leaves a complete checkpoint.  Overwriting an existing step
never deletes it first: `commit_staged` displaces the old dir to
``.old_step_<N>`` by rename, and the next save's sweep renames it back if
a kill fell between the two renames.

Thread-safety contract:

  * Single producer: `save`/`wait`/`close` are called from one thread
    (the train loop).  `last_committed_step` is safe from any thread.
  * Double-buffered, at most ONE save in flight: `save` snapshots the new
    state to the host while the writer may still be flushing the previous
    one, then blocks only if the writer is not done yet.
  * Writer failures never kill the train loop mid-step: they are queued
    and re-raised (wrapped in `AsyncCheckpointError`) at the next `save`,
    `wait`, or `close`.
  * `wait()` is the barrier: after it returns, every save handed over so
    far is durably committed and `last_committed_step()` reflects it.

A mesh's tree (DTensor leaves) is saved by every rank: the snapshot and
its collectives run on each rank's caller thread, only rank 0 starts the
writer and hands it the job, and `wait()` is a barrier of every rank
after rank 0's commit.

Failure injection: pass ``failpoint=fn``; the writer calls ``fn(name)``
at each point in `FAILPOINTS` and treats any exception it raises as the
process dying right there — the job is abandoned with the directory
exactly as a kill would leave it, and the error surfaces through the
usual queue.
"""
from __future__ import annotations

import contextlib
import pathlib
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import (commit_staged, fsync_staged,
                                         gc_checkpoints, host_snapshot,
                                         latest_step, mesh_barrier,
                                         mesh_rank, stage_dirs,
                                         write_staged)
from repro_torch.obs import recorder as obs

Pytree = Any

# The writer's failure-injection points, in execution order.  Every entry
# has a crash-consistency test showing that a kill there still restores
# the newest COMMITTED checkpoint (tests/test_torch_async_ckpt.py).
FAILPOINTS = (
    "before_write",               # tmp dir created, nothing serialized yet
    "before_fsync",               # leaves + manifest written, none durable
    "after_fsync_before_rename",  # durable but invisible: still tmp
    "mid_replace",                # overwrite only: old step displaced to
                                  # .old_*, new one not yet renamed in
    "after_commit_before_gc",     # committed; retention not yet enforced
    "mid_gc",                     # committed; GC died between removals
)


class AsyncCheckpointError(RuntimeError):
    """A background save failed; raised on the caller at the next
    save/wait/close.  The failed step was NOT committed."""


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, *, keep_last: int = 0,
                 fsync: bool = True,
                 failpoint: Optional[Callable[[str], None]] = None,
                 floor_fn: Optional[Callable[[], Optional[int]]] = None):
        """floor_fn: called on the CALLER's thread at `save` time (so GC
        outcomes do not depend on the writer thread's timing) for the
        fleet's rewind floor; retention then exempts the newest
        checkpoint at or below it (`ckpt.gc_checkpoints`)."""
        self.ckpt_dir = str(ckpt_dir)
        self.keep_last = keep_last
        self.fsync = fsync
        self._failpoint = failpoint
        self._floor_fn = floor_fn
        self._cv = threading.Condition()
        self._job: Optional[tuple] = None  # (step, flat_host, manifest, floor)
        self._errors: list = []
        self._closed = False
        self._mesh = False       # a mesh's tree was saved: wait() barriers
        # a restarted process resumes from whatever the dead one committed
        self._committed: Optional[int] = latest_step(self.ckpt_dir)
        # started by the first save this rank writes
        self._thread: Optional[threading.Thread] = None

    # -- caller side ---------------------------------------------------
    def save(self, step: int, tree: Pytree,
             metadata: Optional[Dict] = None) -> str:
        """Hand a save to the writer; returns the (future) final path.

        Blocking work on the caller: the host snapshot, plus waiting out
        the previous save iff it is still in flight.  Raises any deferred
        writer error — but only AFTER enqueuing this step, so a caller
        that catches and keeps training loses nothing: the error always
        describes an earlier step, never this one."""
        if self._closed:
            raise RuntimeError("checkpointer is closed")
        # double buffer: stage to the host while the writer drains the
        # previous job, then block only on a still-busy writer
        rank = mesh_rank(tree)
        self._mesh = self._mesh or rank is not None
        rec = obs.get()
        with rec.span("ckpt.snapshot", cat="ckpt", step=step):
            flat_host, manifest = host_snapshot(step, tree, metadata)
        rec.count("ckpt.saves")
        if rank:                 # rank 0 writes a mesh's save
            return str(pathlib.Path(self.ckpt_dir) / f"step_{step:08d}")
        floor = self._floor_fn() if self._floor_fn is not None else None
        if self._thread is None:
            self._thread = threading.Thread(target=self._writer_loop,
                                            name="async-ckpt-writer",
                                            daemon=True)
            self._thread.start()
        with self._cv:
            while self._job is not None:
                self._cv.wait()
            self._job = (step, flat_host, manifest, floor)
            self._cv.notify_all()
            self._raise_deferred_locked()
        return str(pathlib.Path(self.ckpt_dir) / f"step_{step:08d}")

    def wait(self) -> None:
        """Barrier: block until no save is in flight, then surface any
        writer failure.  On clean return, `last_committed_step()` covers
        every save handed over so far.  After a mesh's save every rank
        leaves only once rank 0's writer has committed."""
        try:
            with self._cv:
                while self._job is not None:
                    self._cv.wait()
                self._raise_deferred_locked()
        finally:
            if self._mesh:
                mesh_barrier()

    def last_committed_step(self) -> Optional[int]:
        """Newest step whose rename hit the disk (None before any)."""
        with self._cv:
            return self._committed

    def close(self, *, wait: bool = True) -> None:
        """Stop the writer.  wait=True drains + raises deferred errors
        first; wait=False abandons any queued (not yet started) job."""
        if self._closed:
            return
        try:
            if wait:
                self.wait()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=60)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        # on an exception unwind, don't mask it with a deferred write error
        self.close(wait=exc[0] is None)

    def _raise_deferred_locked(self) -> None:
        if self._errors:
            err = self._errors.pop(0)
            raise AsyncCheckpointError(
                f"background checkpoint save failed: {err!r}") from err

    # -- writer side ---------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self._job is None and not self._closed:
                    self._cv.wait()
                if self._closed:  # close(wait=False) abandons queued work
                    return
                job = self._job
            try:
                self._write(*job)
            except Exception as e:  # surfaced at the next save/wait/close
                with self._cv:
                    self._errors.append(e)
            finally:
                with self._cv:
                    self._job = None
                    self._cv.notify_all()

    def _fail(self, name: str) -> None:
        if self._failpoint is not None:
            self._failpoint(name)

    def _write(self, step: int, flat_host: Dict[str, np.ndarray],
               manifest: Dict, floor: Optional[int] = None) -> None:
        rec = obs.get()
        # Writer-thread stages get timeline spans only under the real
        # wall clock: with a simulated clock the writer would race the
        # loop thread for the current tick, and the recorded timeline
        # would depend on thread scheduling.  The stages still count into
        # the registry, which does not.
        timeline = rec.enabled and rec.clock is time.monotonic

        def stage(name: str):
            if timeline:
                return rec.span("ckpt." + name, host="ckpt", cat="ckpt",
                                step=step)
            return contextlib.nullcontext()

        tmp, final = stage_dirs(self.ckpt_dir, step)
        self._fail("before_write")
        with stage("write"):
            write_staged(tmp, flat_host, manifest, fsync=False)
        self._fail("before_fsync")
        if self.fsync:
            with stage("fsync"):
                fsync_staged(tmp)
        self._fail("after_fsync_before_rename")
        with stage("commit"):
            commit_staged(tmp, final, fsync=self.fsync,
                          failpoint=self._fail)
        with self._cv:  # committed even if GC below dies
            self._committed = step
        rec.count("ckpt.commits")
        self._fail("after_commit_before_gc")
        if self.keep_last:
            with stage("gc"):
                gc_checkpoints(self.ckpt_dir, self.keep_last,
                               on_remove=lambda _p: self._fail("mid_gc"),
                               floor=floor)
