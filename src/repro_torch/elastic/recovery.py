"""Serving recovery: drain and re-admit.

The port's copy of ``ServingDrainReadmit`` from the JAX package's
``elastic/recovery.py``.  A serving engine's state is its caches plus
the per-slot request lifecycle.  Recovery keeps the tokens the host had
already harvested (and streamed to clients) and requeues each in-flight
request as a *prefix continuation* (prompt = original prompt + emitted
tokens, budget = remaining budget).  A paged engine's drain also carries
the harvested KV (`serving.engine.MigratedKV`), which the receiving
engine installs instead of re-prefilling the prefix.  Greedy decoding is
slot-local and deterministic, so stitching the preserved prefix back on
reconstructs the uninterrupted output.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from repro_torch.serving.request import FinishedRequest, Request


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

    def readmit(self, drained: Sequence[Any]) -> List[Request]:
        """drained: `ServeEngine.drain()` output (DrainedRequest records).
        Returns continuation requests in rid (= submission) order."""
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

    def stitch(self, fin: FinishedRequest) -> FinishedRequest:
        """Merge a finished (possibly continuation) request with its
        preserved prefix; untouched requests pass through unchanged."""
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
