"""ServeEngine: continuous batching over a fixed pool of cache slots.

The PyTorch counterpart of the JAX package's ``serving/engine.py``.  Each
engine step does one of two things:

  1. **Admit**: if the FIFO queue is non-empty and a slot is free, prefill
     that one request (batch 1, its true prompt length) and write its
     cache into the free slot (dense) or onto freshly allocated pages
     (paged).  The first sampled token stays on the device and is
     harvested with the next chunk.
  2. **Decode a chunk**: run k batched decode ticks over the whole pool.
     The slot lifecycle — per-slot position, active mask, token count,
     EOS/budget retirement — advances in device tensors, and the host
     reads the (k, B) token and active blocks once per chunk (one host
     sync), then evicts finished slots and backfills from the queue.

**Paged mode** (`page_size=`): KV leaves are a shared pool of fixed-size
pages; each slot owns a block table and grows page by page as it
decodes.  When the pool runs dry mid-decode the engine preempts the most
recently admitted slot (youngest first), requeueing it at the head of the
queue as a prefix continuation, so the oldest work always completes.

Paged mode also migrates KV on drain: `drain()` harvests each live slot's
pages (and per-slot rows) to the host as a `MigratedKV`, and a paged
engine that admits a continuation carrying one installs them instead of
re-prefilling the prefix (`elastic.recovery.ServingDrainReadmit` builds
such continuations).

Every family serves: a vlm request's `extra_embeds` patches are prefilled
ahead of its prompt (they take the first `num_patches` positions of its
cache), an audio request's frames are encoded at admit and the encoder
K/V ride in per-slot rows, and the ssm family's recurrent state is a
per-slot row (dense mode only: it has no KV to page).  A sliding-window
config is refused: its cache is a ring of `window` slots, which neither
the prefill's cache layout nor the page pool takes.

Under an installed `repro_torch.obs` recorder the engine emits the JAX
engine's events on its `host` lane, with their names, categories and
args: `serve.admit` / `serve.admit_migrated` at each admit, a `request`
span from admit to finish, `serve.first_token`, `serve.preempt`,
`serve.drain`, and the `serving.slot_occupancy` / `serving.pool_occupancy`
gauges in `stats()`.  With the default null recorder they cost a method
call and allocate nothing.

Engines of one (cfg, cache_len, page_size) may share one `ServeProgram`
(`program=`): the step half carries no request state, so a serving
fleet's replicas, present and future, run one program.  `chunk_cap=`
bounds the decode ticks between host syncs (default `CHUNK_CAP`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.launch.steps import (make_paged_serve_cb_step,
                                      make_serve_cb_step, sharded_argmax)
from repro_torch.models import model as MD
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.obs import recorder as obs
from repro_torch.serving.request import (FinishedRequest, Request,
                                         validate_budget)
from repro_torch.serving.scheduler import FifoScheduler, PagePool, SlotPool

CHUNK_CAP = 8  # max decode ticks between host syncs (EOS eviction latency)


@dataclasses.dataclass
class MigratedKV:
    """Host-side harvest of one slot's live KV, taken at a chunk boundary.

    `pos` positions are resident (0 .. pos-1); the last emitted token
    (`last_token`, position pos) has no cache entry yet, the sequential-
    decode invariant, so installing this state and ticking once computes
    what the source engine's next tick would have.  `pages` maps each
    paged cache leaf to a (stack, n_pages, P, Hk, dh) CPU tensor in the
    cache's dtype; `rows` carries the per-slot leaves (the audio cross-KV,
    the hybrid's SSM state and nested conv ring) as (stack, ...) CPU
    tensors."""
    pos: int
    last_token: int
    page_size: int
    pages: Dict[str, torch.Tensor]
    rows: Dict[str, Any]


@dataclasses.dataclass
class DrainedRequest:
    """Resumable state of one in-flight request pulled off an engine.

    `emitted` is what the host had harvested (and streamed) before the
    drain; a pending prefill token dies with the engine and is recomputed
    by the continuation.  `kv` (paged engines only) is the harvested
    cache: a continuation that carries it re-admits with zero prefill."""
    request: Request
    emitted: List[int]
    kv: Optional[MigratedKV] = None


class ServeProgram:
    """The step half of the engine: admit and chunk-decode callables for
    one (cfg, cache_len, page_size).  Engines hold the host-side slot
    state.  Both callables write the KV cache IN PLACE, where the JAX
    program donates the cache buffer, and leave the new lifecycle
    registers in the `regs` dict they are given."""

    def __init__(self, cfg: ModelConfig, *, cache_len: int,
                 page_size: Optional[int] = None):
        self.cfg = cfg
        self.cache_len = cache_len
        self.page_size = page_size
        self._serve_cb = (make_paged_serve_cb_step(cfg, cache_len)
                          if page_size else make_serve_cb_step(cfg))

    def admit(self, params, prompt, extra, cache,
              regs: Dict[str, torch.Tensor], slot: int, start_pos: int,
              max_new: int, eos_id: int,
              page_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill one request (with its modality input `extra`, or None)
        and install it into `slot`: its cache (dense row, or whole pages
        onto `page_ids` after a prefill to a page multiple) and every
        lifecycle register.  Returns the first sampled token, (1, 1), left
        on the device."""
        C = self.cache_len
        if page_ids is not None:
            C = page_ids.shape[0] * self.page_size
        logits, _, req_cache = MD.forward(params, self.cfg, prompt,
                                          extra_embeds=extra,
                                          return_cache=True, cache_len=C)
        first = sharded_argmax(logits[:, -1])  # (1,)
        if page_ids is not None:
            MD.write_paged_cache(cache, req_cache, slot, page_ids, self.cfg)
        else:
            MD.write_cache_slot(cache, req_cache, slot)
        regs["tokens"][slot] = first
        regs["pos"][slot] = start_pos
        # max_new_tokens == 1 is satisfied by the prefill token alone
        regs["active"][slot] = max_new > 1
        regs["gen"][slot] = 1
        regs["maxgen"][slot] = max_new
        regs["eos"][slot] = eos_id
        return first[None]

    def install(self, cache, regs: Dict[str, torch.Tensor], slot: int,
                page_ids: torch.Tensor, kv: MigratedKV, remaining: int,
                eos_id: int) -> None:
        """Migrated admit: write harvested KV pages onto `page_ids` and the
        per-slot rows into `slot`, and set the lifecycle registers, with
        no prefill.  gen starts at 0 (nothing emitted by this incarnation
        yet) and maxgen is the remaining budget, so the device retirement
        rule sees a fresh continuation."""
        for name, pages in kv.pages.items():
            leaf = cache[name]
            n = pages.shape[1]
            leaf[:, page_ids[:n]] = torch.as_tensor(pages).to(leaf.device,
                                                              leaf.dtype)
        MD.write_cache_slot(
            {n: cache[n] for n in kv.rows},
            tree_map(lambda r: torch.as_tensor(r)[:, None], kv.rows), slot)
        regs["tokens"][slot] = kv.last_token
        regs["pos"][slot] = kv.pos
        regs["active"][slot] = True
        regs["gen"][slot] = 0
        regs["maxgen"][slot] = remaining
        regs["eos"][slot] = eos_id

    def chunk(self, params, cache, regs: Dict[str, torch.Tensor], k: int,
              block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
        """k pool-decode ticks; the lifecycle registers advance on the
        device.  Returns the (2, k, B) int32 block of emitted tokens and
        per-tick active masks, still on the device."""
        tokens, pos, active = regs["tokens"], regs["pos"], regs["active"]
        gen, maxgen, eos = regs["gen"], regs["maxgen"], regs["eos"]
        toks, acts = [], []
        for _ in range(k):
            if self.page_size:
                nxt, cache = self._serve_cb(params, cache, tokens, pos,
                                            active, block_tables)
            else:
                nxt, cache = self._serve_cb(params, cache, tokens, pos,
                                            active)
            toks.append(nxt[:, 0])
            acts.append(active)
            pos = pos + active
            gen = gen + active
            fin = active & ((nxt[:, 0] == eos) | (gen >= maxgen))
            tokens, active = nxt, active & ~fin
        regs.update(tokens=tokens, pos=pos, active=active, gen=gen)
        return torch.stack([torch.stack(toks),
                            torch.stack(acts).to(torch.int32)])


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, num_slots: int,
                 cache_len: int, chunk_cap: int = CHUNK_CAP,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 program: Optional[ServeProgram] = None,
                 device: DeviceLike = None, host: Any = "serve"):
        self.host = host  # obs lane (fleet replicas pass their id)
        self.device = torch.empty(0, device=resolve_device(device)).device
        if cfg.attention_kind == "sliding_window":
            raise ValueError(
                f"{cfg.name}: the engine does not serve a sliding-window "
                f"config (its decode cache is a ring of "
                f"{cfg.sliding_window} slots; the JAX engine fails on one "
                f"too, with a broadcasting error)")
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.chunk_cap = chunk_cap
        self.page_size = page_size
        self.paged = page_size is not None
        if self.paged:
            if not MD.paged_leaf_names(cfg):
                raise ValueError(f"arch_type {cfg.arch_type} has no KV "
                                 f"cache to page")
            self.n_max = -(-cache_len // page_size)
            self.num_pages = num_pages or self.n_max * num_slots
            if self.num_pages < self.n_max:
                # one slot at max length must always fit, or a lone
                # request could deadlock the pool with nothing to preempt
                raise ValueError(
                    f"num_pages {self.num_pages} < {self.n_max} pages "
                    f"needed by a single max-length request")
        else:
            self.num_pages = 0
        self.n_prefix = MD.n_prefix(cfg)
        if program is not None and (program.cache_len != cache_len
                                    or program.page_size != page_size):
            raise ValueError(f"program (cache_len={program.cache_len}, "
                             f"page_size={program.page_size}) != engine "
                             f"(cache_len={cache_len}, page_size="
                             f"{page_size})")
        self.program = program or ServeProgram(cfg, cache_len=cache_len,
                                               page_size=page_size)
        self.reset()

    def reset(self) -> None:
        """Clear queue, pool and stats (and zero the cache)."""
        B = self.num_slots
        self.pool = SlotPool(B)
        self.scheduler = FifoScheduler(self.pool)
        self.finished: List[FinishedRequest] = []
        if self.paged:
            self.cache = MD.init_paged_cache(self.cfg, B, self.num_pages,
                                             self.page_size, self.device)
            self.pages = PagePool(self.num_pages, self.page_size)
            # host block tables; unassigned entries stay 0 (never read:
            # reads are bounded by the slot's position coverage)
            self.block_tables = np.zeros((B, self.n_max), np.int32)
        else:
            self.cache = MD.init_cache(self.cfg, B, self.cache_len,
                                       self.device)
        # device-resident slot lifecycle (the host mirrors only what
        # scheduling needs: request binding + harvested tokens)
        i32 = dict(dtype=torch.int32, device=self.device)
        self.regs: Dict[str, torch.Tensor] = {
            "tokens": torch.zeros((B, 1), **i32),
            "pos": torch.zeros((B,), **i32),
            "active": torch.zeros((B,), dtype=torch.bool, device=self.device),
            "gen": torch.zeros((B,), **i32),
            "maxgen": torch.zeros((B,), **i32),
            "eos": torch.full((B,), -1, **i32),
        }
        # first token of each admitted request: device ref, harvested later
        self._pending_first: Dict[int, torch.Tensor] = {}
        self._req_t0: Dict[int, float] = {}  # obs: rid -> admit clock
        # engine-local preemption ledger: rid -> (original request, tokens
        # already emitted across incarnations) — stitched back in _finish
        self._preempted: Dict[int, tuple] = {}
        self.ticks = 0
        self.decode_ticks = 0
        self.prefill_ticks = 0
        self.prefill_tokens = 0
        self.migrated_admits = 0
        self.migrated_tokens_saved = 0
        self.preemptions = 0
        self._occupied_slot_steps = 0  # active slots summed over decode ticks
        self._page_steps = 0           # pages in use summed over decode ticks

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        validate_budget(req, self.n_prefix, self.cache_len)
        self.scheduler.submit(req)

    def _slot_pos(self, slot: int) -> int:
        """Device `pos` register of an active slot, derived from host state
        (exact at chunk boundaries): admit sets pos=start and emits one
        token, every tick emits one more and advances pos."""
        g = len(self.pool.generated[slot]) + (
            1 if slot in self._pending_first else 0)
        return int(self.pool.pos[slot]) + max(0, g - 1)

    def _admit(self, req: Request, slot: int) -> None:
        if self.paged and req.kv_seed is not None:
            self._admit_migrated(req, slot)
            return
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None, :]
        start_pos = prompt.shape[1] + self.n_prefix
        page_ids = None
        if self.paged:
            npg = self.pages.pages_for(start_pos + 1)
            got = self.pages.alloc(slot, npg)
            assert got is not None, "admission gate checked pages"
            self.block_tables[slot, :npg] = got
            page_ids = torch.as_tensor(got, dtype=torch.long,
                                       device=self.device)
        first = self.program.admit(
            self.params, prompt, self._extra(req), self.cache, self.regs,
            slot, start_pos,
            req.max_new_tokens, -1 if req.eos_id is None else req.eos_id,
            page_ids=page_ids)
        self.pool.occupy(slot, req, start_pos, self.ticks)
        self._pending_first[slot] = first  # harvested with the next chunk
        self.prefill_ticks += 1
        self.prefill_tokens += int(prompt.shape[1])
        rec = obs.get()
        if rec.enabled:
            self._req_t0[req.rid] = rec.clock()
            # int(): a numpy slot index would make the trace unwritable
            rec.event("serve.admit", host=self.host, cat="serving",
                      rid=req.rid, slot=int(slot))

    def _extra(self, req: Request) -> Optional[torch.Tensor]:
        """The request's modality input on the engine's device."""
        if req.extra_embeds is None:
            return None
        return torch.as_tensor(req.extra_embeds, device=self.device)

    def _admit_migrated(self, req: Request, slot: int) -> None:
        """Install a continuation's harvested KV onto freshly allocated
        pages instead of re-prefilling its prefix: the registers take the
        sequential-decode invariant (last emitted token pending at `pos`)
        and the next chunk continues from there, with zero prefill."""
        kv = req.kv_seed
        if kv.page_size != self.page_size:
            raise ValueError(f"migrated page size {kv.page_size} != "
                             f"engine page size {self.page_size}")
        start_pos = len(np.asarray(req.prompt)) + self.n_prefix
        if kv.pos != start_pos - 1:
            raise ValueError(f"request {req.rid}: migrated KV holds "
                             f"{kv.pos} positions, its prompt {start_pos}")
        npg = self.pages.pages_for(kv.pos + 1)  # coverage incl. next write
        got = self.pages.alloc(slot, npg)
        assert got is not None, "admission gate checked pages"
        self.block_tables[slot, :npg] = got
        self.program.install(
            self.cache, self.regs, slot,
            torch.as_tensor(got, dtype=torch.long, device=self.device), kv,
            req.max_new_tokens, -1 if req.eos_id is None else req.eos_id)
        self.pool.occupy(slot, req, start_pos, self.ticks)
        self.migrated_admits += 1
        self.migrated_tokens_saved += int(kv.pos)
        rec = obs.get()
        if rec.enabled:
            self._req_t0[req.rid] = rec.clock()
            rec.event("serve.admit_migrated", host=self.host, cat="serving",
                      rid=req.rid, slot=int(slot), pages=npg,
                      tokens_resident=int(kv.pos))

    # ------------------------------------------------------------------
    def _release_slot(self, slot: int) -> None:
        self.pool.release(slot)
        if self.paged:
            self.pages.release(slot)

    def _finish(self, slot: int, reason: str) -> None:
        req = self.pool.request[slot]
        orig, prefix = self._preempted.pop(req.rid, (req, []))
        self.finished.append(FinishedRequest(
            rid=req.rid,
            prompt_len=len(np.asarray(orig.prompt)),
            tokens=prefix + list(self.pool.generated[slot]),
            finish_reason=reason,
            admitted_tick=int(self.pool.admitted_tick[slot]),
            finished_tick=self.ticks))
        self._release_slot(slot)
        rec = obs.get()
        if rec.enabled:
            # the request lifecycle as one span: admit -> finish
            t0 = self._req_t0.pop(req.rid, None)
            if t0 is not None:
                rec.complete("request", t0, rec.clock() - t0,
                             host=self.host, cat="serving", rid=req.rid,
                             reason=reason,
                             tokens=len(self.finished[-1].tokens))

    def _consume(self, slot: int, tok: int) -> None:
        """Host mirror of the device retirement rule for one token."""
        req = self.pool.request[slot]
        self.pool.generated[slot].append(tok)
        if len(self.pool.generated[slot]) == 1:
            obs.get().event("serve.first_token", host=self.host,
                            cat="serving", rid=req.rid)
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(slot, "eos")
        elif len(self.pool.generated[slot]) >= req.max_new_tokens:
            self._finish(slot, "length")

    def _harvest_pending(self) -> None:
        if not self._pending_first:
            return
        pend = sorted(self._pending_first.items())
        self._pending_first = {}
        for slot, ref in pend:
            self._consume(slot, int(ref[0, 0]))
            if not self.pool.active[slot]:
                # finished on the prefill token (EOS, or budget 1): the
                # device never saw that token in a tick, so reconcile its
                # active flag before the next chunk
                self.regs["active"][slot] = False

    def _device_active(self) -> List[int]:
        """Remaining token budget of every slot the DEVICE still decodes."""
        out = []
        for s in np.flatnonzero(self.pool.active):
            s = int(s)
            rem = (self.pool.request[s].max_new_tokens
                   - len(self.pool.generated[s])
                   - (1 if s in self._pending_first else 0))
            if rem > 0:
                out.append(rem)
        return out

    # -- paged growth / preemption -------------------------------------
    def _preempt(self, slot: int) -> None:
        """Evict an active slot to reclaim its pages: its harvested tokens
        become an engine-local prefix continuation requeued at the HEAD of
        the queue.  The victim is always the most recently admitted (see
        _ensure_coverage), so pool exhaustion is a stall, never a
        livelock."""
        req = self.pool.request[slot]
        orig, prefix = self._preempted.pop(req.rid, (req, []))
        prefix = prefix + list(self.pool.generated[slot])
        remaining = orig.max_new_tokens - len(prefix)
        if prefix:
            prompt = np.concatenate([np.asarray(orig.prompt, np.int32),
                                     np.asarray(prefix, np.int32)])
            cont = Request(rid=req.rid, prompt=prompt,
                           max_new_tokens=remaining, eos_id=orig.eos_id,
                           extra_embeds=orig.extra_embeds)
            self._preempted[req.rid] = (orig, prefix)
        else:
            cont = orig  # nothing emitted: re-admit verbatim
        self._release_slot(slot)
        self._pending_first.pop(slot, None)
        self.regs["active"][slot] = False
        self.scheduler.queue.appendleft(cont)
        self.preemptions += 1
        obs.get().event("serve.preempt", host=self.host, cat="serving",
                        rid=req.rid, slot=int(slot), emitted=len(prefix))

    def _ensure_coverage(self, k: int) -> None:
        """Grow every active slot's block table to cover the next k ticks,
        preempting youngest-first when the pool runs dry.  Oldest slots
        are served first, so the allocation order is deterministic."""
        order = sorted(
            (int(self.pool.admitted_tick[s]), s)
            for s in np.flatnonzero(self.pool.active))
        for _, slot in order:
            if not self.pool.active[slot]:
                continue  # preempted below an earlier slot in this pass
            # clamp to the table width: near its budget end a slot's
            # pos + k overshoots cache_len, but no write can land there
            need = min(self.pages.pages_for(self._slot_pos(slot) + k),
                       self.n_max)
            have = len(self.pages.owned.get(slot, ()))
            while need > have:
                got = self.pages.alloc(slot, need - have)
                if got is not None:
                    self.block_tables[slot, have:need] = got
                    have = need
                    break
                victims = [
                    (int(self.pool.admitted_tick[s]), s)
                    for s in np.flatnonzero(self.pool.active)
                    if s != slot]
                assert victims, ("pool sized below one max-length request "
                                 "slipped past the constructor check")
                self._preempt(max(victims)[1])

    def _decode_chunk(self, remaining: List[int]) -> None:
        """k decode ticks, one host sync.  k = the largest power of two <=
        the smallest remaining budget (so budget retirements land on chunk
        boundaries), capped at chunk_cap."""
        m = min(min(remaining), self.chunk_cap)
        k = 1 << (m.bit_length() - 1)
        bt = None
        if self.paged:
            self._ensure_coverage(k)
            if not self.pool.num_active and not self._pending_first:
                return  # coverage preempted the whole pool
            self._page_steps += self.pages.pages_in_use * k
            bt = torch.from_numpy(self.block_tables).to(self.device)
        block = self.program.chunk(self.params, self.cache, self.regs, k,
                                   block_tables=bt)
        self.decode_ticks += k
        # single harvest: (k,B) token block + the per-tick active masks
        T, A = block.cpu().numpy()
        self._occupied_slot_steps += int(A.sum())
        self._harvest_pending()
        for t in range(k):
            for slot in np.flatnonzero(A[t]):
                slot = int(slot)
                if self.pool.active[slot]:
                    self._consume(slot, int(T[t, slot]))

    # ------------------------------------------------------------------
    def _next_admission(self):
        """FIFO admission, gated in paged mode on the pool having pages
        for the prompt: a request that does not fit yet stays at the head
        of the queue."""
        admission = self.scheduler.next_admission()
        if admission is None or not self.paged:
            return admission
        req, slot = admission
        if req.kv_seed is not None:
            need = self.pages.pages_for(req.kv_seed.pos + 1)
        else:
            need = self.pages.pages_for(len(np.asarray(req.prompt))
                                        + self.n_prefix + 1)
        if need > self.pages.num_free:
            self.scheduler.queue.appendleft(req)  # keep head-of-line
            return None
        return req, slot

    def tick(self) -> str:
        """One scheduling step: admit a request, or decode a chunk of the
        pool.  Returns "prefill" | "decode" | "idle"."""
        admission = self._next_admission()
        if admission is not None:
            self.ticks += 1
            self._admit(*admission)
            return "prefill"
        if self.pool.num_active or self._pending_first:
            self.ticks += 1
            remaining = self._device_active()
            if remaining:
                self._decode_chunk(remaining)
            else:
                self._harvest_pending()
            return "decode"
        return "idle"

    def run(self, requests: Optional[Sequence[Request]] = None
            ) -> List[FinishedRequest]:
        """Drain `requests` (plus anything already queued) to completion;
        returns finished requests sorted by request id."""
        for req in requests or ():
            self.submit(req)
        while not self.scheduler.done:
            self.tick()
        return sorted(self.finished, key=lambda f: f.rid)

    # ------------------------------------------------------------------
    @property
    def free_capacity(self) -> int:
        """Free slots minus admissions already waiting in the queue."""
        return max(0, self.num_slots - self.pool.num_active
                   - self.scheduler.pending)

    def cancel(self, rid: int) -> bool:
        """Abort one request wherever it is — active slot (pages freed,
        device row deactivated) or queue — without recording a finish."""
        for slot in np.flatnonzero(self.pool.active):
            slot = int(slot)
            if self.pool.request[slot].rid == rid:
                self._release_slot(slot)
                self._pending_first.pop(slot, None)
                self.regs["active"][slot] = False
                self._req_t0.pop(rid, None)
                self._preempted.pop(rid, None)
                return True
        for i, req in enumerate(self.scheduler.queue):
            if req.rid == rid:
                del self.scheduler.queue[i]
                self._preempted.pop(rid, None)
                return True
        return False

    def harvest_kv(self, slot: int) -> Optional[MigratedKV]:
        """Copy one active slot's live KV to the host (paged mode, chunk
        boundary): ceil(pos/P) owned pages of every paged leaf (never the
        trash page) and this slot's row of every per-slot leaf.  None when
        nothing was emitted yet (the continuation re-prefills anyway)."""
        if not self.paged or not self.pool.generated[slot]:
            return None
        pos = self._slot_pos(slot)
        npg = self.pages.pages_for(pos)
        ids = torch.as_tensor(self.pages.owned[slot][:npg], dtype=torch.long,
                              device=self.device)
        paged_names = set(MD.paged_leaf_names(self.cfg))
        pages = {n: self.cache[n][:, ids].cpu()
                 for n in self.cache if n in paged_names}
        rows = {n: tree_map(lambda t: t[:, slot].to("cpu", copy=True),
                            self.cache[n])
                for n in self.cache if n not in paged_names}
        return MigratedKV(pos=pos,
                          last_token=int(self.pool.generated[slot][-1]),
                          page_size=self.page_size, pages=pages, rows=rows)

    def drain(self, migrate_kv: bool = True) -> List[DrainedRequest]:
        """Pull every in-flight and queued request off the engine in a
        resumable form, ordered by request id.  Active slots keep their
        host-harvested tokens; in paged mode (migrate_kv=True) each one's
        live KV rides along (`DrainedRequest.kv`).  Queued requests come
        back untouched, a continuation's `kv_seed` kept."""
        rec = obs.get()
        out = []
        for slot in np.flatnonzero(self.pool.active):
            slot = int(slot)
            req = self.pool.request[slot]
            kv = self.harvest_kv(slot) if migrate_kv else None
            orig, prefix = self._preempted.pop(req.rid, (req, []))
            out.append(DrainedRequest(
                orig, prefix + list(self.pool.generated[slot]), kv))
            self._release_slot(slot)
            if rec.enabled:
                rec.event("serve.drain", host=self.host, cat="serving",
                          rid=orig.rid, emitted=len(out[-1].emitted),
                          migrated=kv is not None)
                self._req_t0.pop(orig.rid, None)
        while self.scheduler.queue:
            req = self.scheduler.queue.popleft()
            orig, prefix = self._preempted.pop(req.rid, (req, []))
            out.append(DrainedRequest(orig, list(prefix), req.kv_seed))
            if rec.enabled:
                rec.event("serve.drain", host=self.host, cat="serving",
                          rid=orig.rid, emitted=len(out[-1].emitted))
        self._pending_first = {}
        self.regs["active"].zero_()
        return sorted(out, key=lambda d: d.request.rid)

    # ------------------------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode tick."""
        if not self.decode_ticks:
            return 0.0
        return self._occupied_slot_steps / (self.decode_ticks *
                                            self.num_slots)

    @property
    def pool_occupancy(self) -> float:
        """Mean fraction of pool pages in use per decode tick (paged)."""
        if not self.paged or not self.decode_ticks:
            return 0.0
        return self._page_steps / (self.decode_ticks * self.num_pages)

    def stats(self) -> Dict[str, float]:
        rec = obs.get()
        if rec.enabled:
            rec.gauge("serving.slot_occupancy", self.occupancy)
            if self.paged:
                rec.gauge("serving.pool_occupancy", self.pool_occupancy)
        out = {"ticks": self.ticks, "decode_ticks": self.decode_ticks,
               "prefill_ticks": self.prefill_ticks,
               "prefill_tokens": self.prefill_tokens,
               "occupancy": self.occupancy,
               "generated_tokens": sum(len(f.tokens)
                                       for f in self.finished)}
        if self.paged:
            out.update({"pool_occupancy": self.pool_occupancy,
                        "num_pages": self.num_pages,
                        "preemptions": self.preemptions,
                        "migrated_admits": self.migrated_admits,
                        "migrated_tokens_saved": self.migrated_tokens_saved})
        return out
