"""Speculative draft-verify decoding on the slot-pool engine.

The PyTorch counterpart of the JAX package's ``serving/speculative.py``.
A drafter proposes k tokens per slot, the target scores all k+1
positions in one wide pass (`model.verify_step`, with the per-slot `pos`
vectors and active masks of the serve tick), and the engine accepts the
longest prefix on which the target's own greedy choices agree with the
draft, plus the target's correction token at the first disagreement.
Every emitted token is the target's argmax at its position, so the
stream is the one sequential greedy decode gives (bit for bit on the
CPU in fp32; on the card, where a verify pass runs wider GEMMs and
another paged-attention split than a decode tick, up to near-ties).

Two drafters:

* `LookupDraft` — model-free n-gram lookup over the request's own
  prompt + generated history (longest-suffix match, falling back to
  repeat-last); no device work at all.
* `ModelDraft` — a smaller model over the same vocabulary (qwen3-0.6b
  for qwen3-1.7b).  The draft keeps its own dense slot cache in lockstep
  with the pool: accepted positions hold draft KV of what the draft
  itself proposed, and the rejected tail is overwritten by the next
  round's scan.

Rollback is a register update, not a cache operation: verify writes KV
for all k+1 candidates, and a rejection leaves `pos` below the stale
entries, which the next round overwrites before any query can see them.
So KV is exact below `pos` at every round boundary, and `harvest_kv` and
re-admission work unchanged.

`jax.jit` and `lax.scan` of the JAX module become plain calls and a
Python loop; the caches are updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import sharding as SH
from repro_torch.launch.steps import sharded_argmax
from repro_torch.models import model as MD
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request, validate_budget


class LookupDraft:
    """Model-free drafter: propose the continuation that followed the most
    recent earlier occurrence of the current suffix (n-gram lookup with
    n = max_n..1, repeat-last fallback).  Host-side, O(history) per
    proposal."""

    def __init__(self, max_n: int = 3):
        self.max_n = max_n

    def propose(self, ctx: Sequence[int], k: int) -> List[int]:
        ctx = [int(t) for t in ctx]
        out = []
        for _ in range(k):
            nxt = None
            for n in range(min(self.max_n, len(ctx) - 1), 0, -1):
                key = ctx[-n:]
                for i in range(len(ctx) - n - 1, -1, -1):
                    if ctx[i:i + n] == key:
                        nxt = ctx[i + n]
                        break
                if nxt is not None:
                    break
            if nxt is None:
                nxt = ctx[-1]
            out.append(nxt)
            ctx.append(nxt)
        return out


class ModelDraft:
    """Draft with a smaller model over the same vocabulary.  Holds the
    (params, cfg) pair; the engine owns the draft's slot cache."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg


class SpecDecodeEngine(ServeEngine):
    """ServeEngine whose decode step is a draft-verify round.

    Each round replaces up to `spec_k + 1` sequential pool ticks with one
    wide verify pass (plus the draft's cost: none for LookupDraft,
    `spec_k + 1` draft decode ticks for ModelDraft).  Emissions per round
    per slot: the guaranteed correction token plus the accepted draft
    prefix, cut by the slot's remaining budget and by the first EOS."""

    def __init__(self, params, cfg, *, draft=None, spec_k: int = 3, **kw):
        if cfg.arch_type not in ("dense", "vlm", "moe"):
            raise ValueError(f"speculative decoding needs a pure-attention "
                             f"cache (dense/vlm/moe), got {cfg.arch_type}")
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        self.spec_k = spec_k
        self.draft = draft if draft is not None else LookupDraft()
        if isinstance(self.draft, ModelDraft):
            if self.draft.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {self.draft.cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}: draft proposals must be "
                    f"target tokens")
        super().__init__(params, cfg, **kw)
        if (isinstance(self.draft, ModelDraft)
                and self.draft.params["embed"].device != self.device):
            raise ValueError(f"draft params live on "
                             f"{self.draft.params['embed'].device}, engine "
                             f"runs on {self.device}")

    def reset(self) -> None:
        super().reset()
        if isinstance(self.draft, ModelDraft):
            self.draft_cache = MD.init_cache(self.draft.cfg, self.num_slots,
                                             self.cache_len, self.device,
                                             mesh=self.mesh)
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_full_accepts = 0   # row-rounds that accepted all spec_k

    def submit(self, req: Request) -> None:
        # verify writes KV at pos..pos+spec_k even when it emits only one
        # token, so every slot needs spec_k positions of headroom beyond
        # the sequential budget
        validate_budget(req, self.n_prefix, self.cache_len - self.spec_k)
        self.scheduler.submit(req)

    # -- the round and the draft ---------------------------------------
    def _round(self, props: torch.Tensor, block_tables=None):
        """One verify pass over every slot and the on-device acceptance
        rule.  Advances the lifecycle registers; returns the (S, B) token
        and emit blocks and each row's emission count m_eff (B,)."""
        r = self.regs
        tokens, pos, active = r["tokens"], r["pos"], r["active"]
        gen, maxgen, eos = r["gen"], r["maxgen"], r["eos"]
        S = self.spec_k + 1
        vtok = torch.cat([tokens, props], dim=1)                  # (B, S)
        logits, _ = MD.verify_step(
            self.params, self.cfg, vtok, pos, self.cache, active=active,
            block_tables=block_tables,
            logical_len=self.cache_len if self.paged else None)
        outs = SH.whole(sharded_argmax(logits))                   # (B, S)
        # accept the agreeing prefix + the target's correction token
        match = (props == outs[:, :-1]).to(torch.int32)
        m_raw = 1 + torch.cumprod(match, dim=1).sum(dim=1)
        m_bud = torch.minimum(m_raw, (maxgen - gen).clamp(min=0))
        iota = torch.arange(S, device=self.device)
        first_eos = torch.where(outs == eos[:, None], iota[None], S
                                ).min(dim=1).values
        m_eff = torch.minimum(m_bud, first_eos + 1)
        m_eff = torch.where(active, m_eff, 0)
        emit = iota[None] < m_eff[:, None]
        T = torch.where(emit, outs, 0).T                          # (S, B)
        last = outs.gather(1, (m_eff - 1).clamp(min=0)[:, None].long())
        r["tokens"] = torch.where(active[:, None], last, tokens)
        r["pos"] = pos + m_eff.to(pos.dtype)
        r["gen"] = gen + m_eff.to(gen.dtype)
        fin = active & ((first_eos < m_eff) | (r["gen"] >= maxgen))
        r["active"] = active & ~fin
        return T, emit.T, m_eff

    def _draft_scan(self) -> torch.Tensor:
        """k + 1 draft decode ticks on the draft's dense slot cache for k
        proposals: the last tick consumes the k-th proposal only to write
        its KV (its output is dropped).  On a full-accept round the target
        advances k+1 positions, and without that write position pos+k
        would stay a hole in the draft cache; on a rejection round the
        extra write is stale and the next scan overwrites it when it first
        becomes attendable.  Returns (B, k) proposals."""
        dcfg, dparams = self.draft.cfg, self.draft.params
        tok, p = self.regs["tokens"], self.regs["pos"]
        active = self.regs["active"]
        props = []
        for _ in range(self.spec_k + 1):
            logits, _ = MD.decode_step(dparams, dcfg, tok, p,
                                       self.draft_cache, active=active)
            nxt = SH.whole(sharded_argmax(logits[:, -1]))[:, None]
            tok = torch.where(active[:, None], nxt, tok)
            props.append(tok[:, 0])
            p = p + active.to(p.dtype)
        return torch.stack(props[:self.spec_k], dim=1)

    def _draft_admit(self, prompt: torch.Tensor, extra, slot: int) -> None:
        _, _, req_cache = MD.forward(
            self.draft.params, self.draft.cfg, prompt, extra_embeds=extra,
            return_cache=True, cache_len=self.cache_len,
            sharded_cache=SH.is_dtensor(self.draft.params["embed"]))
        MD.write_cache_slot(self.draft_cache, req_cache, slot)

    # -- engine overrides ----------------------------------------------
    def _admit(self, req: Request, slot: int) -> None:
        super()._admit(req, slot)
        if isinstance(self.draft, ModelDraft) and req.kv_seed is None:
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                     device=self.device)[None, :]
            self._draft_admit(prompt, self._extra(req), slot)
        # a migrated admit leaves the draft's slot cache cold: the draft's
        # guesses start out uninformed, the verifier stays exact

    def _propose(self) -> torch.Tensor:
        """(B, spec_k) int32 draft tokens for every slot (inactive rows
        are don't-cares: the round masks them out)."""
        if isinstance(self.draft, ModelDraft):
            return self._draft_scan()
        props = np.zeros((self.num_slots, self.spec_k), np.int32)
        for slot in np.flatnonzero(self.pool.active):
            slot = int(slot)
            req = self.pool.request[slot]
            ctx = list(np.asarray(req.prompt)) + self.pool.generated[slot]
            props[slot] = self.draft.propose(ctx, self.spec_k)
        return torch.from_numpy(props).to(self.device)

    def _decode_chunk(self, remaining: List[int]) -> None:
        """One draft-verify round (replaces the k-tick chunk)."""
        # the host drafter needs every emitted token, including the
        # admit-time first token still on the device: harvest first
        self._harvest_pending()
        if not self.pool.num_active:
            return
        props = self._propose()
        bt = None
        if self.paged:
            self._ensure_coverage(self.spec_k + 1)
            if not self.pool.num_active:
                return
            self._page_steps += self.pages.pages_in_use
            bt = torch.from_numpy(self.block_tables).to(self.device)
        T, A, m_eff = self._round(props, bt)
        self.decode_ticks += 1
        self.spec_rounds += 1
        T, A, m_eff = T.cpu().numpy(), A.cpu().numpy(), m_eff.cpu().numpy()
        n_act = int(A[0].sum())        # every active row emits >= 1
        self._occupied_slot_steps += n_act
        self.spec_proposed += n_act * self.spec_k
        # accepted draft tokens exclude each row's guaranteed bonus token
        self.spec_accepted += int(np.maximum(m_eff - 1, 0).sum())
        self.spec_full_accepts += int((m_eff == self.spec_k + 1).sum())
        for t in range(self.spec_k + 1):
            for slot in np.flatnonzero(A[t]):
                slot = int(slot)
                if self.pool.active[slot]:
                    self._consume(slot, int(T[t, slot]))

    @property
    def accept_rate(self) -> float:
        """Fraction of draft proposals the target accepted."""
        if not self.spec_proposed:
            return 0.0
        return self.spec_accepted / self.spec_proposed

    def stats(self) -> Dict[str, float]:
        out = super().stats()
        gen = out["generated_tokens"]
        out.update({
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_full_accepts": self.spec_full_accepts,
            "accept_rate": self.accept_rate,
            "tokens_per_round": gen / max(self.spec_rounds, 1),
        })
        return out
