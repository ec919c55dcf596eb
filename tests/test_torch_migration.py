"""Port parity for the KV-migrating drain: `harvest_kv` against the JAX
package's at the same drain point, drain -> ServingDrainReadmit -> a
second engine stitched back to the uninterrupted stream (the port's and
JAX's) over a grid of pool sizes and drain points, the migration
counters, re-prefill without migration, queued requests, and a
JAX-harvested MigratedKV continued by the port's engine.  qwen3-0.6b
and zamba2-1.2b SMOKE, fp32, the same weights in both packages."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.elastic import ServingDrainReadmit as JPolicy  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.elastic import ServingDrainReadmit  # noqa: E402
from repro_torch.serving import (DrainedRequest, FinishedRequest,  # noqa: E402
                                 MigratedKV, Request, ServeEngine)

import test_torch_bridge as TP  # noqa: E402

ARCHS = ["qwen3-0.6b", "zamba2-1.2b"]
KW = dict(num_slots=2, cache_len=24, page_size=4)
ATOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _arch(arch):
    """(jax params, port params, jax cfg, port cfg), built once per arch."""
    if arch not in _CACHE:
        jcfg = jax_get_config(arch, smoke=True)
        tcfg = torch_get_config(arch, smoke=True)
        _CACHE[arch] = (*TP.params(jcfg), jcfg, tcfg)
    return _CACHE[arch]


def _stream(vocab, n=4, seed=13, plens=(5, 8), gens=(6, 10)):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, size=int(rng.choice(plens))),
             int(rng.choice(gens))) for i in range(n)]


def _treqs(reqs):
    return [Request(rid=i, prompt=p.copy(), max_new_tokens=g)
            for i, p, g in reqs]


def _jreqs(reqs):
    return [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g)
            for i, p, g in reqs]


def _key(reqs):
    return tuple((i, tuple(p.tolist()), g) for i, p, g in reqs)


def _jax_ref(arch, reqs):
    """JAX's uninterrupted paged run: {rid: tokens}, run once per arch and
    stream."""
    key = (arch, _key(reqs))
    if key not in _CACHE:
        jp, _, jcfg, _ = _arch(arch)
        _CACHE[key] = {f.rid: f.tokens for f in JEngine(jp, jcfg, **KW).run(
            _jreqs(reqs))}
    return _CACHE[key]


def _engine(tp, tcfg, num_pages=None):
    return ServeEngine(tp, tcfg, num_pages=num_pages, device="cpu", **KW)


def _drain_and_resume(tp, tcfg, reqs, ticks, num_pages=None,
                      migrate_kv=True):
    """`ticks` ticks on engine A, drain, finish on engine B.  Returns
    ({rid: tokens} stitched, engine B, the drain output)."""
    a = _engine(tp, tcfg, num_pages)
    for q in _treqs(reqs):
        a.submit(q)
    for _ in range(ticks):
        if a.scheduler.done:
            break
        a.tick()
    drained = a.drain(migrate_kv=migrate_kv)
    assert a.pool.num_active == 0 and a.scheduler.pending == 0
    assert not bool(a.regs["active"].any()) and not a._pending_first
    policy = ServingDrainReadmit()
    b = _engine(tp, tcfg, num_pages)
    out = {f.rid: f.tokens for f in a.finished}
    for f in b.run(policy.readmit(drained)):
        s = policy.stitch(f)
        out[s.rid] = s.tokens
    return out, b, drained


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + k + "/")
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_harvest_matches_jax(arch):
    """At the same drain point both engines harvest the same slots with
    the same positions, last tokens and emitted prefixes, and pages and
    rows within fp32 tolerance; the port's harvest is the pool's owned
    pages, never the trash page."""
    jp, tp, jcfg, tcfg = _arch(arch)
    reqs = _stream(jcfg.vocab_size, seed=11, plens=(6, 9), gens=(10,))
    jeng, teng = JEngine(jp, jcfg, **KW), _engine(tp, tcfg)
    for jq, tq in zip(_jreqs(reqs), _treqs(reqs)):
        jeng.submit(jq)
        teng.submit(tq)
    for _ in range(3):                 # two admits and one chunk
        assert jeng.tick() == teng.tick()
    owned = {int(s): list(teng.pages.owned[int(s)])
             for s in np.flatnonzero(teng.pool.active)}
    held = {n: t.clone() for n, t in teng.cache.items()
            if n in ("k", "v", "sk", "sv")}
    assert all(teng.num_pages not in ids for ids in owned.values())
    jd, td = jeng.drain(), teng.drain()
    assert [d.request.rid for d in td] == [d.request.rid for d in jd]
    assert sum(d.kv is not None for d in td) >= 2
    for j, t in zip(jd, td):
        assert t.emitted == j.emitted
        assert (t.kv is None) == (j.kv is None)
        if t.kv is None:
            continue
        assert (t.kv.pos, t.kv.last_token, t.kv.page_size) == (
            j.kv.pos, j.kv.last_token, j.kv.page_size)
        assert sorted(t.kv.pages) == sorted(j.kv.pages)
        for n, pages in t.kv.pages.items():
            assert pages.device.type == "cpu"
            assert pages.shape[1] == -(-t.kv.pos // KW["page_size"])
            np.testing.assert_allclose(pages.numpy(), j.kv.pages[n], **ATOL)
        tr, jr = dict(_leaves(t.kv.rows)), dict(_leaves(j.kv.rows))
        assert sorted(tr) == sorted(jr)
        for n in tr:
            np.testing.assert_allclose(tr[n], jr[n], **ATOL)
    # a harvest copies: the pool's pages are what they were
    for n, t in held.items():
        assert torch.equal(teng.cache[n], t)


@pytest.mark.parametrize("ticks", [1, 3, 6, 9])
@pytest.mark.parametrize("num_pages", [6, 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_migration_identity_any_pool_any_drain_point(arch, num_pages, ticks):
    """For pool sizes down to one max-length request and drain points
    from the first admit on: drain -> migrate -> readmit reproduces the
    uninterrupted stream, the port's and JAX's."""
    _, tp, jcfg, tcfg = _arch(arch)
    reqs = _stream(jcfg.vocab_size)
    key = (arch, num_pages)
    if key not in _CACHE:
        _CACHE[key] = {f.rid: f.tokens for f in _engine(
            tp, tcfg, num_pages).run(_treqs(reqs))}
    ref = _CACHE[key]
    assert ref == _jax_ref(arch, reqs)
    out, b, drained = _drain_and_resume(tp, tcfg, reqs, ticks, num_pages)
    assert out == ref, (num_pages, ticks)
    assert b.migrated_admits == sum(d.kv is not None for d in drained)


@pytest.mark.parametrize("arch", ARCHS)
def test_migration_counters_and_reprefill(arch):
    """migrated_admits / migrated_tokens_saved exact; without migration the
    continuations re-prefill (same bytes, more prefill tokens); the
    migrated engine's prefill leaves out every harvested prefix."""
    _, tp, jcfg, tcfg = _arch(arch)
    reqs = _stream(jcfg.vocab_size, seed=11, plens=(6, 9), gens=(10,))
    ref = _jax_ref(arch, reqs)
    out_m, b_m, drained = _drain_and_resume(tp, tcfg, reqs, ticks=3)
    assert out_m == ref
    harvested = [d for d in drained if d.kv is not None]
    assert harvested, "the drain point must catch live slots"
    for d in harvested:
        assert isinstance(d.kv, MigratedKV)
        assert d.kv.pos == len(d.request.prompt) + len(d.emitted) - 1
    assert b_m.migrated_admits == len(harvested)
    assert b_m.migrated_tokens_saved == sum(d.kv.pos for d in harvested)
    st = b_m.stats()
    assert (st["migrated_admits"], st["migrated_tokens_saved"]) == (
        b_m.migrated_admits, b_m.migrated_tokens_saved)
    fresh = [d for d in drained if d.kv is None]
    assert b_m.prefill_tokens == sum(
        len(d.request.prompt) + len(d.emitted) for d in fresh)
    out_p, b_p, _ = _drain_and_resume(tp, tcfg, reqs, ticks=3,
                                      migrate_kv=False)
    assert out_p == ref
    assert b_p.migrated_admits == 0 and b_p.migrated_tokens_saved == 0
    assert b_m.prefill_tokens < b_p.prefill_tokens


def test_drain_returns_queued_requests_untouched():
    """Queued requests come back with nothing emitted and the very same
    request; a queued continuation keeps its kv_seed through a second
    drain and readmit; a dense engine drains without KV."""
    _, tp, jcfg, tcfg = _arch("qwen3-0.6b")
    reqs = _stream(jcfg.vocab_size, n=5, seed=2, plens=(6,), gens=(12,))
    a = _engine(tp, tcfg)
    sent = _treqs(reqs)
    for q in sent:
        a.submit(q)
    for _ in range(3):                 # rid 0, 1 admitted and decoding
        a.tick()
    drained = a.drain()
    assert [d.request.rid for d in drained] == [0, 1, 2, 3, 4]
    for d in drained[2:]:
        assert d.request is sent[d.request.rid] and d.emitted == []
        assert d.kv is None
    assert all(d.kv is not None and d.emitted for d in drained[:2])
    policy = ServingDrainReadmit()
    conts = policy.readmit(drained)
    b = _engine(tp, tcfg)
    for c in conts:
        b.submit(c)
    again = b.drain()                  # nothing admitted: all queued
    assert [d.kv for d in again[:2]] == [c.kv_seed for c in conts[:2]]
    assert all(d.kv is not None for d in again[:2])
    out = {}
    for f in _engine(tp, tcfg).run(policy.readmit(again)):
        out[f.rid] = policy.stitch(f).tokens
    assert out == _jax_ref("qwen3-0.6b", reqs)
    dense = ServeEngine(tp, tcfg, num_slots=2, cache_len=24, device="cpu")
    for q in _treqs(reqs):
        dense.submit(q)
    for _ in range(3):
        dense.tick()
    assert all(d.kv is None for d in dense.drain())


def test_stitch_reconstructs_full_output():
    orig = Request(rid=4, prompt=np.arange(5, dtype=np.int32),
                   max_new_tokens=6)
    policy = ServingDrainReadmit()
    [cont] = policy.readmit([DrainedRequest(orig, [7, 8])])
    assert cont.max_new_tokens == 4 and cont.kv_seed is None
    assert np.asarray(cont.prompt).tolist() == [0, 1, 2, 3, 4, 7, 8]
    fin = FinishedRequest(rid=4, prompt_len=7, tokens=[9, 10, 11, 12],
                          finish_reason="length", admitted_tick=1,
                          finished_tick=9)
    out = policy.stitch(fin)
    assert out.tokens == [7, 8, 9, 10, 11, 12]
    assert out.prompt_len == 5
    assert not policy.originals and not policy.emitted
    with pytest.raises(ValueError, match="after completion"):
        policy.readmit([DrainedRequest(orig, [1, 2, 3, 4, 5, 6])])


def _to_port(cont):
    """A JAX continuation request -> the port's, its MigratedKV's numpy
    pages and rows carried over as CPU tensors."""
    kv = cont.kv_seed
    if kv is not None:
        def rows(tree):
            if isinstance(tree, dict):
                return {k: rows(v) for k, v in tree.items()}
            return torch.from_numpy(np.array(tree, np.float32))
        kv = MigratedKV(pos=kv.pos, last_token=kv.last_token,
                        page_size=kv.page_size,
                        pages={n: torch.from_numpy(np.array(p, np.float32))
                               for n, p in kv.pages.items()},
                        rows=rows(kv.rows))
    return Request(rid=cont.rid, prompt=np.asarray(cont.prompt, np.int32),
                   max_new_tokens=cont.max_new_tokens, eos_id=cont.eos_id,
                   kv_seed=kv)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_harvest_continues_in_the_port(arch):
    """Cross-package: a JAX engine drained mid-stream, its continuations
    (harvested pages and rows) installed in the port's engine, which
    continues with the JAX engine's stream without any prefill of the
    harvested prefixes."""
    jp, tp, jcfg, tcfg = _arch(arch)
    reqs = _stream(jcfg.vocab_size, seed=17, plens=(6, 9), gens=(10,))
    ref = _jax_ref(arch, reqs)
    a = JEngine(jp, jcfg, **KW)
    for q in _jreqs(reqs):
        a.submit(q)
    for _ in range(3):
        a.tick()
    drained = a.drain()
    assert sum(d.kv is not None for d in drained) >= 2
    policy = JPolicy()
    conts = [_to_port(c) for c in policy.readmit(drained)]
    b = _engine(tp, tcfg)
    out = {f.rid: f.tokens for f in a.finished}
    for f in b.run(conts):
        out[f.rid] = policy.stitch(f).tokens
    assert out == ref
    assert b.migrated_admits == sum(c.kv_seed is not None for c in conts)
    assert b.prefill_tokens == sum(len(c.prompt) for c in conts
                                   if c.kv_seed is None)
