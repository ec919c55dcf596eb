"""Shared harness of the port's family parity tests (audio, vlm, ssm,
the dense configs): each arch's SMOKE config and weights built once, a
request stream with the modality inputs drawn from a seed with numpy, and
one run of it through the JAX engine and the port's engine, or through a
drain on one engine and a readmit on a second, in both packages."""
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.elastic import ServingDrainReadmit as JPolicy
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro.serving.speculative import LookupDraft as JLookup
from repro.serving.speculative import SpecDecodeEngine as JSpec
from repro_torch.configs import get_config as torch_get_config
from repro_torch.elastic import ServingDrainReadmit
from repro_torch.serving import (LookupDraft, Request, ServeEngine,
                                 SpecDecodeEngine)

import test_torch_bridge as TP

_CACHE = {}


def setup(arch):
    """(jax cfg, port cfg, jax params, port params) of the SMOKE config,
    built once per arch and process."""
    if arch not in _CACHE:
        jcfg = jax_get_config(arch, smoke=True)
        _CACHE[arch] = (jcfg, torch_get_config(arch, smoke=True),
                        *TP.params(jcfg))
    return _CACHE[arch]


def extra(cfg, rng):
    """One request's modality input: vlm patches (1, P, 1024), audio
    frames (1, T_enc, d_model), float32; None for the text families."""
    if cfg.arch_type == "vlm":
        return rng.randn(1, cfg.num_patches, 1024).astype(np.float32)
    if cfg.arch_type == "audio":
        return rng.randn(1, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return None


def stream(cfg, seed, n, plens, gens):
    """[(rid, prompt, budget, extra)]: prompts and inputs from one seed."""
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, cfg.vocab_size, size=int(rng.choice(plens))),
             int(rng.choice(gens)), extra(cfg, rng)) for i in range(n)]


def jreqs(reqs):
    return [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g,
                     extra_embeds=e) for i, p, g, e in reqs]


def treqs(reqs):
    return [Request(rid=i, prompt=p.copy(), max_new_tokens=g,
                    extra_embeds=e) for i, p, g, e in reqs]


def port_engine(tp, tcfg, **kw):
    return ServeEngine(tp, tcfg, device="cpu", **kw)


def engines_match(arch, reqs, kw, spec=False, **port_flags):
    """Both packages' engines (the lookup-draft speculative engine with
    `spec`) on the same stream, the port's config with `port_flags` (its
    kernel flags): the finished requests' tokens, finish ticks and the
    schedule counters must be equal.  Returns the port's engine and its
    finished requests."""
    jcfg, tcfg, jp, tp = setup(arch)
    tcfg = tcfg.with_(**port_flags)
    if spec:
        jeng = JSpec(jp, jcfg, draft=JLookup(), spec_k=2, **kw)
        teng = SpecDecodeEngine(tp, tcfg, draft=LookupDraft(), spec_k=2,
                                device="cpu", **kw)
    else:
        jeng, teng = JEngine(jp, jcfg, **kw), port_engine(tp, tcfg, **kw)
    jfin = {f.rid: f for f in jeng.run(jreqs(reqs))}
    tfin = teng.run(treqs(reqs))
    assert [f.rid for f in tfin] == sorted(jfin)
    for f in tfin:
        j = jfin[f.rid]
        assert f.tokens == j.tokens, f"rid {f.rid}"
        assert len(f.tokens) == reqs[f.rid][2]
        assert (f.finish_reason, f.admitted_tick, f.finished_tick) == (
            j.finish_reason, j.admitted_tick, j.finished_tick)
    jst, tst = jeng.stats(), teng.stats()
    keys = ["ticks", "decode_ticks", "prefill_ticks", "prefill_tokens",
            "occupancy", "generated_tokens"]
    if "page_size" in kw:
        keys += ["preemptions", "pool_occupancy", "num_pages"]
    if spec:
        keys += ["spec_rounds", "spec_accepted"]
    for key in keys:
        assert tst[key] == jst[key], key
    return teng, tfin


def drain_resume(arch, reqs, kw, ticks):
    """`ticks` ticks on engine A, drain (paged engines migrate their KV),
    readmit on engine B, in both packages.  Returns the port's and JAX's
    stitched {rid: tokens} and the port's drain output and engine B."""
    jcfg, tcfg, jp, tp = setup(arch)

    def run(make, reqs_of, policy):
        a = make()
        for q in reqs_of(reqs):
            a.submit(q)
        for _ in range(ticks):
            a.tick()
        out = {f.rid: f.tokens for f in a.finished}
        drained = a.drain()
        b = make()
        for f in b.run(policy.readmit(drained)):
            s = policy.stitch(f)
            out[s.rid] = s.tokens
        return out, drained, b
    jout, _, _ = run(lambda: JEngine(jp, jcfg, **kw), jreqs, JPolicy())
    tout, drained, b = run(lambda: port_engine(tp, tcfg, **kw), treqs,
                           ServingDrainReadmit())
    return tout, jout, drained, b


def harvested_rows_match(arch, reqs, kw, ticks):
    """At one drain point both engines harvest the same slots, and the
    port's pages and per-slot rows equal JAX's within fp32 tolerance.
    Returns the port's drain output."""
    jcfg, tcfg, jp, tp = setup(arch)
    jeng, teng = JEngine(jp, jcfg, **kw), port_engine(tp, tcfg, **kw)
    for jq, tq in zip(jreqs(reqs), treqs(reqs)):
        jeng.submit(jq)
        teng.submit(tq)
    for _ in range(ticks):
        assert jeng.tick() == teng.tick()
    jd, td = jeng.drain(), teng.drain()
    assert [d.request.rid for d in td] == [d.request.rid for d in jd]
    for j, t in zip(jd, td):
        assert t.emitted == j.emitted and (t.kv is None) == (j.kv is None)
        if t.kv is None:
            continue
        assert (t.kv.pos, t.kv.last_token) == (j.kv.pos, j.kv.last_token)
        for src, ref in ((t.kv.pages, j.kv.pages), (t.kv.rows, j.kv.rows)):
            assert sorted(src) == sorted(ref)
            for n in src:
                np.testing.assert_allclose(
                    torch.as_tensor(src[n]).numpy(),
                    np.asarray(ref[n], np.float32), rtol=1e-4, atol=1e-4)
    return td
