"""Port parity for speculative draft-verify decoding: `verify_step`
against the JAX package's and against sequential `decode_step` calls,
dense and paged; then the counterparts of tests/test_speculative.py,
each greedy stream equal to the port's plain ServeEngine and to JAX's
SpecDecodeEngine on the same weights (qwen3-0.6b, and qwen3-0.6b
drafting for qwen3-1.7b, SMOKE, fp32); the lookup draft against JAX's;
and the launcher's --speculative."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.elastic import ServingDrainReadmit as JPolicy  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.serving import LookupDraft as JLookup  # noqa: E402
from repro.serving import ModelDraft as JModelDraft  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import SpecDecodeEngine as JSpec  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.elastic import ServingDrainReadmit  # noqa: E402
from repro_torch.launch.steps import sharded_argmax  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving import (LookupDraft, ModelDraft, Request,  # noqa: E402
                                 ServeEngine, SpecDecodeEngine)

import test_torch_bridge as TP  # noqa: E402

B, S0, K = 3, 8, 3          # rows, prefill length, draft tokens per round
P = 4                       # page size


def _atol(logits):
    return 2e-5 * max(1.0, float(np.abs(logits).max()))


def _setup(tp, tcfg, toks):
    """A dense cache and a paged pool (scrambled disjoint pages, one spare
    page a row past the prefill) holding the same S0-token prefill."""
    n_max = -(-(S0 + K + 1) // P) + 1
    Cl = n_max * P
    Np = B * n_max
    dense = TMD.init_cache(tcfg, B, Cl, "cpu")
    paged = TMD.init_paged_cache(tcfg, B, Np, P, "cpu")
    ids = np.random.RandomState(7).permutation(Np).reshape(B, n_max)
    npg = -(-S0 // P)
    for b in range(B):
        row = torch.from_numpy(toks[b:b + 1, :S0])
        _, _, c1 = TMD.forward(tp, tcfg, row, return_cache=True, cache_len=Cl)
        TMD.write_cache_slot(dense, c1, b)
        _, _, c2 = TMD.forward(tp, tcfg, row, return_cache=True,
                               cache_len=npg * P)
        TMD.write_paged_cache(paged, c2, b, torch.from_numpy(ids[b, :npg]),
                              tcfg)
    return dense, paged, torch.from_numpy(ids.astype(np.int32)), Cl, Np


def _verify_inputs(vocab, seed):
    toks = np.random.RandomState(seed).randint(
        0, vocab, size=(B, S0 + K + 1)).astype(np.int32)
    # rows at different positions: one re-verifies over its own stale tail
    pos = np.asarray([S0, S0 - 2, S0 - 1], np.int32)
    return toks, pos, toks[:, S0:S0 + K + 1]


MODES = ["dense", "paged", "paged_kernel_flag"]


@pytest.mark.parametrize("masked", [False, True],
                         ids=["all_active", "one_retired"])
@pytest.mark.parametrize("mode", MODES)
def test_verify_step_matches_jax(mode, masked):
    """Logits and the written cache against JAX's verify_step from the same
    cache state; with use_paged_kernel the port's read goes through the
    paged kernel wrapper (its plain version here, B*S query rows), where
    the JAX package always gathers."""
    jcfg, _ = TP.configs()
    _, tcfg = TP.configs(use_paged_kernel=mode == "paged_kernel_flag")
    jp, tp = TP.params(jcfg)
    toks, pos, vt = _verify_inputs(jcfg.vocab_size, seed=1)
    dense, paged, bt, Cl, Np = _setup(tp, tcfg, toks)
    active = np.asarray([True, False, True]) if masked else None
    jkw = {} if active is None else {"active": jnp.asarray(active)}
    tkw = {} if active is None else {"active": torch.from_numpy(active)}
    if mode == "dense":
        jc = {n: jnp.asarray(t.numpy()) for n, t in dense.items()}
        tc = dense
    else:
        jc = {n: jnp.asarray(t[:, :Np].numpy()) for n, t in paged.items()}
        tc = paged
        jkw.update(block_tables=jnp.asarray(bt.numpy()), logical_len=Cl)
        tkw.update(block_tables=bt, logical_len=Cl)
    jl, jc = JMD.verify_step(jp, jcfg, jnp.asarray(vt), jnp.asarray(pos),
                             jc, **jkw)
    tl, tc = TMD.verify_step(tp, tcfg, torch.from_numpy(vt),
                             torch.from_numpy(pos), tc, **tkw)
    jl = np.asarray(jl)
    assert tuple(tl.shape) == jl.shape == (B, K + 1, jcfg.vocab_size)
    rows = [0, 2] if masked else list(range(B))
    np.testing.assert_allclose(tl.numpy()[rows], jl[rows], rtol=0,
                               atol=_atol(jl))
    for n in ("k", "v"):
        t = tc[n] if mode == "dense" else tc[n][:, :Np]
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[n]), rtol=0,
                                   atol=_atol(np.asarray(jc[n])))


@pytest.mark.parametrize("mode", MODES)
def test_verify_step_matches_sequential_decode(mode):
    """One verify pass == S sequential decode_step calls at positions
    pos+i: the same logits (fp32 tolerance) and the same argmax."""
    jcfg, tcfg = TP.configs(use_paged_kernel=mode == "paged_kernel_flag")
    _, tp = TP.params(jcfg)
    toks, pos, vt = _verify_inputs(tcfg.vocab_size, seed=2)
    dense, paged, bt, Cl, _ = _setup(tp, tcfg, toks)
    kw = {} if mode == "dense" else dict(block_tables=bt, logical_len=Cl)
    cache = dense if mode == "dense" else paged
    seq_cache = {n: t.clone() for n, t in cache.items()}
    vl, cache = TMD.verify_step(tp, tcfg, torch.from_numpy(vt),
                                torch.from_numpy(pos), cache, **kw)
    p = torch.from_numpy(pos)
    seq = []
    for i in range(K + 1):
        lg, seq_cache = TMD.decode_step(
            tp, tcfg, torch.from_numpy(vt[:, i:i + 1]), p, seq_cache,
            active=torch.ones(B, dtype=torch.bool), **kw)
        seq.append(lg[:, 0])
        p = p + 1
    seq = torch.stack(seq, dim=1)
    torch.testing.assert_close(vl, seq, rtol=0, atol=_atol(seq.numpy()))
    assert sharded_argmax(vl).tolist() == sharded_argmax(seq).tolist()
    for n in cache:
        torch.testing.assert_close(cache[n], seq_cache[n], rtol=0, atol=1e-5)


def test_verify_step_refuses_what_jax_refuses():
    jcfg, tcfg = TP.configs()
    _, tp = TP.params(jcfg)
    cache = TMD.init_cache(tcfg, 2, 16, "cpu")
    with pytest.raises(ValueError, match="per-row pos"):
        TMD.verify_step(tp, tcfg, torch.zeros((2, 2), dtype=torch.int32), 3,
                        cache)
    hcfg = torch_get_config("zamba2-1.2b", smoke=True)
    with pytest.raises(ValueError, match="unsupported arch_type hybrid"):
        TMD.verify_step({}, hcfg, torch.zeros((2, 2), dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), {})
    swa = tcfg.with_(attention_kind="sliding_window", sliding_window=8)
    with pytest.raises(ValueError, match="sliding-window"):
        TMD.verify_step(tp, swa, torch.zeros((2, 2), dtype=torch.int32),
                        torch.zeros(2, dtype=torch.int32), cache)


# ---------------------------------------------------------------------------
# the engine: tests/test_speculative.py's cases, against both packages
# ---------------------------------------------------------------------------
def _stream(vocab, n=6, seed=0, plens=(5, 8), gens=(4, 9)):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, size=int(rng.choice(plens))),
             int(rng.choice(gens))) for i in range(n)]


def _treqs(reqs, eos=None):
    return [Request(rid=i, prompt=p.copy(), max_new_tokens=g, eos_id=eos)
            for i, p, g in reqs]


def _jreqs(reqs, eos=None):
    return [JRequest(rid=i, prompt=p.copy(), max_new_tokens=g, eos_id=eos)
            for i, p, g in reqs]


def _plain(tp, tcfg, reqs, cache_len=28, eos=None):
    eng = ServeEngine(tp, tcfg, num_slots=2, cache_len=cache_len,
                      device="cpu")
    return {f.rid: f.tokens for f in eng.run(_treqs(reqs, eos))}


SPEC_STATS = ("ticks", "decode_ticks", "prefill_ticks", "prefill_tokens",
              "generated_tokens", "spec_rounds", "spec_proposed",
              "spec_accepted", "accept_rate", "tokens_per_round")


def _check_spec(jp, tp, jcfg, tcfg, reqs, *, jdraft=None, tdraft=None,
                eos=None, **kw):
    """The port's and JAX's spec engines on the same requests: each
    stream equal to the other and to the port's plain engine; the
    scheduling and speculation counters equal.  Returns the port's
    finished requests and stats."""
    ref = _plain(tp, tcfg, reqs, eos=eos)
    jeng = JSpec(jp, jcfg, num_slots=2, cache_len=28, spec_k=K,
                 draft=jdraft, **kw)
    jfin = {f.rid: f for f in jeng.run(_jreqs(reqs, eos))}
    teng = SpecDecodeEngine(tp, tcfg, num_slots=2, cache_len=28, spec_k=K,
                            draft=tdraft, device="cpu", **kw)
    tfin = teng.run(_treqs(reqs, eos))
    assert [f.rid for f in tfin] == sorted(jfin) == sorted(ref)
    for f in tfin:
        assert f.tokens == ref[f.rid], f"rid {f.rid}: vs the plain engine"
        assert f.tokens == jfin[f.rid].tokens, f"rid {f.rid}: vs JAX"
        assert f.finish_reason == jfin[f.rid].finish_reason
    jst, tst = jeng.stats(), teng.stats()
    for key in SPEC_STATS + (("pool_occupancy",) if "page_size" in kw
                             else ()):
        assert tst[key] == pytest.approx(jst[key]), key
    return tfin, tst


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = TP.configs()
    return (*TP.params(jcfg), jcfg, tcfg)


def test_lookup_spec_matches_plain(qwen):
    jp, tp, jcfg, tcfg = qwen
    fins, st = _check_spec(jp, tp, jcfg, tcfg, _stream(jcfg.vocab_size))
    assert len(fins) == 6
    assert st["spec_rounds"] > 0 and 0.0 <= st["accept_rate"] <= 1.0
    assert st["generated_tokens"] >= st["spec_rounds"]


def test_lookup_spec_paged_matches_plain(qwen):
    """Speculation over the paged pool: verify reads and writes KV through
    block tables and the stream is unchanged."""
    jp, tp, jcfg, tcfg = qwen
    _, st = _check_spec(jp, tp, jcfg, tcfg, _stream(jcfg.vocab_size, seed=2),
                        page_size=P)
    assert st["spec_rounds"] > 0 and st["pool_occupancy"] > 0.0


def test_lookup_spec_paged_kernel_flag_matches_plain(qwen):
    """With use_paged_kernel the verify pass reads through the kernel
    wrapper (its plain version on the CPU): the same streams."""
    jp, tp, jcfg, _ = qwen
    _, tcfg = TP.configs(use_paged_kernel=True)
    _check_spec(jp, tp, jcfg, tcfg, _stream(jcfg.vocab_size, seed=4),
                page_size=P)


def test_model_draft_cross_model_matches_plain():
    """The zoo pairing: qwen3-0.6b drafts for qwen3-1.7b.  Only the
    draft's proposals reach the target, so the target stream is the one
    plain decode gives."""
    jt = jax_get_config("qwen3-1.7b", smoke=True)
    tt = torch_get_config("qwen3-1.7b", smoke=True)
    jd, td = TP.configs()
    jtp, ttp = TP.params(jt, seed=0)
    jdp, tdp = TP.params(jd, seed=1)
    _, st = _check_spec(jtp, ttp, jt, tt, _stream(jt.vocab_size, n=4, seed=3),
                        jdraft=JModelDraft(jdp, jd), tdraft=ModelDraft(tdp, td))
    assert st["spec_rounds"] > 0 and 0.0 <= st["accept_rate"] <= 1.0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_self_draft_accepts_everything(qwen, paged):
    """A draft that is the target agrees with every proposal: accept rate
    exactly 1.0, and each request of budget 1 + 2(k+1) retires in 2
    rounds; on the second round the draft attends the KV its first scan
    wrote for its own k-th proposal."""
    jp, tp, jcfg, tcfg = qwen
    reqs = [(i, np.full(6, i + 3, np.int32), 9) for i in range(2)]
    kw = {"page_size": P} if paged else {}
    _, st = _check_spec(jp, tp, jcfg, tcfg, reqs,
                        jdraft=JModelDraft(jp, jcfg),
                        tdraft=ModelDraft(tp, tcfg), **kw)
    assert st["accept_rate"] == pytest.approx(1.0)
    assert st["spec_rounds"] == 2
    assert st["spec_full_accepts"] == 4        # 2 slots x 2 rounds
    assert st["tokens_per_round"] == pytest.approx(9.0)


def test_spec_eos_early_stop_matches_plain(qwen):
    """EOS inside an accepted block cuts the emission at the EOS token, as
    sequential decode does."""
    jp, tp, jcfg, tcfg = qwen
    prompt = np.random.RandomState(5).randint(0, jcfg.vocab_size, size=7)
    base = _plain(tp, tcfg, [(0, prompt, 10)])[0]
    eos = base[3]                 # stop mid-stream, inside a spec block
    fins, _ = _check_spec(jp, tp, jcfg, tcfg, [(0, prompt, 10)], eos=eos)
    assert fins[0].finish_reason == "eos"
    assert fins[0].tokens == base[:4]


def test_spec_drain_migrate_readmit_identity(qwen):
    """Drain a paged spec engine mid-stream and re-admit the harvested
    pages on a second one: the stitched streams are the uninterrupted
    run's, the port's and JAX's alike."""
    jp, tp, jcfg, tcfg = qwen
    reqs = _stream(jcfg.vocab_size, n=4, seed=7, plens=(6,), gens=(10,))

    def mk():
        return SpecDecodeEngine(tp, tcfg, num_slots=2, cache_len=28,
                                spec_k=K, page_size=P, device="cpu")

    ref = {f.rid: f.tokens for f in mk().run(_treqs(reqs))}
    assert ref == _plain(tp, tcfg, reqs)
    jref = {f.rid: f.tokens for f in JSpec(
        jp, jcfg, num_slots=2, cache_len=28, spec_k=K, page_size=P
    ).run(_jreqs(reqs))}
    assert ref == jref
    a = mk()
    for q in _treqs(reqs):
        a.submit(q)
    for _ in range(3):
        a.tick()
    drained = a.drain()
    assert any(d.kv is not None for d in drained)
    policy = ServingDrainReadmit()
    conts = policy.readmit(drained)
    b = mk()
    out = {f.rid: f.tokens for f in a.finished}
    for f in b.run(conts):
        s = policy.stitch(f)
        out[s.rid] = s.tokens
    assert out == ref
    assert b.migrated_admits == sum(d.kv is not None for d in drained) >= 1


# ---------------------------------------------------------------------------
# the lookup draft itself
# ---------------------------------------------------------------------------
def test_lookup_draft_ngram_extension():
    d = LookupDraft(max_n=3)
    ctx = [1, 7, 8, 9, 2, 7, 8, 9, 5, 7, 8]
    # (7,8) -> 9, then the most recent earlier occurrence of the rolling
    # suffix wins: (7,8,9) last followed 5, then (8,9,5) -> 7
    assert d.propose(ctx, 3) == [9, 5, 7]
    assert d.propose([4], 2) == [4, 4]        # no history: repeat-last


def test_lookup_propose_matches_jax():
    """The port's LookupDraft proposes what JAX's does, on seeded random
    contexts over small vocabularies (so that n-grams repeat)."""
    rng = np.random.RandomState(11)
    for _ in range(200):
        max_n = int(rng.randint(1, 5))
        k = int(rng.randint(1, 6))
        ctx = rng.randint(0, int(rng.randint(2, 9)),
                          size=int(rng.randint(1, 40))).tolist()
        want = JLookup(max_n).propose(ctx, k)
        assert LookupDraft(max_n).propose(np.asarray(ctx, np.int32),
                                          k) == want, (ctx, k, max_n)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_spec_rejects_recurrent_arch():
    cfg = torch_get_config("zamba2-1.2b", smoke=True)
    params = TMD.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pure-attention"):
        SpecDecodeEngine(params, cfg, num_slots=2, cache_len=24,
                         device="cpu")


def test_spec_rejects_bad_k(qwen):
    _, tp, _, tcfg = qwen
    with pytest.raises(ValueError, match="spec_k"):
        SpecDecodeEngine(tp, tcfg, num_slots=2, cache_len=24, spec_k=0,
                         device="cpu")


def test_spec_rejects_vocab_mismatch(qwen):
    _, tp, _, tcfg = qwen
    dcfg = tcfg.with_(vocab_size=tcfg.vocab_size // 2)
    dparams = TMD.init_model(dcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="vocab"):
        SpecDecodeEngine(tp, tcfg, num_slots=2, cache_len=24,
                         draft=ModelDraft(dparams, dcfg), device="cpu")


def test_spec_reserves_verify_headroom(qwen):
    """submit() reserves spec_k cache positions past the budget: verify
    writes KV at pos..pos+spec_k even on a one-token emission."""
    _, tp, _, tcfg = qwen
    eng = SpecDecodeEngine(tp, tcfg, num_slots=1, cache_len=16, spec_k=3,
                           device="cpu")
    eng.submit(Request(rid=0, prompt=np.zeros(6, np.int32),
                       max_new_tokens=7))        # 6 + 7 = 13 <= 16 - 3
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.submit(Request(rid=1, prompt=np.zeros(6, np.int32),
                           max_new_tokens=8))    # 14 > 13


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,draft", [
    ("qwen3-0.6b", []), ("qwen3-1.7b", ["--draft-arch", "qwen3-0.6b"])],
    ids=["lookup", "model_draft"])
def test_serve_launcher_speculative_on_cpu(arch, draft):
    """--speculative, with the lookup draft and with a model draft: the
    streams of the run without it, and the spec counters reported."""
    from repro_torch.launch.serve import serve
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--continuous",
            "--paged", "--page-size", "4", "--batch", "2",
            "--prompt-len", "12", "--gen", "8", "--requests", "4"]
    plain = serve(base)
    spec = serve(base + ["--speculative", "--spec-k", "3"] + draft)
    assert ([f.tokens for f in spec["finished"]]
            == [f.tokens for f in plain["finished"]])
    st = spec["stats"]
    assert st["spec_rounds"] == st["decode_ticks"] > 0
    assert st["generated_tokens"] == plain["stats"]["generated_tokens"]
