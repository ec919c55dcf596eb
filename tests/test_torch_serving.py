"""Port parity for the continuous-batching engine: the port's ServeEngine
reproduces the JAX ServeEngine's greedy token streams exactly — dense,
paged, and paged with a tight pool that forces preemption — with the same
scheduling counters, on the streams of tests/test_serving.py (qwen3-0.6b
and zamba2-1.2b SMOKE, fp32, the same weights).  Every compared token is checked to win
its argmax by more than the cross-package tolerance, so a mismatch means a
fault, not a tie."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch.launch.steps import sharded_argmax  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

GAP = 1e-3  # top-2 logit gap a compared token must win by (fp32 parity 1e-4)


def _stream(seed, n, plens, gens, vocab):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, size=int(rng.choice(plens))),
             int(rng.choice(gens))) for i in range(n)]


# the streams of tests/test_serving.py (2 prompt lengths, then 1)
STREAMS = {
    "single": dict(seed=0, n=5, plens=[6, 10], gens=[3, 6]),
    "mixed": dict(seed=4, n=7, plens=[5, 9], gens=[3, 7]),
    "tight": dict(seed=5, n=6, plens=[8], gens=[10]),
}
CASES = [
    # stream, engine kwargs
    ("mixed", dict(num_slots=3, cache_len=20)),
    ("mixed", dict(num_slots=3, cache_len=20, page_size=4)),
    ("tight", dict(num_slots=3, cache_len=20, page_size=4, num_pages=9)),
]
HYBRID_CASES = [
    # tests/test_serving.py's hybrid streams: engine vs single requests
    # (dense), and paged vs dense; then a pool tight enough to preempt
    ("single", dict(num_slots=2, cache_len=20)),
    ("mixed", dict(num_slots=3, cache_len=20)),
    ("mixed", dict(num_slots=3, cache_len=20, page_size=4)),
    ("tight", dict(num_slots=3, cache_len=20, page_size=4, num_pages=9)),
]


def _greedy_with_gaps(tp, tcfg, prompt, gen, cache_len):
    """One request alone through the port (prefill + scalar-pos decode):
    its greedy tokens and the smallest top-2 logit gap along the way."""
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
    logits, _, cache = TMD.forward(tp, tcfg, toks, return_cache=True,
                                   cache_len=cache_len)
    out, gaps, pos = [], [], toks.shape[1]
    for _ in range(gen):
        last = logits[:, -1]
        top2 = last.topk(2, dim=-1).values[0]
        gaps.append(float(top2[0] - top2[1]))
        nxt = sharded_argmax(last)[:, None]
        out.append(int(nxt[0, 0]))
        if len(out) == gen:
            break
        logits, cache = TMD.decode_step(tp, tcfg, nxt, pos, cache)
        pos += 1
    return out, min(gaps)


@pytest.mark.parametrize("stream,kw", CASES,
                         ids=["dense", "paged", "paged_tight_pool"])
def test_engine_matches_jax_engine(stream, kw):
    _check_engine_parity(*TP.configs(), stream, kw)


@pytest.mark.parametrize("stream,kw", HYBRID_CASES,
                         ids=["dense_single", "dense", "paged",
                              "paged_tight_pool"])
def test_hybrid_engine_matches_jax_engine(stream, kw):
    """zamba2-1.2b SMOKE: SSM state and conv rings per slot, the shared
    block's K/V dense or paged; prompts shorter than ssm_chunk."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config as torch_get_config
    _check_engine_parity(jax_get_config("zamba2-1.2b", smoke=True),
                         torch_get_config("zamba2-1.2b", smoke=True),
                         stream, kw)


def _check_engine_parity(jcfg, tcfg, stream, kw):
    jp, tp = TP.params(jcfg)
    reqs = _stream(vocab=jcfg.vocab_size, **STREAMS[stream])
    jeng = JEngine(jp, jcfg, **kw)
    jfin = {f.rid: f for f in jeng.run(
        [JRequest(rid=i, prompt=p, max_new_tokens=g) for i, p, g in reqs])}
    teng = ServeEngine(tp, tcfg, device="cpu", **kw)
    tfin = teng.run([Request(rid=i, prompt=p, max_new_tokens=g)
                     for i, p, g in reqs])
    assert [f.rid for f in tfin] == sorted(jfin)
    for f in tfin:
        j = jfin[f.rid]
        assert f.tokens == j.tokens, f"rid {f.rid}"
        assert (f.finish_reason, f.admitted_tick, f.finished_tick) == (
            j.finish_reason, j.admitted_tick, j.finished_tick)
    for i, p, g in reqs:
        ref, gap = _greedy_with_gaps(tp, tcfg, p, g, kw["cache_len"])
        assert ref == jfin[i].tokens
        assert gap > GAP, f"rid {i}: top-2 gap {gap} too close to call"
    jst, tst = jeng.stats(), teng.stats()
    for key in ("ticks", "decode_ticks", "prefill_ticks", "prefill_tokens",
                "occupancy", "generated_tokens"):
        assert tst[key] == jst[key], key
    if "page_size" in kw:
        for key in ("preemptions", "pool_occupancy", "num_pages"):
            assert tst[key] == jst[key], key
    if stream == "tight":
        assert tst["preemptions"] >= 1


def test_engine_eos_evicts_early():
    """A request whose 2nd token is its EOS frees its slot early; the rest
    finish by length with the single-request tokens."""
    _, tcfg = TP.configs()
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, tcfg.vocab_size, size=8) for _ in range(4)]
    ref0, _ = _greedy_with_gaps(tp, tcfg, prompts[0], 8, 24)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8,
                    eos_id=ref0[1] if i == 0 else None)
            for i, p in enumerate(prompts)]
    fins = ServeEngine(tp, tcfg, num_slots=2, cache_len=24, page_size=4,
                       device="cpu").run(reqs)
    assert fins[0].finish_reason == "eos" and fins[0].tokens == ref0[:2]
    for f, p in zip(fins[1:], prompts[1:]):
        assert f.finish_reason == "length"
        assert f.tokens == _greedy_with_gaps(tp, tcfg, p, 8, 24)[0]


def test_engine_cancel_frees_slot_and_pages():
    _, tcfg = TP.configs()
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(2))
    rng = np.random.RandomState(6)
    reqs = [Request(rid=i, prompt=rng.randint(0, tcfg.vocab_size, size=6),
                    max_new_tokens=8) for i in range(4)]
    eng = ServeEngine(tp, tcfg, num_slots=2, cache_len=16, page_size=4,
                      device="cpu")
    for r in reqs:
        eng.submit(r)
    for _ in range(3):          # rid 0,1 active; 2,3 queued
        eng.tick()
    assert eng.cancel(1) and eng.cancel(3) and not eng.cancel(99)
    while not eng.scheduler.done:
        eng.tick()
    assert {f.rid for f in eng.finished} == {0, 2}
    assert eng.pages.num_free == eng.num_pages


def test_engine_rejects_bad_sizes():
    _, tcfg = TP.configs()
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(tp, tcfg, num_slots=1, cache_len=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.submit(Request(rid=0, prompt=np.zeros(6, np.int32),
                           max_new_tokens=4))
    with pytest.raises(ValueError, match="num_pages"):
        ServeEngine(tp, tcfg, num_slots=2, cache_len=20, page_size=4,
                    num_pages=4, device="cpu")


def test_sharded_argmax_first_max_on_ties():
    """Ties resolve to the first max index, as the JAX version does (bf16
    logits over a large vocab do tie)."""
    from repro.launch.steps import sharded_argmax as jax_argmax
    x = np.asarray([[1.0, 3.0, 3.0, 2.0], [5.0, 0.0, 5.0, 5.0],
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
    for dt in (torch.float32, torch.bfloat16):
        got = sharded_argmax(torch.from_numpy(x).to(dt))
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(jax_argmax(x)).tolist() == [1, 0, 0]


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cb_steps_match_jax(paged):
    """Two continuous-batching ticks through the step builders, one slot
    retired: the same tokens as the JAX builders, and the retired slot's
    token passes through."""
    import jax.numpy as jnp
    from repro.launch import steps as JS
    from repro_torch.launch import steps as TS
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    B, S, P = 3, 6, 4
    C = 12
    rng = np.random.RandomState(8)
    toks = rng.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = JS.make_prefill_step(jcfg, C)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TS.make_prefill_step(tcfg, C)(tp, {"tokens":
                                                torch.from_numpy(toks)})
    nxt = np.array(JS.sharded_argmax(jl[:, -1]))[:, None]
    assert sharded_argmax(tl[:, -1])[:, None].tolist() == nxt.tolist()
    active = np.asarray([True, False, True])
    pos = np.full((B,), S, np.int32)
    if paged:
        bt = np.arange(B * (C // P), dtype=np.int32).reshape(B, C // P)
        # slot b's cache row is pages b*C/P .. (b+1)*C/P-1, in order
        jpool = {n: c.reshape(c.shape[0], B * (C // P), P, *c.shape[3:])
                 for n, c in jc.items()}
        tpool = TMD.init_paged_cache(tcfg, B, B * (C // P), P, "cpu")
        for n in tpool:
            tpool[n][:, :-1] = torch.from_numpy(np.array(jpool[n]))
        jstep = JS.make_paged_serve_cb_step(jcfg, C)
        tstep = TS.make_paged_serve_cb_step(tcfg, C)
        jargs, targs = (jnp.asarray(bt),), (torch.from_numpy(bt),)
        jc, tc = jpool, tpool
    else:
        jstep, tstep = JS.make_serve_cb_step(jcfg), TS.make_serve_cb_step(tcfg)
        jargs = targs = ()
    jt, tt = jnp.asarray(nxt), torch.from_numpy(nxt)
    for _ in range(2):
        jt, jc = jstep(jp, jc, jt, jnp.asarray(pos), jnp.asarray(active),
                       *jargs)
        tt, tc = tstep(tp, tc, tt, torch.from_numpy(pos),
                       torch.from_numpy(active), *targs)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert tt[1, 0] == int(nxt[1, 0])
        pos = pos + active


def test_static_serve_fns_match_jax():
    """The static path's (prefill, decode) pair: the same greedy tokens as
    the JAX launcher's on the same weights and prompts."""
    import jax.numpy as jnp
    from repro.launch.serve import make_static_fns as jax_static
    from repro_torch.launch.serve import make_static_fns
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    B, S, G = 2, 7, 4
    toks = np.random.RandomState(9).randint(0, jcfg.vocab_size, size=(B, S))
    jpre, jdec = jax_static(jcfg, S + G)
    tpre, tdec = make_static_fns(tcfg, S + G)
    jt, jc = jpre(jp, jnp.asarray(toks, jnp.int32))
    tt, tc = tpre(tp, torch.from_numpy(toks))
    for i in range(G - 1):
        assert tt.tolist() == np.asarray(jt).tolist()
        jt, jc = jdec(jp, jt, jnp.int32(S + i), jc)
        tt, tc = tdec(tp, tt, S + i, tc)
    assert tt.tolist() == np.asarray(jt).tolist()


@pytest.mark.parametrize("mode", [[], ["--continuous"],
                                  ["--continuous", "--paged",
                                   "--page-size", "4"]],
                         ids=["static", "continuous", "paged"])
def test_serve_launcher_on_cpu(mode):
    from repro_torch.launch.serve import serve
    out = serve(["--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4", "--requests", "3",
                 *mode])
    if not mode:
        assert out["generated"].shape == (2, 4)
        return
    fins = out["finished"]
    assert [f.rid for f in fins] == [0, 1, 2]
    assert out["stats"]["generated_tokens"] == sum(len(f.tokens)
                                                   for f in fins)
    if "--paged" in mode:
        assert out["stats"]["num_pages"] == 2 * 3


@pytest.mark.parametrize("mode", [[], ["--continuous", "--paged",
                                       "--page-size", "4"]],
                         ids=["static", "paged"])
def test_serve_launcher_hybrid_on_cpu(mode):
    from repro_torch.launch.serve import serve
    out = serve(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "16", "--gen", "4",
                 "--requests", "3", *mode])
    if not mode:
        assert out["generated"].shape == (2, 4)
        return
    assert [f.rid for f in out["finished"]] == [0, 1, 2]
    assert out["stats"]["preemptions"] == 0


@pytest.mark.parametrize("mode", [[], ["--continuous"]],
                         ids=["static", "continuous"])
def test_serve_launcher_refuses_partial_chunks(mode):
    """Prompts that are not a whole number of SMOKE's ssm_chunk (32): the
    JAX package asserts on them, the port's hybrid prefill scans a ragged
    last chunk, so the launcher serves them (40 tokens static; the
    continuous stream draws 32, 48 and 64)."""
    from repro_torch.launch.serve import serve
    out = serve(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--gen", "3", "--requests", "3",
                 "--prompt-len", "40" if not mode else "64", *mode])
    if not mode:
        assert out["generated"].shape == (2, 3)
        return
    fins = out["finished"]
    assert [f.rid for f in fins] == [0, 1, 2]
    assert all(f.finish_reason == "length" and f.tokens for f in fins)
    assert out["stats"]["generated_tokens"] == sum(len(f.tokens)
                                                   for f in fins)


def test_hybrid_tight_pool_readmits_ragged_prefills():
    """zamba2-1.2b SMOKE prompts of whole chunks (32 and 64 tokens) on a
    pool too small for every slot: preempted requests re-prefill
    prompt + emitted, a length off the chunk rule that JAX's prefill
    asserts on.  The port's greedy streams equal the JAX engine's on an
    ample pool, and each request's alone (every token winning its argmax
    by more than GAP)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config as torch_get_config
    jcfg = jax_get_config("zamba2-1.2b", smoke=True)
    tcfg = torch_get_config("zamba2-1.2b", smoke=True)
    jp, tp = TP.params(jcfg)
    reqs = _stream(seed=8, n=5, plens=[32, 64], gens=[10, 14],
                   vocab=jcfg.vocab_size)
    kw = dict(num_slots=3, cache_len=80, page_size=8)
    jfin = {f.rid: f for f in JEngine(jp, jcfg, **kw).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=g) for i, p, g in reqs])}
    teng = ServeEngine(tp, tcfg, device="cpu", num_pages=10, **kw)
    lens = []
    admit = teng.program.admit

    def recording(params, prompt, *a, **k):
        lens.append(int(prompt.shape[1]))
        return admit(params, prompt, *a, **k)
    teng.program.admit = recording
    tfin = teng.run([Request(rid=i, prompt=p, max_new_tokens=g)
                     for i, p, g in reqs])
    assert teng.stats()["preemptions"] >= 1
    assert any(n % tcfg.ssm_chunk for n in lens), lens
    assert [f.rid for f in tfin] == sorted(jfin)
    for f, (i, p, g) in zip(tfin, reqs):
        assert len(f.tokens) == g
        assert f.tokens == jfin[i].tokens, f"rid {i}"
        ref, gap = _greedy_with_gaps(tp, tcfg, p, g, kw["cache_len"])
        assert f.tokens == ref, f"rid {i}"
        assert gap > GAP, f"rid {i}: top-2 gap {gap} too close to call"
