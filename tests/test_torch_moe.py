"""Port parity for the MoE family (qwen3-moe-30b-a3b and arctic-480b SMOKE,
fp32, the JAX package's init_model weights carried over by the bridge):
the MoE layer's output, aux loss and dropped choices, forward logits and
aux, lm_loss and its gradient, decode_step and verify_step, and the
greedy streams of the paged ServeEngine, of SpecDecodeEngine with the
lookup draft and of the serve launcher -- each against the JAX package's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.models import mlp as TM  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

import test_torch_bridge as TP  # noqa: E402
import test_torch_serving as TS  # noqa: E402

MOE_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
NEW_ARCHS = ("deepseek-7b",) + MOE_ARCHS
# tests/test_moe.py's figures for the layer; the stack as the dense tests
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
ATOL = dict(rtol=1e-4, atol=1e-4)
B, S, C = 3, 8, 16


def configs(arch, **kw):
    return (jax_get_config(arch, smoke=True).with_(**kw),
            torch_get_config(arch, smoke=True).with_(**kw))


def _tokens(vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S + 4)
                                               ).astype(np.int32)


def test_full_width_param_counts():
    """The counts the card phase sizes its memory by."""
    from repro_torch.models.config import param_count
    assert param_count(torch_get_config("qwen3-moe-30b-a3b"))[0] \
        == 30_532_108_288
    arctic = torch_get_config("arctic-480b")
    assert abs(param_count(arctic)[0] - 476.9e9) < 0.1e9
    assert abs(param_count(arctic.with_(num_layers=2))[0] - 27.68e9) < 0.01e9


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
def _layer_inputs(cfg, shape, seed):
    from repro.models.common import init_params
    jp = init_params(JM.moe_descs(cfg), jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.RandomState(seed).randn(*shape, cfg.d_model).astype(
        np.float32)
    return jp, tp, x


def _oracle_drops(idx, C):
    """(group, token, choice) triples dropped by capacity C: the choices
    of each expert counted in (token, choice) order, a plain loop."""
    drops = set()
    for g in range(idx.shape[0]):
        seen = {}
        for t in range(idx.shape[1]):
            for j in range(idx.shape[2]):
                e = int(idx[g, t, j])
                if seen.get(e, 0) >= C:
                    drops.add((g, t, j))
                seen[e] = seen.get(e, 0) + 1
    return drops


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5], ids=["smoke_cf", "drops"])
@pytest.mark.parametrize("shape,groups", [((2, 16), None), ((2, 16), 1),
                                          ((5, 1), None)],
                         ids=["per_sequence", "one_group", "decode"])
def test_moe_layer_matches_jax(arch, cf, shape, groups):
    """y and aux against repro.models.mlp.moe; with capacity_factor 0.5
    choices drop, and the dropped (token, choice) set is the one a plain
    count over JAX's routing gives."""
    jcfg, tcfg = configs(arch)
    if cf is not None:
        jcfg, tcfg = jcfg.with_(capacity_factor=cf), tcfg.with_(
            capacity_factor=cf)
    jp, tp, x = _layer_inputs(jcfg, shape, seed=3)
    jy, jaux = JM.moe(jp, jnp.asarray(x), jcfg, groups=groups)
    recorded = []
    slots = TM.moe_slots

    def record(eidx, E, cap):
        rows, s2s = slots(eidx, E, cap)
        recorded.append((eidx, rows, cap))
        return rows, s2s
    TM.moe_slots = record
    try:
        ty, taux = TM.moe(tp, torch.from_numpy(x), tcfg, groups=groups)
    finally:
        TM.moe_slots = slots
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **LAYER_TOL)

    # JAX's routing (its own top_k over its own router probabilities)
    G = groups or (shape[0] if shape[1] > 1 else 1)
    xg = jnp.asarray(x).reshape(G, -1, jcfg.d_model)
    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", xg, jp["router"]), -1)
    jidx = np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])
    (eidx, rows, cap), = recorded
    assert np.array_equal(eidx.numpy().reshape(jidx.shape), jidx)
    E = jcfg.num_experts
    got = {tuple(int(v) for v in np.unravel_index(i, jidx.shape))
           for i in np.flatnonzero(rows.numpy().reshape(-1) == E * cap)}
    want = _oracle_drops(jidx, cap)
    assert got == want
    if cf == 0.5 and shape[1] > 1:
        assert want, "capacity 0.5 dropped nothing"


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                    [0.3, 0.2, 0.3, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = TM.top_k(torch.from_numpy(x), 3)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert tv.tolist() == np.asarray(jv).tolist()


def test_moe_slots_trash_row_only_repeats():
    """Kept choices own distinct slots below E*C; every dropped choice
    points at the trash slot E*C; slot_to_src inverts rows."""
    eidx = torch.tensor([[0, 1, 0, 0, 2, 0, 1, 0]])
    rows, s2s = TM.moe_slots(eidx, 3, 2)
    assert rows.tolist() == [[0, 2, 1, 6, 4, 6, 3, 6]]
    assert s2s[0, :6].tolist() == [0, 2, 1, 6, 4, 8]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_jax(arch):
    """Logits, the summed aux and the padded KV cache."""
    jcfg, tcfg = configs(arch)
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=0)[:, :S]
    jl, jaux, jc = JMD.forward(jp, jcfg, jnp.asarray(toks),
                               return_cache=True, cache_len=C)
    tl, taux, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks),
                               return_cache=True, cache_len=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), **LAYER_TOL)
    assert float(taux) > 0
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **ATOL)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("remat", ["none", "block"])
def test_lm_loss_and_grad_match_jax(arch, remat):
    """lm_loss (with 0.01 * aux) and its gradient against jax.grad, every
    leaf; under block remat the checkpointed layers still return aux."""
    jcfg, tcfg = configs(arch, remat=remat)
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=1)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    jloss, jgrad = jax.value_and_grad(JMD.lm_loss)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    for t in TP._flat(tp):
        t[1].requires_grad_(True)
    tloss = TMD.lm_loss(tp, tcfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **LAYER_TOL)
    # the aux term is in the loss: without it the losses differ
    with torch.no_grad():
        _, aux, _ = TMD.forward(tp, tcfg, torch.from_numpy(batch["tokens"]))
    assert float(aux) > 0
    jg = dict(_flat(jax.tree_util.tree_map(np.asarray, jgrad)))
    tg = dict(_flat(tp))
    assert sorted(jg) == sorted(tg)
    for name, g in jg.items():
        got = tg[name].grad
        assert got is not None, name
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=name)
    assert float(np.abs(jg["blocks/moe/router"]).max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_jax(arch):
    """Two per-row decode steps, one row retired: all B rows form one
    routing group, the retired one included, as in JAX."""
    jcfg, tcfg = configs(arch)
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=2)
    _, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                           return_cache=True, cache_len=C)
    _, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                           return_cache=True, cache_len=C)
    active = np.asarray([True, False, True])
    pos = np.full((B,), S, np.int32)
    for step in range(2):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jc,
                                 active=jnp.asarray(active))
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tc,
                                 active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **ATOL)
        pos = pos + active


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_step_matches_jax(arch, paged):
    """K+1 candidates a row (one routing group a row), dense cache or
    paged pool through the kernel wrapper's plain version."""
    import test_torch_speculative as SP
    jcfg, _ = configs(arch)
    _, tcfg = configs(arch, use_paged_kernel=paged)
    jp, tp = TP.params(jcfg)
    toks, pos, vt = SP._verify_inputs(jcfg.vocab_size, seed=5)
    dense, pool, bt, Cl, Np = SP._setup(tp, tcfg, toks)
    if paged:
        jc = {n: jnp.asarray(t[:, :Np].numpy()) for n, t in pool.items()}
        tc = pool
        jkw = dict(block_tables=jnp.asarray(bt.numpy()), logical_len=Cl)
        tkw = dict(block_tables=bt, logical_len=Cl)
    else:
        jc = {n: jnp.asarray(t.numpy()) for n, t in dense.items()}
        tc, jkw, tkw = dense, {}, {}
    jl, jc = JMD.verify_step(jp, jcfg, jnp.asarray(vt), jnp.asarray(pos),
                             jc, **jkw)
    tl, tc = TMD.verify_step(tp, tcfg, torch.from_numpy(vt),
                             torch.from_numpy(pos), tc, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    for n in ("k", "v"):
        t = tc[n][:, :Np] if paged else tc[n]
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[n]), **ATOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
# arctic SMOKE's "mixed" stream holds a near-tie (a top-2 gap of 7.6e-5,
# on which the two engines agree, but too close for the gap rule): arctic
# runs the pool tight enough to preempt instead
ENGINE_CASES = [("qwen3-moe-30b-a3b", "mixed", None),
                ("arctic-480b", "tight", 9)]


@pytest.mark.parametrize("arch,stream,num_pages", ENGINE_CASES,
                         ids=["qwen3_moe", "arctic_tight_pool"])
@pytest.mark.parametrize("kernel_flag", [False, True],
                         ids=["gather", "paged_kernel_flag"])
def test_paged_engine_matches_jax_engine(arch, stream, num_pages,
                                         kernel_flag):
    """The paged ServeEngine's greedy streams and counters equal the JAX
    engine's, and each request's alone (every token winning its argmax by
    more than the cross-package tolerance)."""
    jcfg, _ = configs(arch)
    _, tcfg = configs(arch, use_paged_kernel=kernel_flag)
    TS._check_engine_parity(jcfg, tcfg, stream,
                            dict(num_slots=3, cache_len=20, page_size=4,
                                 num_pages=num_pages))


def test_paged_engine_tight_pool_matches_jax_engine():
    """qwen3-moe on a pool that forces preemption: the same streams."""
    TS._check_engine_parity(*configs("qwen3-moe-30b-a3b"), "tight",
                            dict(num_slots=3, cache_len=20, page_size=4,
                                 num_pages=9))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_lookup_spec_matches_jax(paged):
    """SpecDecodeEngine with the lookup draft on qwen3-moe SMOKE: each
    stream equal to JAX's spec engine's and to the port's plain engine,
    the speculation counters equal."""
    import test_torch_speculative as SP
    jcfg, tcfg = configs("qwen3-moe-30b-a3b")
    jp, tp = TP.params(jcfg)
    kw = {"page_size": SP.P} if paged else {}
    fins, st = SP._check_spec(jp, tp, jcfg, tcfg,
                              SP._stream(jcfg.vocab_size, seed=6), **kw)
    assert st["spec_rounds"] > 0 and len(fins) == 6


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_launcher_matches_jax_launcher(arch, monkeypatch, capsys):
    """`repro_torch.launch.serve --continuous --paged` against the JAX
    launcher with the same flags, the port fed the JAX launcher's weights
    (the packages draw weights from different generators): the same
    streams, and the same 'sample generation' line."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    flags = ["--arch", arch, "--smoke", "--continuous", "--paged",
             "--page-size", "4", "--requests", "4", "--batch", "2",
             "--prompt-len", "16", "--gen", "6"]
    jout = jax_serve(flags)
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("sample generation")]
    jcfg = jax_get_config(arch, smoke=True).with_(
        param_dtype="float32", compute_dtype="float32")
    jp = jax.jit(lambda k: JMD.init_model(jcfg, k))(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    monkeypatch.setattr(TMD, "init_model", lambda cfg, gen: tp)
    tout = serve(flags + ["--device", "cpu"])
    tline = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("sample generation")]
    assert tline == jline and len(tline) == 1
    assert ([f.tokens for f in tout["finished"]]
            == [f.tokens for f in jout["finished"]])


@pytest.mark.parametrize("arch", ["arctic-480b", "zamba2-1.2b"])
def test_params_from_numpy_keeps_the_router_fp32(arch):
    """A bf16 cast gives every leaf the dtype the port's descriptors give
    it in a bf16 model: the fp32 router (and the hybrid's fp32 SSM
    scalars) stay fp32, with their values exact; every other leaf is
    cast.  FP32_LEAVES names exactly the leaves any registered config
    pins to fp32."""
    from repro_torch.bridge import FP32_LEAVES
    from repro_torch.configs import ARCH_IDS
    pinned = set()
    for a in ARCH_IDS:
        descs = TMD.model_descs(torch_get_config(a).with_(
            param_dtype="bfloat16"))
        for name, d in _flat(descs):
            key = name.rsplit("/", 1)[-1]
            assert (d.dtype == "float32") == (key in FP32_LEAVES), (a, name)
            if d.dtype == "float32":
                pinned.add(key)
    assert pinned == FP32_LEAVES
    jcfg, tcfg = (jax_get_config(arch, smoke=True),
                  torch_get_config(arch, smoke=True))
    tree = jax.tree_util.tree_map(
        np.asarray, JMD.init_model(jcfg, jax.random.PRNGKey(0)))
    t = params_from_numpy(tree, "cpu", torch.bfloat16)
    descs = dict(_flat(TMD.model_descs(tcfg.with_(param_dtype="bfloat16"))))
    flat = dict(_flat(t))
    assert set(flat) == set(descs)
    for name, leaf in flat.items():
        assert leaf.dtype == getattr(torch, descs[name].dtype), name
        if leaf.dtype == torch.float32:
            want = dict(_flat(tree))[name]
            np.testing.assert_array_equal(leaf.numpy(), want)


def test_init_model_router_is_fp32_in_a_bf16_model():
    tcfg = torch_get_config("qwen3-moe-30b-a3b", smoke=True).with_(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["w1"].dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, seed=7))
    logits, aux, _ = TMD.forward(tp, tcfg, toks)
    assert logits.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(logits.float()).all())
