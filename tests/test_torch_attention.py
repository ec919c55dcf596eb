"""Port parity for the attention leftovers and the shape plan: the
sliding-window ring cache (decode step by step against the JAX package's
and against the windowed forward), its window-clamped cache specs, the
q-chunked path, the input shapes and `shape_plan` of every arch, and the
engine's refusal of a sliding-window config (the JAX engine fails on one
with a broadcasting error)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402

ATOL = dict(rtol=1e-4, atol=1e-4)
WINDOW = 16
# tests/test_sliding_window.py's config
KW = dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=4, d_ff=256,
          vocab_size=512, param_dtype="float32", compute_dtype="float32",
          remat="none", attention_kind="sliding_window",
          sliding_window=WINDOW)
_CACHE = {}


def _swa():
    """(jax cfg, port cfg, jax params, port params), built once."""
    if "swa" not in _CACHE:
        jcfg, tcfg = JConfig(**KW), TConfig(**KW)
        jp = JMD.init_model(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE["swa"] = (jcfg, tcfg, jp, tp)
    return _CACHE["swa"]


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("per_row", [False, True])
def test_ring_cache_decode_matches_jax_and_windowed_forward(per_row):
    """The ring (capacity = window) built from a prefill as the reference
    test builds it, then greedy positions S..S+T-1 crossing the window
    boundary repeatedly: every step's logits and ring equal JAX's
    decode_step, and the logits the windowed forward's at that position;
    with per-row positions, row 1 retired after the first step keeps its
    ring bit for bit."""
    jcfg, tcfg, jp, tp = _swa()
    B, S, T = 2, 24, 12
    toks = np.random.RandomState(1).randint(0, 512, size=(B, S + T)).astype(
        np.int32)
    full, _, _ = TMD.forward(tp, tcfg, torch.from_numpy(toks))
    jfull, _, _ = JMD.forward(jp, jcfg, jnp.asarray(toks))
    np.testing.assert_allclose(full.numpy(), _np(jfull), **ATOL)
    _, _, cache = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                              return_cache=True, cache_len=S)
    ring = TMD.init_cache(tcfg, B, S, "cpu")
    assert ring["k"].shape[2] == WINDOW
    for pos in range(S - WINDOW, S):
        for n in ring:
            ring[n][:, :, pos % WINDOW] = cache[n][:, :, pos]
    jring = {n: jnp.asarray(t.numpy()) for n, t in ring.items()}
    pos = np.full((B,), S, np.int32)
    act = np.ones(B, bool)
    for t in range(T):
        tok = toks[:, S + t:S + t + 1]
        if per_row:
            kw_t = dict(active=torch.from_numpy(act.copy()))
            held = ring["k"][:, 1].clone()
            tl, ring = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                       torch.from_numpy(pos), ring, **kw_t)
            jl, jring = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                        jnp.asarray(pos), jring,
                                        active=jnp.asarray(act))
            if not act[1]:
                assert torch.equal(ring["k"][:, 1], held)
        else:
            tl, ring = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                       int(pos[0]), ring)
            jl, jring = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                        jnp.int32(pos[0]), jring)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
        for n in ring:
            np.testing.assert_allclose(ring[n].numpy(), _np(jring[n]),
                                       **ATOL)
        live = act if per_row else np.ones(B, bool)
        np.testing.assert_allclose(tl[live, 0].numpy(),
                                   full[live, S + t].numpy(), **ATOL)
        pos = pos + act
        if per_row:
            act = np.array([True, False])


def test_cache_specs_clamped_to_window():
    jcfg, tcfg, _, _ = _swa()
    for C in (8, 1000):
        tk = TMD.cache_specs(tcfg, batch=2, cache_len=C)["k"][0]
        jk = JMD.cache_specs(jcfg, batch=2, cache_len=C)["k"].shape
        assert tk == jk == (2, 2, min(C, WINDOW), 4, 16)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_gqa_chunked_matches_jax(causal, window):
    """attn_q_chunk 8 over 20 queries (a short last block) against JAX's
    lax.map path, and against the flat softmax at S == T."""
    cfg_kw = dict(num_heads=4, num_kv_heads=2, head_dim=32, attn_q_chunk=8)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    r = np.random.RandomState(3)
    q = r.randn(2, 20, 4, 32).astype(np.float32)
    k, v = (r.randn(2, 20, 2, 32).astype(np.float32) for _ in range(2))
    jo = JA.gqa_attend(*map(jnp.asarray, (q, k, v)), jcfg, causal=causal,
                       window=window)
    to = TA.gqa_attend(*map(torch.from_numpy, (q, k, v)), tcfg,
                       causal=causal, window=window)
    np.testing.assert_allclose(to.numpy(), _np(jo), **ATOL)
    flat = TA.gqa_attend(*map(torch.from_numpy, (q, k, v)),
                         tcfg.with_(attn_q_chunk=0), causal=causal,
                         window=window)
    np.testing.assert_allclose(to.numpy(), flat.numpy(), **ATOL)


def test_forward_with_q_chunks_matches_jax():
    jcfg, tcfg, jp, tp = _swa()
    jcfg, tcfg = (c.with_(attn_q_chunk=8) for c in (jcfg, tcfg))
    toks = np.random.RandomState(4).randint(0, 512, size=(1, 30)).astype(
        np.int32)
    jl, _, _ = JMD.forward(jp, jcfg, jnp.asarray(toks))
    tl, _, _ = TMD.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)


def test_shapes_and_shape_plan_match_jax():
    """SHAPES field by field, and shape_plan for every arch and shape: the
    same config (the -swa variant at long_500k for the attention archs,
    None for whisper-tiny there)."""
    assert list(TC.SHAPES) == list(JC.SHAPES)
    for name, s in TC.SHAPES.items():
        assert s.__dict__ == JC.SHAPES[name].__dict__
    assert TC.ARCH_IDS == JC.ARCH_IDS
    for arch in TC.ARCH_IDS:
        for shape in TC.SHAPES:
            t, j = TC.shape_plan(arch, shape), JC.shape_plan(arch, shape)
            assert (t is None) == (j is None), (arch, shape)
            if t is not None:
                own = {k: v for k, v in t.__dict__.items()
                       if k != "use_ssd_kernel"}
                assert own == j.__dict__, (arch, shape)
    assert TC.shape_plan("whisper-tiny", "long_500k") is None
    swa = TC.shape_plan("qwen3-0.6b", "long_500k")
    assert (swa.name, swa.attention_kind, swa.sliding_window) == (
        "qwen3-0.6b-swa", "sliding_window", 4096)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_refuses_sliding_window(paged):
    """The port's engine raises a clear error for a sliding-window config,
    dense or paged, where the JAX engine's dense admit fails with a
    broadcasting error (its prefill cache is cache_len long, the
    window-clamped pool is not)."""
    jcfg, tcfg, jp, tp = _swa()
    kw = dict(page_size=4) if paged else {}
    with pytest.raises(ValueError, match="sliding-window"):
        ServeEngine(tp, tcfg, num_slots=2, cache_len=32, device="cpu", **kw)
    from repro.serving import Request as JRequest
    from repro.serving import ServeEngine as JEngine
    with pytest.raises((ValueError, TypeError),
                       match="broadcast|sliding-window"):
        JEngine(jp, jcfg, num_slots=2, cache_len=32, **kw).run(
            [JRequest(rid=0, prompt=np.arange(6, dtype=np.int32),
                      max_new_tokens=4)])
