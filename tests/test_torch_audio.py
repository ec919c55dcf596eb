"""Port parity for the audio family (the whisper-tiny SMOKE encoder-decoder,
fp32): the encoder, the cross-attention at prefill and decode, forward
with its cache (the encoder K/V "ck"/"cv" beside the self-attention K/V),
and the dense and paged engines' greedy streams (a tight pool that
preempts and re-admits included), a paged drain whose harvest carries
the cross-K/V rows, and its readmit — against the JAX package on the same
weights and numpy inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

import _torch_families as F  # noqa: E402

ARCH = "whisper-tiny"
ATOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 7
PAGED = dict(num_slots=2, cache_len=20, page_size=4)


def _np(t):
    return np.asarray(t, np.float32)


def _inputs(cfg, seed=0):
    r = np.random.RandomState(seed)
    toks = r.randint(0, cfg.vocab_size, size=(B, S + 3)).astype(np.int32)
    frames = r.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32)
    return toks, frames


def test_encoder_and_cross_attention_match_jax():
    """The encoder's output (full attention over the frames), then layer
    0's cross-attention: its encoder K/V, the batched read at prefill and
    the one-token read at decode (every frame visible, nothing written)."""
    jcfg, tcfg, jp, tp = F.setup(ARCH)
    toks, frames = _inputs(jcfg)
    jenc = JMD._encode_audio(jp, jcfg, jnp.asarray(frames))
    tenc = TMD._encode_audio(tp, tcfg, torch.from_numpy(frames), False)
    np.testing.assert_allclose(tenc.numpy(), _np(jenc), **ATOL)
    jx = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["cross"]
    tx = {k: v[0] for k, v in tp["blocks"]["cross"].items()}
    jkv = JA.encoder_kv(jx, jenc, jcfg)
    tkv = TA.encoder_kv(tx, tenc, tcfg)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a.numpy(), _np(b), **ATOL)
    h = np.random.RandomState(1).randn(B, S, jcfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jy = JA.attention(jx, jnp.asarray(h), jnp.asarray(pos), jcfg,
                      encoder_kv=jkv)
    ty = TA.attention(tx, torch.from_numpy(h), torch.from_numpy(pos), tcfg,
                      encoder_kv=tkv)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ATOL)
    cache = jnp.zeros((B, 8, jcfg.num_kv_heads, jcfg.head_dim))
    jy, _, _ = JA.attention_decode(jx, jnp.asarray(h[:, :1]), cache * 0,
                                   cache * 0, jnp.full((B,), 3, jnp.int32),
                                   jcfg, encoder_kv_cache=jkv)
    ty, _, _ = TA.attention_decode(tx, torch.from_numpy(h[:, :1]), None,
                                   None, torch.full((B,), 3), tcfg,
                                   encoder_kv_cache=tkv)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ATOL)


@pytest.mark.parametrize("paged", [False, True])
def test_forward_cache_and_decode_match_jax(paged):
    """Logits and every cache leaf of a prefill (the self K/V padded to
    the cache length, the cross K/V at the frames' length); then decode
    steps from that cache, dense or through a paged pool (the cross K/V
    as per-slot rows), with row 1 retired."""
    jcfg, tcfg, jp, tp = F.setup(ARCH)
    toks, frames = _inputs(jcfg, seed=2)
    C = 12
    jl, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                            extra_embeds=jnp.asarray(frames),
                            return_cache=True, cache_len=C)
    tl, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                            extra_embeds=torch.from_numpy(frames),
                            return_cache=True, cache_len=C)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
    specs = TMD.cache_specs(tcfg, B, C)
    assert sorted(tc) == sorted(jc) == sorted(specs) == ["ck", "cv", "k",
                                                         "v"]
    for n in tc:
        assert tuple(tc[n].shape) == jc[n].shape == specs[n][0]
        np.testing.assert_allclose(tc[n].numpy(), _np(jc[n]), **ATOL)
    act = np.array([True, False])
    pos = np.full((B,), S, np.int32)
    extra = {}
    if paged:
        P, npg = 4, 3
        ids = np.arange(B * npg, dtype=np.int32).reshape(B, npg)[:, ::-1]
        tpool = TMD.init_paged_cache(tcfg, B, B * npg, P, "cpu")
        for b in range(B):
            one = {n: t[:, b:b + 1] for n, t in tc.items()}
            TMD.write_paged_cache(tpool, one, b, torch.from_numpy(
                ids[b].copy()), tcfg)
        assert TMD.paged_leaf_names(tcfg) == ("k", "v")
        assert tpool["ck"].shape[1] == B
        tc = tpool
        extra = dict(block_tables=torch.from_numpy(ids.copy()),
                     logical_len=C)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jc,
                                 active=jnp.asarray(act))
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tc,
                                 active=torch.from_numpy(act), **extra)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
        pos = pos + act
    for n in ("ck", "cv"):
        np.testing.assert_allclose(tc[n].numpy(), _np(jc[n]), **ATOL)


@pytest.mark.parametrize("kw", [
    dict(num_slots=2, cache_len=20),
    PAGED,
    dict(PAGED, num_slots=3, num_pages=6)], ids=["dense", "paged",
                                                "paged_tight_pool"])
def test_engine_matches_jax_engine(kw):
    """Greedy streams, finish ticks and schedule counters equal the JAX
    engine's; on 6 pages three slots preempt and re-admit (prompt +
    emitted, the frames again)."""
    jcfg = F.setup(ARCH)[0]
    reqs = F.stream(jcfg, seed=3, n=5, plens=(6,), gens=(5, 9))
    teng, _ = F.engines_match(ARCH, reqs, kw)
    if "num_pages" in kw:
        assert teng.stats()["preemptions"] >= 1


def test_paged_drain_carries_cross_kv_rows():
    """A paged drain harvests each live slot's self-K/V pages and its
    cross-K/V rows (equal to JAX's); the readmit installs them on a
    second engine with no prefill of the harvested prefixes, and the
    stitched streams equal the JAX package's drain and readmit."""
    jcfg = F.setup(ARCH)[0]
    reqs = F.stream(jcfg, seed=4, n=3, plens=(6,), gens=(12,))
    td = F.harvested_rows_match(ARCH, reqs, PAGED, ticks=3)
    live = [d for d in td if d.kv is not None]
    assert len(live) == 2
    for d in live:
        assert sorted(d.kv.pages) == ["k", "v"]
        assert sorted(d.kv.rows) == ["ck", "cv"]
        assert tuple(d.kv.rows["ck"].shape) == (
            jcfg.num_layers, jcfg.encoder_seq, jcfg.num_kv_heads,
            jcfg.head_dim)
    tout, jout, drained, b = F.drain_resume(ARCH, reqs, PAGED, ticks=3)
    assert tout == jout
    assert all(len(tout[i]) == g for i, _, g, _ in reqs)
    assert b.migrated_admits == sum(d.kv is not None for d in drained) == 2
    assert b.prefill_tokens == sum(len(d.request.prompt) + len(d.emitted)
                                   for d in drained if d.kv is None)
