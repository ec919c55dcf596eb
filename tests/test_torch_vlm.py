"""Port parity for the vlm family (the phi-3-vision-4.2b SMOKE backbone,
fp32): the projected patch prefix, the logits cropped by it, decode past
it, the paged engine's greedy streams (a tight pool that preempts and
re-admits included), a drain and migrated install, and the speculative
engine with the lookup draft — against the JAX package on the same
weights and numpy inputs; the gradients at depth with the stub
frontend's zero patches, non-finite where JAX's are; and a train step on
patches drawn from a seed, finite and equal to JAX's."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models.common import dense, tree_leaves  # noqa: E402

import _torch_families as F  # noqa: E402

ARCH = "phi-3-vision-4.2b"
ATOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 6
# SMOKE prefixes 16 patches: a slot holds them, a prompt of <= 9 tokens
# and a budget of <= 10, on pages of 4
PAGED = dict(num_slots=2, cache_len=36, page_size=4)


def _np(t):
    return np.asarray(t, np.float32)


def test_prefix_logits_and_decode_match_jax():
    """vproj projects the patches into the first num_patches positions:
    the cache holds them (k/v rows 0..P-1 depend on the patches), the
    logits are the prompt's only; decode continues at position P + S."""
    jcfg, tcfg, jp, tp = F.setup(ARCH)
    assert TMD.VISION_EMBED_DIM == JMD.VISION_EMBED_DIM
    assert tuple(tp["vproj"].shape) == (TMD.VISION_EMBED_DIM, jcfg.d_model)
    r = np.random.RandomState(0)
    toks = r.randint(0, jcfg.vocab_size, size=(B, S + 3)).astype(np.int32)
    patches = r.randn(B, jcfg.num_patches, 1024).astype(np.float32)
    P = jcfg.num_patches
    C = P + S + 4
    jl, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                            extra_embeds=jnp.asarray(patches),
                            return_cache=True, cache_len=C)
    tl, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                            extra_embeds=torch.from_numpy(patches),
                            return_cache=True, cache_len=C)
    assert tuple(tl.shape) == jl.shape == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), _np(jc[n]), **ATOL)
    # other patches change the prefix's cache rows and the logits
    _, _, tc2 = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                            extra_embeds=torch.from_numpy(patches + 1),
                            return_cache=True, cache_len=C)
    assert not torch.allclose(tc2["k"][:, :, :P], tc["k"][:, :, :P])
    proj = dense(torch.from_numpy(patches), tp["vproj"])
    assert tuple(proj.shape) == (B, P, jcfg.d_model)
    pos = np.full((B,), P + S, np.int32)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jc)
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
        pos = pos + 1


def test_forward_needs_patches():
    _, tcfg, _, tp = F.setup(ARCH)
    with pytest.raises(ValueError, match="extra_embeds"):
        TMD.forward(tp, tcfg, torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("kw", [
    dict(num_slots=2, cache_len=36),
    PAGED,
    dict(PAGED, num_slots=3, num_pages=12)], ids=["dense", "paged",
                                                 "paged_tight_pool"])
def test_engine_matches_jax_engine(kw):
    """Greedy streams, finish ticks and schedule counters equal the JAX
    engine's (every admit prefills the prefix first: start_pos, page
    counts and the budget check count it); on 12 pages three slots
    preempt and re-admit with their patches."""
    jcfg = F.setup(ARCH)[0]
    reqs = F.stream(jcfg, seed=5, n=5, plens=(6, 9), gens=(6, 10))
    teng, _ = F.engines_match(ARCH, reqs, kw)
    if "num_pages" in kw:
        assert teng.stats()["preemptions"] >= 1


def test_budget_counts_the_prefix():
    jcfg, tcfg, _, tp = F.setup(ARCH)
    eng = F.port_engine(tp, tcfg, **PAGED)
    [(i, p, _, e)] = F.stream(jcfg, seed=6, n=1, plens=(9,), gens=(10,))
    eng.submit(F.treqs([(i, p, 11, e)])[0])           # 16 + 9 + 11 = 36
    with pytest.raises(ValueError, match="prefix 16"):
        eng.submit(F.treqs([(i, p, 12, e)])[0])


def test_drain_and_migrated_install_match_jax():
    """A paged drain after 3 ticks: the harvested pages (prefix
    included) equal JAX's; the continuations install on a second engine
    (no prefill of a harvested prefix, patches kept for a re-prefill) and
    the stitched streams equal the JAX package's drain and readmit."""
    jcfg = F.setup(ARCH)[0]
    reqs = F.stream(jcfg, seed=7, n=3, plens=(6,), gens=(12,))
    kw = dict(PAGED, cache_len=40)
    td = F.harvested_rows_match(ARCH, reqs, kw, ticks=3)
    live = [d for d in td if d.kv is not None]
    assert len(live) == 2
    for d in live:
        assert d.kv.pos == (jcfg.num_patches + len(d.request.prompt)
                            + len(d.emitted) - 1)
    tout, jout, drained, b = F.drain_resume(ARCH, reqs, kw, ticks=3)
    assert tout == jout
    assert all(len(tout[i]) == g for i, _, g, _ in reqs)
    assert b.migrated_admits == 2


def test_spec_engine_lookup_draft_matches_jax():
    """SpecDecodeEngine with the n-gram lookup draft (k 2), paged: the
    streams, rounds and accepted drafts equal the JAX engine's, and the
    tokens equal the plain engine's (verify is exact in fp32)."""
    jcfg = F.setup(ARCH)[0]
    reqs = F.stream(jcfg, seed=8, n=4, plens=(6, 9), gens=(6, 10))
    kw = dict(PAGED, cache_len=38)
    _, sfin = F.engines_match(ARCH, reqs, kw, spec=True)
    _, pfin = F.engines_match(ARCH, reqs, kw)
    assert [f.tokens for f in sfin] == [f.tokens for f in pfin]


def test_zero_patches_make_jax_s_nonfinite_gradients_at_depth():
    """The vlm launchers' stub frontend gives zero patches.  Those prefix
    rows stay zero through every layer, and each RMSNorm's backward
    multiplies their gradient by 1/sqrt(eps) = 1000, so by 16 layers it
    overflows and spreads NaN into the weights' gradients (the fault of
    the reference that ROADMAP queue 3 records; phi-3-vision-4.2b has 32
    layers).  The port reproduces it exactly: the same non-finite
    gradient elements as JAX, none at 8 layers."""
    for layers, bad in ((8, False), (16, True)):
        jcfg = jax_get_config(ARCH, smoke=True).with_(num_layers=layers)
        tcfg = torch_get_config(ARCH, smoke=True).with_(num_layers=layers)
        tp = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
        toks = np.random.RandomState(0).randint(
            0, tcfg.vocab_size, size=(1, 33)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "extra_embeds": np.zeros((1, tcfg.num_patches, 1024),
                                      np.float32)}
        _, jg = jax.value_and_grad(JMD.lm_loss)(
            jp, jcfg, jax.tree_util.tree_map(jnp.asarray, b))
        _, tg = loss_and_grads(tp, tcfg, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        t = [np.isfinite(a) for a in tree_leaves(params_to_numpy(tg))]
        j = [np.isfinite(np.asarray(a)) for a in jax.tree_util.tree_leaves(jg)]
        assert len(t) == len(j)
        for a, c in zip(t, j):
            np.testing.assert_array_equal(a, c)
        assert any(not a.all() for a in t) == bad


def test_seeded_patches_train_step_matches_jax():
    """The decision on the zero patches (ROADMAP queue 3): the launchers
    keep JAX's zeros, and `chip_smoke.py` phase 6 trains phi-3 on patches
    drawn from a seed, which the caller puts in the batch's
    `extra_embeds`.  At 16 SMOKE layers, where zero patches already give
    non-finite gradients, one AdamW train step on seeded patches (numpy,
    the same in both packages) has a finite gradient norm in both, and
    the port's step matches JAX's `make_train_step`: loss and gnorm at
    rtol 1e-4, params and moments as `test_torch_train.py` holds them
    (all but 1 in 10^4 elements within rtol 1e-4 / atol 1e-5, every one
    within the learning rate)."""
    from repro.launch.steps import make_train_step as jax_train_step
    from repro.optim import optimizers as JO
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import optimizers as TO
    from test_torch_train import _close_but_few

    jcfg = jax_get_config(ARCH, smoke=True).with_(num_layers=16)
    tcfg = torch_get_config(ARCH, smoke=True).with_(num_layers=16)
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
    r = np.random.RandomState(7)
    toks = r.randint(0, tcfg.vocab_size, size=(1, 33)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
         "extra_embeds": r.randn(1, tcfg.num_patches, 1024).astype(
             np.float32)}
    lr = 3e-3
    jopt = JO.adamw(JO.warmup_cosine(lr, 1, 4))
    topt = TO.adamw(TO.warmup_cosine(lr, 1, 4))
    jp2, js2, jm = jax.jit(jax_train_step(jcfg, jopt))(
        jp, jopt.init(jp), jax.tree_util.tree_map(jnp.asarray, b))
    tp2, ts2, tm = make_train_step(tcfg, topt)(
        tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(jm["gnorm"])) and np.isfinite(float(tm["gnorm"]))
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    _close_but_few(tp2, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp2), "cpu"), lr)
    _close_but_few(ts2["mu"], params_from_numpy(
        jax.tree_util.tree_map(np.asarray, js2["mu"]), "cpu"), lr)
