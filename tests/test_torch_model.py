"""Port parity for the dense model: forward (logits and cache), decode_step
with scalar and per-row positions, active masks, the paged pool against
the dense cache, and the kernel-flag paths — against the JAX package on
the qwen3-0.6b SMOKE config in fp32, with the same weights."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as JMD  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

import test_torch_bridge as TP  # noqa: E402

ATOL = dict(rtol=1e-4, atol=1e-4)
B, S, C = 3, 8, 16


def _tokens(vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S + 2)
                                               ).astype(np.int32)


def _prefill(jp, tp, jcfg, tcfg, toks):
    jl, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                            return_cache=True, cache_len=C)
    tl, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                            return_cache=True, cache_len=C)
    return jl, jc, tl, tc


@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_jax(flash):
    """Logits and the padded KV cache; with use_flash_kernel the JAX side
    runs the Pallas kernel in interpret mode, the port its plain version."""
    jcfg, tcfg = TP.configs(use_flash_kernel=flash)
    jp, tp = TP.params(jcfg)
    jl, jc, tl, tc = _prefill(jp, tp, jcfg, tcfg, _tokens(jcfg.vocab_size))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == jc[n].shape
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **ATOL)


def test_prefill_step_matches_jax():
    from repro.launch.steps import make_prefill_step as jax_prefill
    from repro_torch.launch.steps import make_prefill_step
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=6)[:, :S]
    jl, jc = jax_prefill(jcfg, C)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = make_prefill_step(tcfg, C)(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == jl.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **ATOL)


def test_forward_rejects_short_cache():
    _, tcfg = TP.configs()
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cache_len"):
        TMD.forward(tp, tcfg, torch.zeros((1, 8), dtype=torch.int32),
                    return_cache=True, cache_len=4)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_matches_jax(per_row):
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=1)
    _, jc, _, tc = _prefill(jp, tp, jcfg, tcfg, toks)
    pos_j = jnp.full((B,), S, jnp.int32) if per_row else jnp.int32(S)
    pos_t = torch.full((B,), S, dtype=torch.int32) if per_row else S
    for step in range(2):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok), pos_j, jc)
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok), pos_t, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       **ATOL)
        pos_j, pos_t = pos_j + 1, pos_t + 1


def test_qwen3_1p7b_forward_and_decode_match_jax():
    """qwen3-1.7b SMOKE (the speculative target): forward logits and the
    KV cache, then two per-row decode steps, against the JAX package's on
    the same weights."""
    _check_arch_forward_and_decode("qwen3-1.7b")


def test_deepseek_7b_forward_and_decode_match_jax():
    """deepseek-7b SMOKE: llama-style, no qk-norm, Hq == Hk (G 1); the
    same checks as qwen3-1.7b's."""
    _check_arch_forward_and_decode("deepseek-7b")


def _check_arch_forward_and_decode(arch):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config as torch_get_config
    jcfg = jax_get_config(arch, smoke=True)
    tcfg = torch_get_config(arch, smoke=True)
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=9)
    jl, jc, tl, tc = _prefill(jp, tp, jcfg, tcfg, toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **ATOL)
    pos_j = jnp.full((B,), S, jnp.int32)
    pos_t = torch.full((B,), S, dtype=torch.int32)
    for step in range(2):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok), pos_j, jc)
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok), pos_t, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
        pos_j, pos_t = pos_j + 1, pos_t + 1


def test_inactive_rows_are_noops():
    """active=False rows keep their cache row bit-identical; active rows
    update as without the mask; the logits of active rows match JAX."""
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=2)
    _, jc, _, tc = _prefill(jp, tp, jcfg, tcfg, toks)
    old = {n: t.clone() for n, t in tc.items()}
    full = {n: t.clone() for n, t in tc.items()}
    pos = torch.full((B,), S, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    tok = torch.from_numpy(toks[:, S:S + 1])
    TMD.decode_step(tp, tcfg, tok, pos, full)
    tl, tc = TMD.decode_step(tp, tcfg, tok, pos, tc, active=active)
    jl, _ = JMD.decode_step(jp, jcfg, jnp.asarray(toks[:, S:S + 1]),
                            jnp.full((B,), S, jnp.int32), jc,
                            active=jnp.asarray(active.numpy()))
    for n in ("k", "v"):
        assert torch.equal(tc[n][:, 1], old[n][:, 1])   # frozen row
        assert torch.equal(tc[n][:, 0], full[n][:, 0])
        assert torch.equal(tc[n][:, 2], full[n][:, 2])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)


def test_active_requires_vector_pos():
    _, tcfg = TP.configs()
    tp = TMD.init_model(tcfg, torch.Generator().manual_seed(0))
    cache = TMD.init_cache(tcfg, 2, 8, "cpu")
    with pytest.raises(ValueError, match="per-row pos"):
        TMD.decode_step(tp, tcfg, torch.zeros((2, 1), dtype=torch.int32), 3,
                        cache, active=torch.tensor([True, False]))


def _paged_setup(tp, tcfg, toks, P=4):
    """Dense and paged caches holding the same prefill, with scrambled
    disjoint page ids per slot (the fragmented pool)."""
    npg = -(-(S + 2) // P)       # pages covering prefill + 2 decode steps
    n_max = npg + 1
    Cl = n_max * P
    Np = B * n_max
    dense = TMD.init_cache(tcfg, B, Cl, "cpu")
    paged = TMD.init_paged_cache(tcfg, B, Np, P, "cpu")
    ids = np.random.RandomState(7).permutation(Np).reshape(B, n_max)
    for b in range(B):
        row = torch.from_numpy(toks[b:b + 1, :S])
        _, _, c1 = TMD.forward(tp, tcfg, row, return_cache=True, cache_len=Cl)
        TMD.write_cache_slot(dense, c1, b)
        _, _, c2 = TMD.forward(tp, tcfg, row, return_cache=True,
                               cache_len=npg * P)
        TMD.write_paged_cache(paged, c2, b, torch.from_numpy(ids[b, :npg]),
                              tcfg)
    return dense, paged, torch.from_numpy(ids.astype(np.int32)), Cl, Np


@pytest.mark.parametrize("kernel_flag", [False, True])
def test_paged_decode_matches_dense(kernel_flag):
    """decode_step through block tables over the page pool == decode_step
    over the dense per-slot cache, logits and the KV written; with
    use_paged_kernel the decode read goes through the wrapper's plain
    version.  The gathered read is the dense read bit for bit; the plain
    paged kernel version reduces in another order (1e-5)."""
    _, tcfg = TP.configs(use_paged_kernel=kernel_flag)
    _, dcfg = TP.configs()
    jcfg, _ = TP.configs()
    _, tp = TP.params(jcfg)
    toks = _tokens(tcfg.vocab_size, seed=3)
    dense, paged, bt, Cl, Np = _paged_setup(tp, tcfg, toks)
    P = paged["k"].shape[2]
    pos = torch.full((B,), S, dtype=torch.int32)
    for step in range(2):
        tok = torch.from_numpy(toks[:, S + step:S + step + 1])
        l_d, dense = TMD.decode_step(tp, dcfg, tok, pos, dense)
        l_p, paged = TMD.decode_step(tp, tcfg, tok, pos, paged,
                                     block_tables=bt, logical_len=Cl)
        if kernel_flag:
            torch.testing.assert_close(l_p, l_d, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(l_p, l_d)
        pos = pos + 1
    for b in range(B):   # the written pages hold the dense rows
        view = paged["k"][:, bt[b].long()].reshape(tcfg.num_layers, -1,
                                                    *paged["k"].shape[3:])
        assert torch.equal(view[:, :S + 2], dense["k"][:, b, :S + 2])
    assert P == 4 and paged["k"].shape[1] == Np + 1


def test_paged_inactive_rows_use_trash_page():
    """A retired slot's paged write lands on the trash page: the pool's
    pages [:Np] are untouched for it, and a poisoned trash page is never
    read (active rows' logits unchanged)."""
    jcfg, tcfg = TP.configs(use_paged_kernel=True)
    _, tp = TP.params(jcfg)
    toks = _tokens(tcfg.vocab_size, seed=4)
    _, paged, bt, Cl, Np = _paged_setup(tp, tcfg, toks)
    pos = torch.full((B,), S, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    tok = torch.from_numpy(toks[:, S:S + 1])
    before = {n: t.clone() for n, t in paged.items()}
    clean = {n: t.clone() for n, t in paged.items()}
    l_clean, _ = TMD.decode_step(tp, tcfg, tok, pos, clean, active=active,
                                 block_tables=bt, logical_len=Cl)
    for t in paged.values():
        t[:, Np] = float("nan")
    l_p, paged = TMD.decode_step(tp, tcfg, tok, pos, paged, active=active,
                                 block_tables=bt, logical_len=Cl)
    assert torch.equal(l_p[[0, 2]], l_clean[[0, 2]])
    owned = bt[1].long()
    for n in ("k", "v"):
        assert torch.equal(paged[n][:, owned], before[n][:, owned])
        assert torch.equal(paged[n][:, :Np], clean[n][:, :Np])


def test_paged_decode_matches_jax():
    """The port's paged decode against the JAX paged decode, same pages."""
    jcfg, tcfg = TP.configs()
    jp, tp = TP.params(jcfg)
    toks = _tokens(tcfg.vocab_size, seed=5)
    _, paged, bt, Cl, Np = _paged_setup(tp, tcfg, toks)
    jpaged = {n: jnp.asarray(t[:, :Np].numpy()) for n, t in paged.items()}
    pos = np.full((B,), S, np.int32)
    tok = toks[:, S:S + 1]
    jl, jpaged = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jpaged,
                                 block_tables=jnp.asarray(bt.numpy()),
                                 logical_len=Cl)
    tl, paged = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), paged,
                                block_tables=bt, logical_len=Cl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(paged[n][:, :Np].numpy(),
                                   np.asarray(jpaged[n]), **ATOL)


def test_unported_family_raises():
    """Every family of the JAX package is ported; an arch_type outside
    them raises, in the port as in the reference."""
    jcfg, tcfg = TP.configs()
    with pytest.raises(ValueError):
        JMD.model_descs(jcfg.with_(arch_type="conv"))
    with pytest.raises(ValueError, match="arch_type"):
        TMD.model_descs(tcfg.with_(arch_type="conv"))
    with pytest.raises(ValueError, match="arch_type"):
        TMD.cache_specs(tcfg.with_(arch_type="conv"), 1, 8)


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "kernel_flags"])
@pytest.mark.parametrize("arch", ["nemotron-4-340b"])
def test_dense_config_paged_engine_matches_jax(arch, kernels):
    """A dense config's SMOKE (nemotron-4-340b: squared-ReLU MLP, G 2):
    forward and per-row decode against JAX's (the qwen3-1.7b and
    deepseek-7b checks above), then the paged engine's greedy streams on
    a pool that preempts, with the kernel flags on (their plain versions
    on the CPU) or off, equal to the JAX engine's."""
    import _torch_families as F
    if not kernels:
        _check_arch_forward_and_decode(arch)
    jcfg = F.setup(arch)[0]
    reqs = F.stream(jcfg, seed=9, n=5, plens=(5, 8), gens=(4, 9))
    kw = dict(num_slots=3, cache_len=20, page_size=4, num_pages=8)
    teng, _ = F.engines_match(arch, reqs, kw, use_flash_kernel=kernels,
                              use_paged_kernel=kernels)
    assert teng.stats()["preemptions"] >= 1
