"""Port parity for the hybrid family (Zamba2-style: Mamba2 layers with one
shared attention+MLP block after every k-th): forward logits and cache, N
decode steps, the paged pool against the dense cache and against JAX,
retired rows, lm_loss and its gradients — against the JAX package on
zamba2-1.2b SMOKE (L = 4, k = 2) and a 5-layer variant where L % k != 0,
in fp32 with the same weights."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JMD  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, C = 2, 10, 16
LAYERS = [4, 5]          # SMOKE, and L % k != 0 (the last layer has no
                         # shared block, and no shared-cache slot)


def _configs(num_layers=4, **kw):
    return (jax_get_config(ARCH, smoke=True).with_(num_layers=num_layers,
                                                   **kw),
            torch_get_config(ARCH, smoke=True).with_(num_layers=num_layers,
                                                     **kw))


def _params(jcfg, seed=0):
    jp = JMD.init_model(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _tokens(vocab, seed=0, n=S + 3):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, n)
                                               ).astype(np.int32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _assert_cache_close(tc, jc):
    t, j = dict(_flat(tc)), dict(_flat(jc))
    assert sorted(t) == sorted(j)
    for name, leaf in j.items():
        assert tuple(t[name].shape) == leaf.shape, name
        np.testing.assert_allclose(t[name].numpy(), np.asarray(leaf),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("L", LAYERS)
def test_params_carry_across_exactly(L):
    """The JAX init_model tree of the hybrid, the un-stacked `shared`
    block included, maps one to one onto the port's descriptors."""
    jcfg, tcfg = _configs(L)
    jp, tp = _params(jcfg)
    descs = dict(_flat(TMD.model_descs(tcfg)))
    got = dict(_flat(tp))
    assert sorted(descs) == sorted(got)
    assert "shared/attn/wq" in got
    for name, d in descs.items():
        assert tuple(got[name].shape) == d.shape, name


@pytest.mark.parametrize("L", LAYERS)
@pytest.mark.parametrize("kernels", [False, True])
def test_forward_matches_jax(L, kernels):
    """Logits and every cache leaf (SSM states, conv rings, the shared
    block's K/V padded to cache_len); with the kernel flags on, the CPU
    path runs the kernels' plain versions and launches nothing."""
    jcfg, tcfg = _configs(L)
    if kernels:
        tcfg = tcfg.with_(use_ssd_kernel=True, use_flash_kernel=True)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab_size)[:, :S]
    ops.reset_launches()
    jl, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks), return_cache=True,
                            cache_len=C)
    with torch.no_grad():
        tl, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks),
                                return_cache=True, cache_len=C)
    assert ops.ssd_scan.launches == ops.flash_attention.launches == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tc, jc)
    assert tc["sk"].shape[0] == L // jcfg.hybrid_attn_every


def test_forward_whole_chunks_matches_jax():
    """A prompt of two whole chunks (SMOKE's ssm_chunk is 32)."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=1, n=64)
    jl, _, _ = JMD.forward(jp, jcfg, jnp.asarray(toks))
    tl, _, _ = TMD.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("L", LAYERS)
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_steps_match_jax(L, per_row):
    jcfg, tcfg = _configs(L)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=2)
    _, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                           return_cache=True, cache_len=C)
    _, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                           return_cache=True, cache_len=C)
    pos_j = jnp.full((B,), S, jnp.int32) if per_row else jnp.int32(S)
    pos_t = torch.full((B,), S, dtype=torch.int32) if per_row else S
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok), pos_j, jc)
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok), pos_t, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(tc, jc)
        pos_j, pos_t = pos_j + 1, pos_t + 1


@pytest.mark.parametrize("paged", [False, True])
def test_inactive_rows_keep_state_and_ring(paged):
    """active=False rows keep their SSM state and conv ring rows bit for
    bit (and, paged, write their K/V to the trash page only); active rows
    update as without the mask, and their logits match JAX's."""
    jcfg, tcfg = _configs(5)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=3)
    if paged:
        _, cache, bt, Cl, Np = _paged_setup(tp, tcfg, toks)
        kw = dict(block_tables=bt, logical_len=Cl)
    else:
        _, _, cache = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                                  return_cache=True, cache_len=C)
        kw = {}
    old = {n: t.clone() for n, t in _flat(cache)}
    full = _clone(cache)
    pos = torch.full((B,), S, dtype=torch.int32)
    active = torch.tensor([False, True])
    tok = torch.from_numpy(toks[:, S:S + 1])
    TMD.decode_step(tp, tcfg, tok, pos, full, **kw)
    tl, cache = TMD.decode_step(tp, tcfg, tok, pos, cache, active=active,
                                **kw)
    new, ref = dict(_flat(cache)), dict(_flat(full))
    for n in ("ssm", "conv/x", "conv/B", "conv/C"):
        assert torch.equal(new[n][:, 0], old[n][:, 0]), n
        assert torch.equal(new[n][:, 1], ref[n][:, 1]), n
        assert not torch.equal(new[n][:, 1], old[n][:, 1]), n
    for n in ("sk", "sv"):
        if paged:
            owned = bt[0].long()
            assert torch.equal(new[n][:, owned], old[n][:, owned])
        else:
            assert torch.equal(new[n][:, 0], old[n][:, 0])
    if not paged:
        jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                         return_cache=True, cache_len=C)[2]
        jl, _ = JMD.decode_step(jp, jcfg, jnp.asarray(toks[:, S:S + 1]),
                                jnp.full((B,), S, jnp.int32), jc,
                                active=jnp.asarray(active.numpy()))
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl)[1], **TOL)


def _paged_setup(tp, tcfg, toks, P=4):
    """Dense and paged caches holding the same prefills, with scrambled
    disjoint page ids per slot (the fragmented pool)."""
    npg = -(-(S + 3) // P)       # pages covering prefill + 3 decode steps
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


@pytest.mark.parametrize("L", LAYERS)
@pytest.mark.parametrize("kernel_flag", [False, True])
def test_paged_decode_matches_dense(L, kernel_flag):
    """decode_step through block tables == decode_step over the dense
    per-slot cache: logits, the recurrent rows, and the shared block's K/V
    on its pages.  The gathered read is the dense read bit for bit; the
    paged kernel's plain version reduces in another order (1e-5)."""
    jcfg, dcfg = _configs(L)
    tcfg = dcfg.with_(use_paged_kernel=kernel_flag)
    _, tp = _params(jcfg)
    toks = _tokens(tcfg.vocab_size, seed=4)
    dense, paged, bt, Cl, Np = _paged_setup(tp, tcfg, toks)
    pos = torch.full((B,), S, dtype=torch.int32)
    for step in range(3):
        tok = torch.from_numpy(toks[:, S + step:S + step + 1])
        l_d, dense = TMD.decode_step(tp, dcfg, tok, pos, dense)
        l_p, paged = TMD.decode_step(tp, tcfg, tok, pos, paged,
                                     block_tables=bt, logical_len=Cl)
        if kernel_flag:
            torch.testing.assert_close(l_p, l_d, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(l_p, l_d)
        pos = pos + 1
    torch.testing.assert_close(paged["ssm"], dense["ssm"], rtol=1e-5,
                               atol=1e-5)
    n_sh = L // tcfg.hybrid_attn_every
    for b in range(B):
        view = paged["sk"][:, bt[b].long()].reshape(n_sh, -1,
                                                     *paged["sk"].shape[3:])
        torch.testing.assert_close(view[:, :S + 3], dense["sk"][:, b, :S + 3],
                                   rtol=1e-5, atol=1e-5)
    assert paged["sk"].shape[1] == Np + 1
    assert paged["ssm"].shape[1] == B


def test_paged_decode_matches_jax():
    """The port's paged hybrid decode against the JAX paged decode, the
    same pages (the port's pool carries one trash page more)."""
    jcfg, tcfg = _configs(5)
    jp, tp = _params(jcfg)
    toks = _tokens(tcfg.vocab_size, seed=5)
    _, paged, bt, Cl, Np = _paged_setup(tp, tcfg, toks)
    jpaged = {n: jnp.asarray(t[:, :Np].numpy()) for n, t in paged.items()
              if n in ("sk", "sv")}
    jpaged["ssm"] = jnp.asarray(paged["ssm"].numpy())
    jpaged["conv"] = {n: jnp.asarray(t.numpy())
                      for n, t in paged["conv"].items()}
    pos = np.full((B,), S, np.int32)
    tok = toks[:, S:S + 1]
    jl, jpaged = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jpaged,
                                 block_tables=jnp.asarray(bt.numpy()),
                                 logical_len=Cl)
    tl, paged = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                torch.from_numpy(pos), paged,
                                block_tables=bt, logical_len=Cl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("sk", "sv"):
        np.testing.assert_allclose(paged[n][:, :Np].numpy(),
                                   np.asarray(jpaged[n]), **TOL)
    np.testing.assert_allclose(paged["ssm"].numpy(),
                               np.asarray(jpaged["ssm"]), **TOL)


@pytest.mark.parametrize("L", LAYERS)
def test_lm_loss_and_grads_match_jax(L):
    """lm_loss, and its gradients through the plain path (the kernel flags
    are off, as the JAX trainer's are), at 1e-4."""
    from repro_torch.launch.steps import loss_and_grads
    jcfg, tcfg = _configs(L)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg.vocab_size, seed=6, n=33)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    jloss, jg = jax.value_and_grad(
        lambda p: JMD.lm_loss(p, jcfg, jb))(jp)
    tloss, tg = loss_and_grads(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jg = dict(_flat(jax.tree_util.tree_map(np.asarray, jg)))
    for name, g in _flat(tg):
        np.testing.assert_allclose(g.numpy(), jg[name], err_msg=name, **TOL)


def test_block_remat_gives_the_same_gradients():
    from repro_torch.launch.steps import loss_and_grads
    jcfg, tcfg = _configs(5)
    _, tp = _params(jcfg)
    toks = torch.from_numpy(_tokens(jcfg.vocab_size, seed=7, n=33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, g = loss_and_grads(tp, tcfg, batch)
    rloss, rg = loss_and_grads(tp, tcfg.with_(remat="block"), batch)
    assert torch.equal(loss, rloss)
    for (n, a), (_, b) in zip(_flat(g), _flat(rg)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)


def test_kernel_flags_refuse_autograd():
    """The SSD kernel has no backward: the loss with use_ssd_kernel raises
    while autograd records, as jax.grad through the Pallas kernel does."""
    from repro_torch.launch.steps import loss_and_grads
    jcfg, tcfg = _configs()
    _, tp = _params(jcfg)
    toks = torch.from_numpy(_tokens(jcfg.vocab_size, seed=8, n=33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with pytest.raises(RuntimeError, match="no backward"):
        loss_and_grads(tp, tcfg.with_(use_ssd_kernel=True), batch)


def test_prompt_length_rule_matches_jax():
    """A prefill that is neither shorter than ssm_chunk nor a multiple of
    it (40 tokens, chunk 32): JAX's forward asserts, the port scans the
    ragged last chunk.  The oracle is JAX's forward on the first 32 tokens
    and then decode_step for each of the other 8: last-position logits,
    every layer's SSM state and conv ring, and the shared block's K/V."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    n, whole, C = 40, 32, 48
    toks = _tokens(jcfg.vocab_size, seed=9, n=n)
    with pytest.raises(AssertionError):
        JMD.forward(jp, jcfg, jnp.asarray(toks))
    jl, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :whole]),
                            return_cache=True, cache_len=C)
    for t in range(whole, n):
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jc)
    with torch.no_grad():
        tl, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks),
                                return_cache=True, cache_len=C)
    np.testing.assert_allclose(tl[:, -1].numpy(), np.asarray(jl)[:, -1],
                               **TOL)
    _assert_cache_close(tc, jc)


def test_cache_builders_match_jax_layout():
    jcfg, tcfg = _configs(5)
    jsp = JMD.cache_specs(jcfg, 3, 12)
    tsp = TMD.cache_specs(tcfg, 3, 12)
    assert sorted(tsp) == sorted(jsp)
    for name, (shape, _) in _flat(tsp):
        assert shape == dict(_flat(jsp))[name].shape, name
    assert TMD.paged_leaf_names(tcfg) == JMD.paged_leaf_names(jcfg)
    jpg = JMD.paged_cache_specs(jcfg, 3, 6, 4)
    tpg = TMD.init_paged_cache(tcfg, 3, 6, 4, "cpu")
    for name, t in _flat(tpg):
        want = dict(_flat(jpg))[name].shape
        if name in ("sk", "sv"):      # the port's pool has a trash page
            want = (want[0], want[1] + 1) + want[2:]
        assert tuple(t.shape) == want, name
