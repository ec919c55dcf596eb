"""Port parity for the ssm family (RWKV6, rwkv6-1.6b SMOKE, fp32): the
WKV recurrence (scan and step), the block at prefill and decode, the
model's forward, decode_step with an active mask and lm_loss gradients,
and the dense engine's greedy streams with a drain and readmit — against
the JAX package on the same weights and numpy inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as JMD  # noqa: E402
from repro.models import rwkv as JRW  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro_torch.models import model as TMD  # noqa: E402
from repro_torch.models import rwkv as TRW  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

import _torch_families as F  # noqa: E402
import test_torch_bridge as TP  # noqa: E402

ARCH = "rwkv6-1.6b"
ATOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 9


def _setup():
    return F.setup(ARCH)


def _np(t):
    return np.asarray(t, np.float32)


def test_wkv_scan_and_step_match_jax():
    """The exact recurrence over S steps, and one step from a state."""
    H, K = 3, 8
    r = np.random.RandomState(0)
    rk, kk, vk = (r.randn(B, S, H, K).astype(np.float32) for _ in range(3))
    w = r.uniform(0.2, 0.99, (B, S, H, K)).astype(np.float32)
    u = r.randn(H, K).astype(np.float32)
    jy, js = JRW.wkv_scan(*map(jnp.asarray, (rk, kk, vk, w, u)))
    ty, ts = TRW.wkv_scan(*map(torch.from_numpy, (rk, kk, vk, w, u)))
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ATOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **ATOL)
    st = r.randn(B, H, K, K).astype(np.float32)
    one = [a[:, 0] for a in (rk, kk, vk, w)]
    jy1, js1 = JRW.wkv_step(jnp.asarray(st), *map(jnp.asarray, one),
                            jnp.asarray(u))
    ty1, ts1 = TRW.wkv_step(torch.from_numpy(st),
                            *map(torch.from_numpy, one), torch.from_numpy(u))
    np.testing.assert_allclose(ty1.numpy(), _np(jy1), **ATOL)
    np.testing.assert_allclose(ts1.numpy(), _np(js1), **ATOL)


def test_rwkv_block_prefill_and_decode_match_jax():
    """Layer 0's block over a prompt (its output and state), then one
    token from that state."""
    jcfg, tcfg, jp, tp = _setup()
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    tl = {k: v[0] for k, v in tp["blocks"].items()}
    x = np.random.RandomState(1).randn(B, S + 1, jcfg.d_model).astype(
        np.float32)
    jy, jst = JRW.rwkv_block(jl, jnp.asarray(x[:, :S]), jcfg)
    ty, tst = TRW.rwkv_block(tl, torch.from_numpy(x[:, :S]), tcfg)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ATOL)
    for n in ("wkv", "tm", "cm"):
        np.testing.assert_allclose(tst[n].numpy(), _np(jst[n]), **ATOL)
    jy, jst = JRW.rwkv_block(jl, jnp.asarray(x[:, S:]), jcfg, state=jst)
    ty, tst = TRW.rwkv_block(tl, torch.from_numpy(x[:, S:]), tcfg, state=tst)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **ATOL)
    for n in ("wkv", "tm", "cm"):
        np.testing.assert_allclose(tst[n].numpy(), _np(jst[n]), **ATOL)


def test_forward_and_decode_match_jax():
    """Logits and the cached state of a prefill, then decode steps with
    row 1 retired: its state rows stay bit for bit."""
    jcfg, tcfg, jp, tp = _setup()
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, size=(B, S + 3)).astype(np.int32)
    jl, _, jc = JMD.forward(jp, jcfg, jnp.asarray(toks[:, :S]),
                            return_cache=True)
    tl, _, tc = TMD.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                            return_cache=True)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
    specs = TMD.cache_specs(tcfg, B, 16)
    for n in ("wkv", "tm", "cm"):
        assert tuple(tc[n].shape) == jc[n].shape == specs[n][0]
        np.testing.assert_allclose(tc[n].numpy(), _np(jc[n]), **ATOL)
    act = np.array([True, False])
    pos = np.full((B,), S, np.int32)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        held = {n: t[:, 1].clone() for n, t in tc.items()}
        jl, jc = JMD.decode_step(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(pos), jc,
                                 active=jnp.asarray(act))
        tl, tc = TMD.decode_step(tp, tcfg, torch.from_numpy(tok),
                                 torch.from_numpy(pos), tc,
                                 active=torch.from_numpy(act))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **ATOL)
        for n in ("wkv", "tm", "cm"):
            np.testing.assert_allclose(tc[n].numpy(), _np(jc[n]), **ATOL)
            assert torch.equal(tc[n][:, 1], held[n])
        pos = pos + act


def test_paged_modes_refused_as_in_jax():
    jcfg, tcfg, _, tp = _setup()
    assert TMD.paged_leaf_names(tcfg) == JMD.paged_leaf_names(jcfg) == ()
    with pytest.raises(ValueError, match="no KV cache to page"):
        TMD.decode_step(tp, tcfg, torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        TMD.init_cache(tcfg, 1, 8, "cpu"),
                        block_tables=torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="no KV cache to page"):
        ServeEngine(tp, tcfg, num_slots=2, cache_len=16, page_size=4,
                    device="cpu")
    with pytest.raises(ValueError, match="no KV"):
        JEngine(_setup()[2], jcfg, num_slots=2, cache_len=16, page_size=4)


def test_lm_loss_and_grads_match_jax():
    """lm_loss and its gradient through every leaf (the fp32 decay base
    and bonus included), with block remat as the reference's config."""
    jcfg, tcfg, jp, tp = _setup()
    jcfg, tcfg = jcfg.with_(remat="block"), tcfg.with_(remat="block")
    toks = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    jloss, jg = jax.value_and_grad(JMD.lm_loss)(jp, jcfg, jb)
    from repro_torch.launch.steps import loss_and_grads
    tloss, tg = loss_and_grads(tp, tcfg, {
        "tokens": torch.from_numpy(toks[:, :-1]),
        "labels": torch.from_numpy(toks[:, 1:])})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jflat = dict(TP._flat(jax.tree_util.tree_map(np.asarray, jg)))
    for name, g in TP._flat(tg):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_dense_engine_and_drain_readmit_match_jax():
    """The dense continuous engine's greedy streams and schedule equal
    the JAX engine's; then both drain after 3 ticks (the recurrent state
    is not migrated: the continuation re-prefills prompt + emitted) and
    finish on a second engine, stitched back to the same streams."""
    jcfg = _setup()[0]
    reqs = F.stream(jcfg, seed=7, n=5, plens=(5, 9), gens=(4, 8))
    kw = dict(num_slots=2, cache_len=24)
    _, fins = F.engines_match(ARCH, reqs, kw)
    tout, jout, drained, _ = F.drain_resume(ARCH, reqs, kw, ticks=3)
    assert all(d.kv is None for d in drained)
    assert any(d.emitted for d in drained)
    assert tout == jout == {f.rid: f.tokens for f in fins}
