"""Port parity for the Mamba2 block (`models/ssm.py`): the causal conv
with and without its ring cache, the SSD core `ssd_chunked` (plain and
through the kernel wrapper, which on the CPU runs the plain version), and
`ssm_block` prefill and recurrent decode — against the JAX package, on
zamba2-1.2b SMOKE widths in fp32 with the same weights."""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-4)
CHUNKED_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py's figure


def _configs(**kw):
    return (jax_get_config(ARCH, smoke=True).with_(**kw),
            torch_get_config(ARCH, smoke=True).with_(**kw))


def _block_params(jcfg, seed=0):
    """One layer's Mamba2 weights (JAX init) and the same in the port."""
    jp = jax_init_params(JSSM.ssm_descs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _np(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_jax(with_cache):
    x, w = _np(2, 9, 24, seed=1), _np(4, 24, seed=2, scale=0.3)
    cache = _np(2, 3, 24, seed=3) if with_cache else None
    jy, jc = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if cache is None else jnp.asarray(cache))
    ty, tc = TSSM._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if cache is None
                               else torch.from_numpy(cache))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_causal_conv_ring_carries_one_token_at_a_time():
    """Feeding a sequence one token at a time through the ring gives the
    same outputs as the whole sequence at once."""
    x, w = _np(1, 7, 8, seed=4), _np(4, 8, seed=5)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    whole, ring_end = TSSM._causal_conv(x, w)
    ring = torch.zeros(1, 3, 8)
    steps = []
    for t in range(7):
        y, ring = TSSM._causal_conv(x[:, t:t + 1], w, ring)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(ring, ring_end)


def _ssd_inputs(B, S, H, P, N, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(B, S, H))).astype(np.float32)  # softplus
    A_log = (r.randn(H) * 0.1).astype(np.float32)
    b = r.randn(B, S, N).astype(np.float32)
    c = r.randn(B, S, N).astype(np.float32)
    D = r.randn(H).astype(np.float32)
    return x, dt, A_log, b, c, D


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S,chunk", [(128, 32), (64, 128)])
def test_ssd_chunked_matches_jax(S, chunk, use_kernel):
    """The SSD core with its D skip term; `use_kernel` goes through
    ops.ssd_scan, whose CPU path is the plain version (no launch)."""
    args = _ssd_inputs(2, S, 3, 16, 32)
    jy, jf = JSSM.ssd_chunked(*map(jnp.asarray, args), chunk)
    ops.reset_launches()
    ty, tf = TSSM.ssd_chunked(*map(torch.from_numpy, args), chunk,
                              use_kernel=use_kernel)
    assert ops.ssd_scan.launches == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **CHUNKED_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **CHUNKED_TOL)


def _ssd_chunked_oracle(x, dt, A_log, b, c, D):
    """JAX's sequential recurrence `ref.ssd_ref` on the same dt-scaled
    input, plus D * x: the oracle for any S."""
    from repro.kernels import ref as JR
    loga = -dt * np.exp(A_log)[None, None]
    xe = x * dt[..., None]
    y, fin = JR.ssd_ref(*map(jnp.asarray, (xe, loga, b, c)))
    return np.asarray(y) + D[None, None, :, None] * x, np.asarray(fin)


def test_ssd_chunked_refuses_partial_chunks_where_jax_asserts():
    """S 48 at chunk 32: JAX asserts; the port scans the ragged last
    chunk and matches the sequential oracle."""
    args = _ssd_inputs(1, 48, 1, 16, 16)
    with pytest.raises(AssertionError):
        JSSM.ssd_chunked(*map(jnp.asarray, args), 32)
    ty, tf = TSSM.ssd_chunked(*map(torch.from_numpy, args), 32)
    ry, rf = _ssd_chunked_oracle(*args)
    np.testing.assert_allclose(ty.numpy(), ry, **TOL)
    np.testing.assert_allclose(tf.numpy(), rf, **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("S", [33, 47, 95, 130])
def test_ssd_chunked_ragged_matches_jax_oracle(S, use_kernel):
    """Ragged last chunks (SMOKE's chunk 32) against JAX's `ref.ssd_ref`
    plus D * x; through the kernel wrapper the CPU path is the plain
    version and launches nothing."""
    args = _ssd_inputs(2, S, 3, 16, 32, seed=S)
    ops.reset_launches()
    ty, tf = TSSM.ssd_chunked(*map(torch.from_numpy, args), 32,
                              use_kernel=use_kernel)
    assert ops.ssd_scan.launches == 0
    ry, rf = _ssd_chunked_oracle(*args)
    np.testing.assert_allclose(ty.numpy(), ry, **TOL)
    np.testing.assert_allclose(tf.numpy(), rf, **TOL)


@pytest.mark.parametrize("S", [8, 64])
def test_ssm_block_prefill_matches_jax(S):
    """Prefill output, final SSM state and conv rings (S < chunk, and two
    chunks of SMOKE's 32)."""
    jcfg, tcfg = _configs()
    jp, tp = _block_params(jcfg)
    x = _np(2, S, jcfg.d_model, seed=6)
    jy, (jst, jconv) = JSSM.ssm_block(jp, jnp.asarray(x), jcfg)
    ty, (tst, tconv) = TSSM.ssm_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
    for n in ("x", "B", "C"):
        np.testing.assert_allclose(tconv[n].numpy(), np.asarray(jconv[n]),
                                   **TOL)


def test_ssm_block_decode_matches_jax():
    """Three recurrent decode steps from a prefill's state and rings; each
    step also equals the prefill of the sequence grown by that token."""
    jcfg, tcfg = _configs()
    jp, tp = _block_params(jcfg)
    S = 8
    x = _np(2, S + 3, jcfg.d_model, seed=7)
    _, (jst, jconv) = JSSM.ssm_block(jp, jnp.asarray(x[:, :S]), jcfg)
    _, (tst, tconv) = TSSM.ssm_block(tp, torch.from_numpy(x[:, :S]), tcfg)
    for t in range(S, S + 3):
        xt = x[:, t:t + 1]
        jy, (jst, jconv) = JSSM.ssm_block(jp, jnp.asarray(xt), jcfg,
                                          state=jst, conv_cache=jconv)
        ty, (tst, tconv) = TSSM.ssm_block(tp, torch.from_numpy(xt), tcfg,
                                          state=tst, conv_cache=tconv)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
        for n in ("x", "B", "C"):
            np.testing.assert_allclose(tconv[n].numpy(),
                                       np.asarray(jconv[n]), **TOL)
        whole, _ = TSSM.ssm_block(tp, torch.from_numpy(x[:, :t + 1]), tcfg)
        torch.testing.assert_close(ty[:, 0], whole[:, -1], **TOL)


def test_ssm_state_specs_match_jax():
    jcfg, tcfg = _configs()
    jsp = JSSM.ssm_state_specs(jcfg, 3, 5)
    tsp = TSSM.ssm_state_specs(tcfg, 3, 5)
    assert tsp["state"] == (jsp["state"].shape, torch.float32)
    for n in ("x", "B", "C"):
        assert tsp["conv"][n][0] == jsp["conv"][n].shape
    st = TSSM.init_ssm_state(tcfg, 3, 5, "cpu")
    assert tuple(st["state"].shape) == jsp["state"].shape
    assert not bool(st["state"].any())


def test_ssd_kernel_flag_refuses_autograd():
    """With use_ssd_kernel the prefill goes through ops.ssd_scan, which has
    no backward: a block whose weights require a gradient raises while
    autograd records, and runs under no_grad.  The plain path
    differentiates."""
    jcfg, tcfg = _configs()
    tcfg = tcfg.with_(use_ssd_kernel=True)
    _, tp = _block_params(jcfg)
    x = torch.from_numpy(_np(1, 32, jcfg.d_model, seed=8))
    tp["wx"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        TSSM.ssm_block(tp, x, tcfg)
    with torch.no_grad():
        y_kernel, _ = TSSM.ssm_block(tp, x, tcfg)
    y, _ = TSSM.ssm_block(tp, x, tcfg.with_(use_ssd_kernel=False))
    y.sum().backward()
    assert bool(torch.isfinite(tp["wx"].grad).all())
    assert torch.equal(y.detach(), y_kernel)
