"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Without a card every test skips (decided inside the test)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402

pytestmark = pytest.mark.gpu

FA_SHAPES = [
    # B, S, T, Hq, Hk, dh, causal, window
    (1, 200, 200, 16, 8, 128, True, None),   # qwen3-0.6b prefill, ragged
    (1, 512, 512, 16, 8, 128, True, None),
    (2, 256, 256, 8, 4, 64, True, 128),      # sliding window
    (1, 128, 384, 4, 4, 128, True, None),    # S < T (suffix)
    (2, 128, 128, 4, 2, 64, False, None),    # non-causal
    (1, 37, 37, 4, 2, 32, True, None),       # tiny, ragged, head_dim 32
]
PA_SHAPES = [
    # B, Np, P, n_max, Hq, Hk, dh
    (8, 400, 16, 40, 16, 8, 128),            # qwen3-0.6b decode, 8 slots
    (3, 16, 8, 4, 8, 2, 64),
    (2, 16, 4, 4, 4, 4, 32),
    (4, 32, 8, 8, 8, 8, 64),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _paged_case(B, Np, P, n_max, Hq, Hk, dh, dtype, seed=0):
    """Scrambled page ids, disjoint across rows; every page outside the
    rows' live prefixes poisoned with +-1e9."""
    r = np.random.RandomState(seed)
    q = r.randn(B, Hq, dh).astype(np.float32)
    kp = r.randn(Np, P, Hk, dh).astype(np.float32)
    vp = r.randn(Np, P, Hk, dh).astype(np.float32)
    ids = r.permutation(Np)[:B * n_max].reshape(B, n_max).astype(np.int32)
    pos = r.randint(0, n_max * P, size=B).astype(np.int32)
    live = {int(ids[b, j]) for b in range(B)
            for j in range(int(pos[b]) // P + 1)}
    stale = [p for p in range(Np) if p not in live]
    kp[stale], vp[stale] = 1e9, -1e9
    f = [torch.from_numpy(a).cuda().to(dtype) for a in (q, kp, vp)]
    return f + [torch.from_numpy(ids).cuda(), torch.from_numpy(pos).cuda()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,Hq,Hk,dh,causal,window", FA_SHAPES)
def test_flash_kernel_matches_plain(B, S, T, Hq, Hk, dh, causal, window,
                                    dtype):
    _cuda()
    dt, tol = getattr(torch, dtype), TOL[dtype]
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn(B, S, Hq, dh, generator=g, device="cuda").to(dt)
    k = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
    v = torch.randn(B, T, Hk, dh, generator=g, device="cuda").to(dt)
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = FA.reference(q, k, v, causal=causal, window=window)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Np,P,n_max,Hq,Hk,dh", PA_SHAPES)
def test_paged_kernel_matches_plain(B, Np, P, n_max, Hq, Hk, dh, dtype):
    _cuda()
    tol = TOL[dtype]
    args = _paged_case(B, Np, P, n_max, Hq, Hk, dh, getattr(torch, dtype))
    out = PA.paged_attention(*args)
    torch.cuda.synchronize()
    ref = PA.reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_kernels_reject_what_they_do_not_take():
    _cuda()
    q = torch.zeros(1, 8, 4, 48, device="cuda")   # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 8, 4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention(q, q[:, :, :2].contiguous(),
                           q[:, :, :2].contiguous())


def test_wrappers_count_kernel_launches():
    _cuda()
    ops.reset_launches()
    q = torch.randn(1, 64, 4, 64, device="cuda")
    k = torch.randn(1, 64, 2, 64, device="cuda")
    ops.flash_attention(q, k, k)
    ops.paged_attention(*_paged_case(2, 16, 4, 4, 4, 4, 32, torch.float32))
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == 1
    assert ops.paged_attention.launches == 1
