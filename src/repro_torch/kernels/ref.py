"""Plain PyTorch versions of the kernels (attention, the SSD chunk scan,
natural compression).

The same semantics as the JAX package's ``kernels/ref.py`` oracles.
Attention: scores in fp32, probabilities cast to ``v.dtype`` before the
PV product, masked scores set to ``NEG_INF`` (so a fully masked row
averages uniformly, where the kernels emit 0).  SSD: ``ssd_ref`` is the
sequential recurrence, ``ssd_scan_ref`` the chunked form with the
kernel's contract, all in fp32.  Natural compression:
exponents read from the float's bit fields and powers of two built from
them, where the oracles take ``log2`` and ``exp2``.  The CPU path of every wrapper in
``kernels.ops`` runs these, and the tests and ``chip_smoke.py`` hold the
CUDA kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,Hq,dh); k,v: (B,T,Hk,dh), Hq % Hk == 0.  fp32 softmax.
    Queries end at key position T-1.  Returns (B,S,Hq,dh) in q.dtype."""
    B, S, Hq, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    sc = scale if scale is not None else dh ** -0.5
    qg = q.reshape(B, S, Hk, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * sc
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        m = kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, dh).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        pos: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,dh) one decode token per row, pos (B,) — attend
    idx <= pos[b]; or q (B,S,Hq,dh) S query rows per table row (a verify
    round's candidates), pos (B,S) — query (b, i) attends idx <= pos[b, i]
    through table row b.  k/v_pool: (Np,P,Hk,dh); block_tables: (B,n_max)
    page ids."""
    if q.dim() == 3:
        return paged_attention_ref(q[:, None], k_pool, v_pool, block_tables,
                                   pos[:, None], scale=scale)[:, 0]
    B, S, Hq, dh = q.shape
    _, P, Hk, _ = k_pool.shape
    G = Hq // Hk
    bt = block_tables.long()
    C = bt.shape[1] * P
    sc = scale if scale is not None else dh ** -0.5
    k = k_pool[bt].reshape(B, C, Hk, dh)
    v = v_pool[bt].reshape(B, C, Hk, dh)
    qg = q.reshape(B, S, Hk, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * sc
    valid = (torch.arange(C, device=q.device)[None, None, :]
             <= pos.long()[:, :, None])                       # (B,S,C)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD (Mamba2) chunk scan
# ---------------------------------------------------------------------------
def ssd_ref(xe: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor):
    """The sequential recurrence that SSD factorizes, step by step in fp32.

    xe (B,S,H,P) dt-scaled inputs; loga (B,S,H) per-step log decay; b, c
    (B,S,N) shared across heads.
        state_t = state_{t-1} * exp(loga_t) + b_t (x) xe_t
        y_t     = c_t . state_t
    Returns y (B,S,H,P) fp32 and the final state (B,H,N,P) fp32."""
    B, S, H, P = xe.shape
    N = b.shape[-1]
    xe, loga, b, c = xe.float(), loga.float(), b.float(), c.float()
    state = torch.zeros(B, H, N, P, dtype=torch.float32, device=xe.device)
    ys = []
    for t in range(S):
        upd = torch.einsum("bn,bhp->bhnp", b[:, t], xe[:, t])
        state = state * loga[:, t].exp()[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t], state))
    return torch.stack(ys, 1), state


def ssd_chunk_len(S: int, chunk: int) -> int:
    """The chunk length Q = min(chunk, S) that the scan tiles S into.  S
    need not be a whole number of chunks: the last chunk is ragged (the
    JAX package asserts here; the port pads that chunk exactly)."""
    Q = min(chunk, S)
    if Q < 1:
        raise ValueError(f"SSD scan: sequence length {S} or chunk {chunk} "
                         f"below 1")
    return Q


def ssd_scan_ref(xe: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int = 128):
    """The SSD chunk scan, the kernel's plain version: the same contract as
    the CUDA kernel and the Pallas one, without the ``D * x`` skip term.

    xe (B,S,H,P); loga (B,S,H); b, c (B,S,N); Q = min(chunk, S), any S.
    Within a chunk, y = (tril(exp(L_s - L_t)) * (c b^T)) xe with L the
    cumulative log decay; across chunks an (N,P) fp32 state carries over
    and adds exp(L_s) * c_s . S_prev.  The exponential is taken only
    where t <= s (above the diagonal L_s - L_t > 0 and may overflow), so
    the masked entries are exact zeros with zero gradients.

    A ragged last chunk is padded up to Q with xe = b = c = 0 and
    loga = 0, which is exact where the JAX package asserts: each padded
    step multiplies the state by exp(0) = 1 and adds 0 (x) 0, and a real
    row s sees only t <= s.  The padded rows of y are dropped.

    L is summed in float64, as in the CUDA kernel, where the JAX package
    sums it in fp32: at strong decay L reaches ~-100 within a chunk, where
    fp32 resolves it to ~1e-5, and L_s - L_t near the diagonal cancels two
    such values (against the float64 recurrence, fp32 L left the scan
    1.9e-4 off at loga ~ -0.9 a step, float64 L 1.4e-5).  Products and
    exponentials stay fp32.
    Returns y (B,S,H,P) fp32 and the final state (B,H,N,P) fp32."""
    B, S, H, P = xe.shape
    N = b.shape[-1]
    Q = ssd_chunk_len(S, chunk)
    nc = -(-S // Q)
    pad = nc * Q - S                                  # the ragged chunk's

    def padded(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    xc = padded(xe.float()).reshape(B, nc, Q, H, P)
    bc = padded(b.float()).reshape(B, nc, Q, N)
    cc = padded(c.float()).reshape(B, nc, Q, N)
    L = padded(loga.double()).reshape(B, nc, Q, H).cumsum(2)  # log decay
    diff = L[:, :, :, None] - L[:, :, None]           # (B,nc,Q,Q,H) [s, t]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=xe.device).tril()
    att = diff.masked_fill(~causal[:, :, None], float("-inf")).float().exp()
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    y = torch.einsum("bcqkh,bckhp->bcqhp", att * scores[..., None], xc)
    # each chunk's own state: sum_t exp(L_end - L_t) b_t xe_t^T
    dec_end = (L[:, :, -1:] - L).float().exp()        # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqhp->bchnp", bc,
                          xc * dec_end[..., None])
    chunk_decay = L[:, :, -1].float().exp()           # (B,nc,H)
    carry = torch.zeros(B, H, N, P, dtype=torch.float32, device=xe.device)
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    # across chunks: y_t += exp(L_t) c_t . S_prev
    y = y + torch.einsum("bcqn,bchnp->bcqhp", cc,
                         torch.stack(prev, 1)) * L.float().exp()[..., None]
    y = y.reshape(B, nc * Q, H, P)
    return (y[:, :S].contiguous() if pad else y), carry


# ---------------------------------------------------------------------------
# Natural compression: the uint8 wire format, uniforms given explicitly
# ---------------------------------------------------------------------------
NC_BIAS = 70                 # value = sign * 2^(code - 70); code 0 => zero
_MANT = 23                   # fp32 mantissa bits
_NORMAL_MIN_BITS = 1 << _MANT   # bit patterns below: zero or subnormal


def float_fields(a: torch.Tensor):
    """a: float32 >= 0.  Returns (e, p), int32 and float32, with
    a = 2^e (1 + p) and p in [0, 1) for every a > 0 — read from the bit
    fields (a subnormal is scaled by 2^23 first, exactly), never from
    ``log2``, which is inexact near powers of two on some backends."""
    sub = a.view(torch.int32) < _NORMAL_MIN_BITS
    bits = torch.where(sub, a * float(1 << _MANT), a).view(torch.int32)
    e = (bits >> _MANT) - 127 - torch.where(sub, _MANT, 0)
    p = (bits & (_NORMAL_MIN_BITS - 1)).float() * (1.0 / (1 << _MANT))
    return e, p


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exactly 2^e as float32, for int e in [-149, 127], from the bits."""
    e = e.int()
    normal = ((e + 127).clamp(min=1) << _MANT).view(torch.float32)
    subnormal = (1 << (e + 149).clamp(0, _MANT - 1)).view(torch.float32)
    return torch.where(e >= -126, normal, subnormal)


def nc_pack_ref(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic power-of-two rounding to the uint8 wire format: sign in
    bit 7, a 7-bit exponent code clipped to 1..127, code 0 for zero.

    x: float (fp32 or bf16, widened to fp32 exactly); u: fp32 uniforms in
    [0, 1) of x's shape.  With |x| = 2^e (1 + p), the code is e + 70, plus
    one when u < p."""
    a = x.float().abs()
    e, p = float_fields(a)
    code = torch.clamp(e + (u.float() < p).int() + NC_BIAS, 1, 127)
    code = torch.where(a == 0, 0, code)
    sign = torch.where(x < 0, 128, 0)
    return (code | sign).to(torch.uint8)


def nc_unpack_ref(b: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The wire format back to floats: exactly ``sign * 2^(code - 70)``,
    0 for code 0 (every such power is normal in fp32 and bf16)."""
    bi = b.int()
    code = bi & 0x7F
    mag = torch.where(code == 0, 0.0, pow2(code - NC_BIAS))
    return torch.where((bi & 0x80) != 0, -mag, mag).to(dtype)
