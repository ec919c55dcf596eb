// Flash attention forward (blockwise online softmax, GQA) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`; wrapper
// kernels/ops.py `flash_attention`).  Same semantics: q (B,S,Hq,dh),
// k/v (B,T,Hk,dh), queries aligned to the end of the keys (offset T-S),
// causal / sliding-window / full masking, q-head h reads kv-head h/G,
// fp32 softmax and accumulation, a row that sees no key emits 0.
//
// What bounds it on an H100: a causal prefill does 4*dh*S(S+1)/2
// operations per q-head against (q+k+v+o) bytes.  Against 989 TFLOP/s bf16
// and 3.35 TB/s, bytes bound it below S of about 900 (most prompts of the
// serve path, S = 257..512) and operations above.  This first version runs
// on the fp32 FMA units (67 TFLOP/s), which limit it far above either
// bound; mma/wgmma is the next step.
//
// Design: one block per (64-row query tile, q-head, batch row), two
// threads per query row, each owning half of the head dim in registers
// (its q slice pre-scaled, and its slice of the fp32 accumulator).  The
// block walks 32-key tiles up to the causal limit (tiles wholly outside
// the causal/window range are skipped), staging each K and V tile in
// shared memory as fp32 once for all 64 rows; the thread pair combines its
// two partial dot products with one shuffle.  K/V are read once per
// q-head and never duplicated per group.  Ragged S and T are handled by
// bounds masks, not padding.  Masked keys get probability exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per shared-memory tile
constexpr int kThreads = 2 * kBQ;   // two threads per query row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int Hq, int Hk, int causal, int has_window, int window,
                 float scale) {
  constexpr int kHalf = DH / 2;   // head-dim elements owned by one thread
  __shared__ __align__(16) float ks[kBK][DH];
  __shared__ __align__(16) float vs[kBK][DH];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / Hk);
  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;
  const int qi = q0 + row;
  const bool row_ok = qi < S;
  const int off = Tk - S;          // queries end at key position Tk-1
  const int qpos = qi + off;

  float qr[kHalf];
  float acc[kHalf];
  const T* qp = q + ((static_cast<size_t>(b) * S + (row_ok ? qi : 0)) * Hq
                     + h) * DH + half * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = row_ok ? to_f(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys visible to any row of this query tile
  int k_lo = 0, k_hi = Tk;
  if (causal) {
    k_hi = min(Tk, q0 + kBQ + off);
    if (has_window) k_lo = max(0, q0 + off - window + 1);
  }
  k_lo = (k_lo / kBK) * kBK;

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH, t = kt + j;
      float kk = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t g = ((static_cast<size_t>(b) * Tk + t) * Hk + hk) * DH + d;
        kk = to_f(k[g]);
        vv = to_f(v[g]);
      }
      ks[j][d] = kk;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(&ks[j][half * kHalf]);
      float a = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kHalf / 4; ++d4) {
        const float4 kk = kr[d4];
        a = fmaf(qr[4 * d4 + 0], kk.x, a);
        a = fmaf(qr[4 * d4 + 1], kk.y, a);
        a = fmaf(qr[4 * d4 + 2], kk.z, a);
        a = fmaf(qr[4 * d4 + 3], kk.w, a);
      }
      s[j] = a;
    }
    uint32_t visible = 0;
    float mcur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      const int t = kt + j;
      bool ok = t < Tk;
      if (causal) {
        ok = ok && t <= qpos;
        if (has_window) ok = ok && t > qpos - window;
      }
      if (ok) {
        visible |= 1u << j;
        mcur = fmaxf(mcur, s[j]);
      }
    }
    const float m_new = fmaxf(m, mcur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = (visible >> j & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][half * kHalf]);
#pragma unroll
      for (int d4 = 0; d4 < kHalf / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (!row_ok) return;
  const float safe = l == 0.f ? 1.f : l;   // a row that saw no key -> 0
  T* op = o + ((static_cast<size_t>(b) * S + qi) * Hq + h) * DH + half * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) op[d] = from_f<T>(acc[d] / safe);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int Hq, int Hk, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, Hq, Hk, causal,
      has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int Hq, int Hk, int dh, int causal,
                int has_window, int window, float scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                           window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                           window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                            window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Tk, int Hq, int Hk, int dh, int causal,
                                   int has_window, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Tk <= 0 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_dh<float>(q, k, v, o, B, S, Tk, Hq, Hk, dh, causal,
                              has_window, window, scale, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, B, S, Tk, Hq, Hk, dh,
                                      causal, has_window, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
