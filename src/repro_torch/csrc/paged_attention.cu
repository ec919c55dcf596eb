// Paged-attention decode (one query token per row, read through a block
// table) for sm_90a.
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`; wrapper
// kernels/ops.py `paged_attention`, which crops the table).  Same
// semantics: q (B,Hq,dh), k/v pools (Np,P,Hk,dh), block_tables (B,n)
// int32, pos (B,) int32; row b attends logical positions 0..pos[b], where
// position t lives in page block_tables[b, t/P] at offset t%P; pages
// wholly past pos[b] are skipped (their table entries may name pages of
// other rows); fp32 online softmax over pages; a row that sees no key
// emits 0.
//
// What bounds it on an H100: each row reads its resident K and V once and
// does 4*Hq*dh operations per resident position, about 2 operations per
// byte, far below the card's ~295 operations per byte: it is bound by
// memory bandwidth (3.35 TB/s), so the bound is the resident K+V bytes.
//
// Design: one block per (kv-head, batch row) with dh threads, handling
// all G = Hq/Hk query heads of the group, so each K/V page is read from
// device memory once per kv-head, not once per q-head.  The block reads
// its own table row and pos, stages one (P, dh) K page and V page in
// shared memory as fp32, computes the G*P scores with warp-level dot
// products, and folds them into per-head running max, normaliser and
// accumulator (thread d owns column d of every head's accumulator).
// First limit to lift: at B=8, Hk=8 that is 64 blocks for 132 SMs and
// pages are walked one after another; splitting a row's pages across
// blocks (and a second pass to merge) would fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;

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

template <typename T, int DH, int G>
__global__ void __launch_bounds__(DH)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ pos, T* __restrict__ o, int P,
                    int Hk, int n_pages, int bt_stride, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;             // [P][DH]
  float* vs = ks + P * DH;      // [P][DH]
  float* qs = vs + P * DH;      // [G][DH], pre-scaled
  float* ss = qs + G * DH;      // [G][P] scores of the current page
  constexpr int kWarps = DH / 32;

  const int hk = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5;
  const int Hq = Hk * G;
  const int p_b = pos[b];

#pragma unroll
  for (int g = 0; g < G; ++g)
    qs[g * DH + d] =
        to_f(q[(static_cast<size_t>(b) * Hq + hk * G + g) * DH + d]) * scale;

  float acc[G], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  // pages wholly beyond the row's position are never read
  const int last = p_b < 0 ? -1 : min(n_pages - 1, p_b / P);
  for (int j = 0; j <= last; ++j) {
    const int page = bt[static_cast<size_t>(b) * bt_stride + j];
    __syncthreads();  // the previous page is consumed
    for (int idx = d; idx < P * DH; idx += DH) {
      const int r = idx / DH, c = idx % DH;
      const size_t gi = ((static_cast<size_t>(page) * P + r) * Hk + hk) * DH + c;
      ks[idx] = to_f(kp[gi]);
      vs[idx] = to_f(vp[gi]);
    }
    __syncthreads();

    for (int r = warp; r < P; r += kWarps) {
      float a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] = 0.f;
      for (int c = lane; c < DH; c += 32) {
        const float kk = ks[r * DH + c];
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] = fmaf(qs[g * DH + c], kk, a[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          a[g] += __shfl_xor_sync(0xffffffffu, a[g], sh);
        if (lane == 0) ss[g * P + r] = a[g];
      }
    }
    __syncthreads();

    const int n_vis = min(P, p_b - j * P + 1);  // live positions of page j
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mc = kNegInf;
      for (int r = 0; r < n_vis; ++r) mc = fmaxf(mc, ss[g * P + r]);
      const float mn = fmaxf(m[g], mc);
      const float alpha = expf(m[g] - mn);
      float sum = 0.f, av = 0.f;
      for (int r = 0; r < n_vis; ++r) {
        const float p = expf(ss[g * P + r] - mn);
        sum += p;
        av = fmaf(p, vs[r * DH + d], av);
      }
      l[g] = l[g] * alpha + sum;
      acc[g] = acc[g] * alpha + av;
      m[g] = mn;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float safe = l[g] == 0.f ? 1.f : l[g];  // no key seen -> 0
    o[(static_cast<size_t>(b) * Hq + hk * G + g) * DH + d] =
        from_f<T>(acc[g] / safe);
  }
}

template <typename T, int DH, int G>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* pos, void* o, int B, int Hk, int P, int n_pages,
           int bt_stride, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * P * DH + G * DH + G * P);
  const dim3 grid(Hk, B);
  paged_decode_kernel<T, DH, G><<<grid, DH, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), P, Hk, n_pages,
      bt_stride, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int dispatch_g(const void* q, const void* kp, const void* vp, const int* bt,
               const int* pos, void* o, int B, int Hk, int G, int P,
               int n_pages, int bt_stride, float scale, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, DH, 1>(q, kp, vp, bt, pos, o, B, Hk, P, n_pages,
                              bt_stride, scale, st);
    case 2:
      return launch<T, DH, 2>(q, kp, vp, bt, pos, o, B, Hk, P, n_pages,
                              bt_stride, scale, st);
    case 4:
      return launch<T, DH, 4>(q, kp, vp, bt, pos, o, B, Hk, P, n_pages,
                              bt_stride, scale, st);
    case 8:
      return launch<T, DH, 8>(q, kp, vp, bt, pos, o, B, Hk, P, n_pages,
                              bt_stride, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dh(const void* q, const void* kp, const void* vp, const int* bt,
                const int* pos, void* o, int B, int Hk, int G, int dh, int P,
                int n_pages, int bt_stride, float scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return dispatch_g<T, 32>(q, kp, vp, bt, pos, o, B, Hk, G, P, n_pages,
                               bt_stride, scale, st);
    case 64:
      return dispatch_g<T, 64>(q, kp, vp, bt, pos, o, B, Hk, G, P, n_pages,
                               bt_stride, scale, st);
    case 128:
      return dispatch_g<T, 128>(q, kp, vp, bt, pos, o, B, Hk, G, P, n_pages,
                                bt_stride, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_tables,
                                   const void* pos, void* o, int B, int Hq,
                                   int Hk, int dh, int P, int n_pages,
                                   int bt_stride, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hk <= 0 || Hq % Hk != 0 || P <= 0 || n_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hk;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ps = static_cast<const int*>(pos);
  if (dtype == 0)
    return dispatch_dh<float>(q, k_pool, v_pool, bt, ps, o, B, Hk, G, dh, P,
                              n_pages, bt_stride, scale, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k_pool, v_pool, bt, ps, o, B, Hk, G,
                                      dh, P, n_pages, bt_stride, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
