// Paged-attention decode (one query token per row, read through a block
// table) for sm_90a, split across a row's pages ("flash-decoding").
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`; wrapper
// kernels/ops.py `paged_attention`, which crops the table).  Same
// semantics: q (B,Hq,dh), k/v pools (Np,P,Hk,dh), block_tables (B,n)
// int32, pos (B,) int32; row b attends logical positions 0..pos[b], where
// position t lives in page block_tables[b, t/P] at offset t%P; pages
// wholly past pos[b] are never read (their table entries may name pages of
// other rows), nor are the positions past pos[b] of its last page; fp32
// softmax statistics and accumulation; q-head h reads kv-head h/G; a row
// that sees no key (pos[b] < 0) emits 0.
//
// What bounds it on an H100: each row reads its resident K and V once and
// does 4*Hq*dh operations per resident position, about 2 operations per
// byte, far below the card's ~295 operations per byte: it is bound by
// memory bandwidth (3.35 TB/s), so the bound is the resident K+V bytes.
// At decode sizes (14-28 MB) that is 4-8 us, the order of a kernel
// launch, so the design keeps the chain of dependent steps short and many
// loads in flight on every SM.
//
// Design.  Grid (n_splits, Hk, B): each block takes a fixed span of `span`
// pages of one row for one kv-head, with all G = Hq/Hk query heads of the
// group, so each K/V page is read once per kv-head.  `plan_splits` in
// kernels/paged_attention.py chooses the span so that the grid has at
// least two blocks per SM.  The block loads pos, its own block-table
// entries (the TPU's scalar prefetch) and q at once; a split wholly past
// pos[b] then exits, reading no page.  Its 4 warps walk the span's
// positions: a position's K and V rows are read with 16-byte loads (dh/8
// chunks a row in bf16, dh/4 in fp32) by a group of lanes, the power of
// two at least the chunk count and at most a warp (dh 96 in bf16: 12
// chunks on 16 lanes, 4 of them idle; dh 192 in fp32: 48 chunks on 32
// lanes, two chunks a lane, round-robin), 8/G positions a lane in flight
// at once; the G scores of a position are partial dot products reduced by
// shuffles across the row's lanes, which then fold the position into their
// own running max, normaliser and fp32 accumulator (one update per
// position and head, by the lanes that hold it, no thread walking
// positions it does not own).  The lanes' and warps' partial states are
// merged at the end of the block with the usual max-rescale.
// With one split the block writes the output.  Otherwise each split writes
// its partial (m, l, acc[G][dh]) in fp32 to a workspace the wrapper
// allocates, and a second small kernel, launched on the same stream by the
// same entry point as a programmatic dependent launch (it is scheduled
// while the split grid runs and waits for it with griddepcontrol.wait),
// merges the live splits in a fixed order.  No atomics: two calls on the
// same input give bit-identical outputs.
// Both dtypes take this design (templated on T): at ~2 operations a byte
// the tensor cores would not help.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSpan = 64;   // pages a split may take (its table in smem)
// K/V rows a lane loads at once, over the G heads it folds them into
constexpr int kRowsInFlight = 8;
constexpr float kLog2e = 1.4426950408889634f;

// the least power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// 16 bytes of T widened to fp32
__device__ __forceinline__ void widen(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float* f,
                                      __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp2 of x - m, with m = -inf (nothing seen yet) taken as 0 so that a
// state that saw nothing weighs exactly 0
__device__ __forceinline__ float weight(float x, float m) {
  return exp2f(x - (m == -INFINITY ? 0.f : m));
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ pos, T* __restrict__ o,
                    float* __restrict__ ws, int P, int Hk, int n_pages,
                    int bt_stride, int n_splits, int span,
                    float scale_log2) {
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int kChunks = DH / kVec;       // 16-byte chunks a K/V row
  // lanes per K/V row; lane c of a row takes chunks c, c + kLanes, ...
  // (those past the row are idle: none when kChunks is a power of two)
  constexpr int kLanes = kChunks >= 32 ? 32 : pow2_at_least(kChunks);
  constexpr int kC = (kChunks + kLanes - 1) / kLanes;   // chunks a lane
  constexpr int kE = kC * kVec;            // elements a lane holds a row
  constexpr int kRows = 32 / kLanes;       // rows a warp takes per step
  static_assert(DH % kVec == 0, "a row is whole 16-byte chunks");
  // rows a lane holds in flight
  constexpr int kU = kRowsInFlight > G ? kRowsInFlight / G : 1;
  constexpr int kStep = kWarps * kRows * kU;
  __shared__ int tbl[kMaxSpan];
  __shared__ float red_acc[kWarps][G][DH];
  __shared__ float red_ml[kWarps][G][2];

  // the merge grid may start launching now: it waits for this grid's
  // completion (griddepcontrol.wait) before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLanes, c = lane % kLanes;
  const int Hq = Hk * G;
  const int pg0 = split * span;
  const int t0 = pg0 * P;
  // pos, the split's table entries and q do not depend on each other:
  // their loads are all in flight at once
  const int p_b = pos[b];
  const int n_tbl = min(span, n_pages - pg0);
  const int page = tid < n_tbl ? bt[static_cast<size_t>(b) * bt_stride
                                    + pg0 + tid] : 0;
  bool live[kC];                           // chunk i of this lane is in
#pragma unroll
  for (int i = 0; i < kC; ++i) live[i] = c + i * kLanes < kChunks;
  uint4 qraw[G][kC];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < kC; ++i)
      qraw[g][i] = live[i] ? *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * Hq + hk * G + g) * DH
          + (c + i * kLanes) * kVec) : make_uint4(0u, 0u, 0u, 0u);
  if (t0 > p_b) {            // wholly past the row's position: read nothing
    if (n_splits == 1)       // (only pos < 0 gets here) no key -> 0
      for (int i = tid; i < G * DH; i += kThreads)
        o[(static_cast<size_t>(b) * Hq + hk * G) * DH + i] = from_f<T>(0.f);
    return;
  }
  const int t_end = min(min(t0 + span * P, n_pages * P), p_b + 1);
  if (tid < n_tbl) tbl[tid] = page;

  float qr[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < kC; ++i) widen(qraw[g][i], qr[g] + i * kVec, T());
#pragma unroll
    for (int e = 0; e < kE; ++e) qr[g][e] *= scale_log2;
  }
  float m[G], l[G], acc[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(Hk) * DH;
  const T* kb = kp + static_cast<size_t>(hk) * DH + c * kVec;
  const T* vb = vp + static_cast<size_t>(hk) * DH + c * kVec;
  for (int tb = t0; tb < t_end; tb += kStep) {
    uint4 kr[kU][kC], vr[kU][kC];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = tb + (u * kWarps + warp) * kRows + grp;
      ok[u] = t < t_end;
      size_t row = 0;
      if (ok[u]) {
        const int j = t / P;
        row = (static_cast<size_t>(tbl[j - pg0]) * P + (t - j * P))
              * row_stride;
      }
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        kr[u][i] = vr[u][i] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u] && live[i]) {
          kr[u][i] = *reinterpret_cast<const uint4*>(kb + row
                                                     + i * kLanes * kVec);
          vr[u][i] = *reinterpret_cast<const uint4*>(vb + row
                                                     + i * kLanes * kVec);
        }
      }
    }
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kE];
#pragma unroll
      for (int i = 0; i < kC; ++i) widen(kr[u][i], kf + i * kVec, T());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) a = fmaf(qr[g][e], kf[e], a);
#pragma unroll
        for (int sh = kLanes / 2; sh > 0; sh >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, sh);
        s[u][g] = ok[u] ? a : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = weight(m[g], mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = weight(s[u][g], mx);   // masked: exactly 0
        float vf[kE];
#pragma unroll
        for (int i = 0; i < kC; ++i) widen(vr[u][i], vf + i * kVec, T());
        l[g] += p;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // merge the warp's row groups (lanes kLanes apart), then the warps
#pragma unroll
  for (int sh = kLanes; sh < 32; sh <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], sh);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], sh);
      const float mn = fmaxf(m[g], m2);
      const float a1 = weight(m[g], mn), a2 = weight(m2, mn);
      l[g] = l[g] * a1 + l2 * a2;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float x2 = __shfl_xor_sync(0xffffffffu, acc[g][e], sh);
        acc[g][e] = acc[g][e] * a1 + x2 * a2;
      }
      m[g] = mn;
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < kC; ++i)
        if (live[i])
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            red_acc[warp][g][(c + i * kLanes) * kVec + e] =
                acc[g][i * kVec + e];
      if (c == 0) {
        red_ml[warp][g][0] = m[g];
        red_ml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float mn = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, red_ml[w][g][0]);
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = weight(red_ml[w][g][0], mn);
      sum = fmaf(red_ml[w][g][1], a, sum);
      out = fmaf(red_acc[w][g][d], a, out);
    }
    const size_t h = static_cast<size_t>(b) * Hq + hk * G + g;
    if (n_splits == 1) {
      o[h * DH + d] = from_f<T>(sum == 0.f ? 0.f : out / sum);
    } else {                 // partial of this split: acc, then (m, l)
      const size_t part = h * n_splits + split;
      ws[part * (DH + 2) + d] = out;
      if (d == 0) {
        ws[part * (DH + 2) + DH] = mn;
        ws[part * (DH + 2) + DH + 1] = sum;
      }
    }
  }
}

// one block per (q-head, row), one thread per column: the live splits'
// partials merged in split order
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
paged_merge_kernel(const float* __restrict__ ws, const int* __restrict__ pos,
                   T* __restrict__ o, int Hq, int P, int n_splits, int span) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int p_b = pos[b];
  const int live = p_b < 0 ? 0 : min(n_splits, p_b / (span * P) + 1);
  const float* part = ws + (static_cast<size_t>(b) * Hq + h) * n_splits
                           * (DH + 2);
  // launched early (programmatic dependent launch): wait here until the
  // split grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mn = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < live; ++s) mn = fmaxf(mn, part[s * (DH + 2) + DH]);
  float sum = 0.f, out = 0.f;
#pragma unroll 8
  for (int s = 0; s < live; ++s) {
    const float a = weight(part[s * (DH + 2) + DH], mn);
    sum = fmaf(part[s * (DH + 2) + DH + 1], a, sum);
    out = fmaf(part[s * (DH + 2) + d], a, out);
  }
  o[(static_cast<size_t>(b) * Hq + h) * DH + d] =
      from_f<T>(sum == 0.f ? 0.f : out / sum);
}

template <typename T, int DH, int G>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* pos, void* o, float* ws, int B, int Hk, int P,
           int n_pages, int bt_stride, int n_splits, int span, float scale,
           cudaStream_t st) {
  const dim3 grid(n_splits, Hk, B);
  paged_decode_kernel<T, DH, G><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(o), ws, P, Hk,
      n_pages, bt_stride, n_splits, span, scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  // programmatic dependent launch: the merge grid is launched while the
  // split grid runs, and waits for it inside (griddepcontrol.wait)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hk * G, B);
  cfg.blockDim = dim3(DH);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, DH>,
                         static_cast<const float*>(ws), pos,
                         static_cast<T*>(o), Hk * G, P, n_splits, span);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int dispatch_g(const void* q, const void* kp, const void* vp, const int* bt,
               const int* pos, void* o, float* ws, int B, int Hk, int G,
               int P, int n_pages, int bt_stride, int n_splits, int span,
               float scale, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, DH, 1>(q, kp, vp, bt, pos, o, ws, B, Hk, P, n_pages,
                              bt_stride, n_splits, span, scale, st);
    case 2:
      return launch<T, DH, 2>(q, kp, vp, bt, pos, o, ws, B, Hk, P, n_pages,
                              bt_stride, n_splits, span, scale, st);
    case 4:
      return launch<T, DH, 4>(q, kp, vp, bt, pos, o, ws, B, Hk, P, n_pages,
                              bt_stride, n_splits, span, scale, st);
    case 7:                            // 56/8 heads (arctic-480b)
      return launch<T, DH, 7>(q, kp, vp, bt, pos, o, ws, B, Hk, P, n_pages,
                              bt_stride, n_splits, span, scale, st);
    case 8:
      return launch<T, DH, 8>(q, kp, vp, bt, pos, o, ws, B, Hk, P, n_pages,
                              bt_stride, n_splits, span, scale, st);
    case 12:                           // 96/8 heads (nemotron-4-340b)
      return launch<T, DH, 12>(q, kp, vp, bt, pos, o, ws, B, Hk, P, n_pages,
                               bt_stride, n_splits, span, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dh(const void* q, const void* kp, const void* vp, const int* bt,
                const int* pos, void* o, float* ws, int B, int Hk, int G,
                int dh, int P, int n_pages, int bt_stride, int n_splits,
                int span, float scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return dispatch_g<T, 32>(q, kp, vp, bt, pos, o, ws, B, Hk, G, P,
                               n_pages, bt_stride, n_splits, span, scale, st);
    case 64:
      return dispatch_g<T, 64>(q, kp, vp, bt, pos, o, ws, B, Hk, G, P,
                               n_pages, bt_stride, n_splits, span, scale, st);
    case 96:                           // phi-3-vision-4.2b
      return dispatch_g<T, 96>(q, kp, vp, bt, pos, o, ws, B, Hk, G, P,
                               n_pages, bt_stride, n_splits, span, scale, st);
    case 128:
      return dispatch_g<T, 128>(q, kp, vp, bt, pos, o, ws, B, Hk, G, P,
                                n_pages, bt_stride, n_splits, span, scale, st);
    case 192:                          // nemotron-4-340b
      return dispatch_g<T, 192>(q, kp, vp, bt, pos, o, ws, B, Hk, G, P,
                                n_pages, bt_stride, n_splits, span, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  n_splits blocks per (row, kv-head),
// each over `span` pages; with n_splits > 1, `workspace` holds
// B*Hq*n_splits*(dh+2) floats.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_tables,
                                   const void* pos, void* o, void* workspace,
                                   int B, int Hq, int Hk, int dh, int P,
                                   int n_pages, int bt_stride, int n_splits,
                                   int span, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Hk <= 0 || Hq % Hk != 0 || P <= 0 || n_pages <= 0 ||
      n_splits <= 0 || span <= 0 || span > kMaxSpan ||
      static_cast<long long>(n_splits) * span < n_pages ||
      (n_splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hk;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ps = static_cast<const int*>(pos);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0)
    return dispatch_dh<float>(q, k_pool, v_pool, bt, ps, o, ws, B, Hk, G, dh,
                              P, n_pages, bt_stride, n_splits, span, scale,
                              st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(q, k_pool, v_pool, bt, ps, o, ws, B, Hk,
                                      G, dh, P, n_pages, bt_stride, n_splits,
                                      span, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
