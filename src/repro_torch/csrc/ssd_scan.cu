// Mamba2 SSD chunk scan (forward) for sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (body `_kernel`; wrapper kernels/ops.py `ssd_scan`).  Same contract:
// xe (B,S,H,P) dt-scaled input, loga (B,S,H) fp32 per-step log decay, b/c
// (B,S,N) shared across heads; chunk length Q = min(chunk, S) with S % Q == 0.
// For each (batch row, head), walking the chunks in order with an (N,P)
// fp32 state S carried from one to the next (L = cumulative log decay
// within the chunk):
//   y   = (tril(exp(L_s - L_t)) o (c b^T)) xe  +  exp(L_s) (c . S)
//   S  <- S exp(L_end) + (b o exp(L_end - L))^T xe
// y (B,S,H,P) fp32 and, after the last chunk, S as final (B,H,N,P) fp32.
// No D*x skip term: the model adds it after the scan.  Products and
// exponentials are fp32 whatever the input type; L alone is summed in fp64
// (one 256-value scan a chunk), as in the plain version: at strong decay L
// reaches ~-100 in a chunk, where fp32 keeps ~1e-5 of it, and L_s - L_t near
// the diagonal would cancel two such values.  The exponential of the decay
// mask is taken only where t <= s (above the diagonal L_s - L_t > 0 and
// overflows to inf at strong decay, and inf * 0 would be NaN).  Build
// without fast math: the inter-chunk factors exp(L) reach fp32 subnormals.
//
// What bounds it on an H100: for the serve path's prefill (S = 512, H = 64,
// P = N = 64, Q = 128) the bytes (13.9 MB in and out) take 4.2 us at
// 3.35 TB/s and the ~1.6 GFLOP of the causal products 1.6 us at the bf16
// tensor rate: bytes bound it.  This first version runs on the fp32 FMA
// units and computes each chunk's (Q,Q) score tile once per P-tile, so the
// FMA issue rate and shared memory, not either bound, limit it.
//
// Design: one block of 256 threads per (P-tile of 32 columns, head, batch
// row) -- the P columns of y and of the state are independent, so B = 1,
// H = 64, P = 64 gives 128 blocks for 132 SMs.  The TPU's sequential chunk
// axis becomes a loop inside the block; the state lives in shared memory
// across it.  A chunk is done in 64-row tiles of y: the rows' c is staged
// once, then for each 64-column tile of source positions up to the
// diagonal, b and xe are staged and the decay-masked score tile G (64 x 64)
// is built with a 4 x 4 register micro-tile per thread and applied to xe.
// Inner products read shared memory four floats at a time (float4) and
// reuse each value across a thread's rows, about one load per three FMAs.
// Tiles (not a whole Q x Q tile) keep shared memory at 71 kB for N = 64 and
// 113 kB for N = 128 at any Q up to 256.  The cumulative log decay is a
// block-wide shuffle scan.  Padded rows beyond Q read zeros and are not
// stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // rows of y per tile, and source positions
constexpr int kPad = kTile + 4;   // a G row / transposed b row, 16 B aligned
constexpr int kMaxQ = 256;     // the scan covers one chunk per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxState = 16;  // state entries a thread owns (N=128, PT=32)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// shared-memory floats: L and warp totals (doubles), state, c rows, b tile
// (row-major for the scores, transposed for the state update), xe tile, G
__host__ __device__ constexpr int smem_floats(int N, int PT) {
  return 2 * (kMaxQ + kWarps) + N * PT + kTile * (N + 4)
         + max_i(kTile * (N + 4), N * kPad) + kTile * PT + kTile * kPad;
}

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xe, const float* __restrict__ loga,
                const T* __restrict__ bm, const T* __restrict__ cm,
                float* __restrict__ y, float* __restrict__ fin, int S, int H,
                int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  // rows of N + 4 floats: 16-byte aligned, and a quarter warp's float4
  // loads of 8 different rows fall in 8 different bank groups
  const int NP = N + 4;
  double* Ls = reinterpret_cast<double*>(smem);  // [kMaxQ] cumulative decay
  double* wtot = Ls + kMaxQ;            // [kWarps] scan carries
  float* St = reinterpret_cast<float*>(wtot + kWarps);   // [N][PT] state
  float* cs = St + N * PT;              // [kTile][N+4] c of the row tile
  float* bs = cs + kTile * NP;          // [kTile][N+4] b; [N][kPad] b^T
  float* xs = bs + max_i(kTile * NP, N * kPad);   // [kTile][PT] xe
  float* Gs = xs + kTile * PT;          // [kTile][kPad] masked scores

  constexpr int kRowStep = kThreads / PT;   // rows between a thread's outputs
  constexpr int kRowsPer = kTile / kRowStep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  // a thread's outputs: column pc of rows r0 + k * kRowStep of a y tile,
  // and of state rows n = r0 + k * kRowStep (k < N * PT / kThreads)
  const int pc = tid % PT, r0 = tid / PT;
  const int n_state = N * PT / kThreads;
  const int gx = tid & 15, gy = tid >> 4;   // score micro-tile coordinates

  const size_t row0 = static_cast<size_t>(b) * S;   // (b, 0) in (B,S,...)
  for (int i = tid; i < N * PT; i += kThreads) St[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // L: inclusive scan of loga over the chunk (a warp shuffle scan, then
    // the warps' totals)
    double v = tid < Q ? loga[(row0 + c0 + tid) * H + h] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += wtot[w];
    if (tid < Q) Ls[tid] = v;

    for (int s0 = 0; s0 < Q; s0 += kTile) {
      __syncthreads();   // L written; the previous tiles are consumed
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int s = i / N, n = i % N;
        cs[s * NP + n] =
            s0 + s < Q ? to_f(cm[(row0 + c0 + s0 + s) * N + n]) : 0.f;
      }
      __syncthreads();
      // inter-chunk term exp(L_s) (c_s . S_prev)
      float acc[kRowsPer];
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) acc[k] = 0.f;
      if (c0 > 0) {
        for (int n = 0; n < N; n += 4) {
          const float e0 = St[n * PT + pc], e1 = St[(n + 1) * PT + pc];
          const float e2 = St[(n + 2) * PT + pc], e3 = St[(n + 3) * PT + pc];
#pragma unroll
          for (int k = 0; k < kRowsPer; ++k) {
            const float4 cv = ld4(&cs[(r0 + k * kRowStep) * NP + n]);
            acc[k] = fmaf(cv.x, e0, fmaf(cv.y, e1, fmaf(cv.z, e2,
                     fmaf(cv.w, e3, acc[k]))));
          }
        }
#pragma unroll
        for (int k = 0; k < kRowsPer; ++k) {
          const int sg = s0 + r0 + k * kRowStep;
          acc[k] = sg < Q ? acc[k] * expf(static_cast<float>(Ls[sg])) : 0.f;
        }
      }
      // intra-chunk term over the source tiles up to the diagonal
      const int t_end = min(Q, s0 + kTile);
      for (int t0 = 0; t0 < t_end; t0 += kTile) {
        __syncthreads();
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int t = i / N, n = i % N;
          bs[t * NP + n] =
              t0 + t < Q ? to_f(bm[(row0 + c0 + t0 + t) * N + n]) : 0.f;
        }
        for (int i = tid; i < kTile * PT; i += kThreads) {
          const int t = i / PT, p = i % PT;
          xs[i] = t0 + t < Q
                      ? to_f(xe[((row0 + c0 + t0 + t) * H + h) * P + p0 + p])
                      : 0.f;
        }
        __syncthreads();
        // G[s][t] = exp(L_s - L_t) (c_s . b_t) for t <= s, else 0: a 4 x 4
        // micro-tile (rows gy + 16 i, columns gx + 16 j) per thread
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ld4(&cs[(gy + 16 * i) * NP + n]);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = ld4(&bs[(gx + 16 * j) * NP + n]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              g[i][j] = fmaf(cv[i].x, bv[j].x, fmaf(cv[i].y, bv[j].y,
                        fmaf(cv[i].z, bv[j].z, fmaf(cv[i].w, bv[j].w,
                                                    g[i][j]))));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = gy + 16 * i, t = gx + 16 * j;
            const int sg = s0 + s, tg = t0 + t;
            float w = 0.f;
            if (tg <= sg && sg < Q)
              w = expf(static_cast<float>(Ls[sg] - Ls[tg])) * g[i][j];
            Gs[s * kPad + t] = w;
          }
        }
        __syncthreads();
        for (int t = 0; t < kTile; t += 4) {
          const float x0 = xs[t * PT + pc], x1 = xs[(t + 1) * PT + pc];
          const float x2 = xs[(t + 2) * PT + pc], x3 = xs[(t + 3) * PT + pc];
#pragma unroll
          for (int k = 0; k < kRowsPer; ++k) {
            const float4 gv = ld4(&Gs[(r0 + k * kRowStep) * kPad + t]);
            acc[k] = fmaf(gv.x, x0, fmaf(gv.y, x1, fmaf(gv.z, x2,
                     fmaf(gv.w, x3, acc[k]))));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        const int sg = s0 + r0 + k * kRowStep;
        if (sg < Q) y[((row0 + c0 + sg) * H + h) * P + p0 + pc] = acc[k];
      }
    }

    // state update S <- S exp(L_end) + (b o exp(L_end - L))^T xe, over the
    // source tiles, with b staged transposed and the thread's entries in
    // registers
    __syncthreads();   // every row tile has read S_prev
    const double l_end = Ls[Q - 1];
    const float d_end = expf(static_cast<float>(l_end));
    float sacc[kMaxState];
#pragma unroll
    for (int k = 0; k < kMaxState; ++k)
      sacc[k] = k < n_state ? St[(r0 + k * kRowStep) * PT + pc] * d_end : 0.f;
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      __syncthreads();
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int t = i / N, n = i % N;
        bs[n * kPad + t] =
            t0 + t < Q ? to_f(bm[(row0 + c0 + t0 + t) * N + n]) : 0.f;
      }
      for (int i = tid; i < kTile * PT; i += kThreads) {
        const int t = i / PT, p = i % PT;
        xs[i] = t0 + t < Q
                    ? expf(static_cast<float>(l_end - Ls[t0 + t])) *
                          to_f(xe[((row0 + c0 + t0 + t) * H + h) * P + p0 + p])
                    : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < kTile; t += 4) {
        const float x0 = xs[t * PT + pc], x1 = xs[(t + 1) * PT + pc];
        const float x2 = xs[(t + 2) * PT + pc], x3 = xs[(t + 3) * PT + pc];
#pragma unroll
        for (int k = 0; k < kMaxState; ++k) {
          if (k < n_state) {
            const float4 bv = ld4(&bs[(r0 + k * kRowStep) * kPad + t]);
            sacc[k] = fmaf(bv.x, x0, fmaf(bv.y, x1, fmaf(bv.z, x2,
                      fmaf(bv.w, x3, sacc[k]))));
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxState; ++k)
      if (k < n_state) St[(r0 + k * kRowStep) * PT + pc] = sacc[k];
    __syncthreads();   // the state is complete before the next chunk reads it
  }

  for (int i = tid; i < N * PT; i += kThreads) {
    const int n = i / PT, p = i % PT;
    fin[((static_cast<size_t>(b) * H + h) * N + n) * P + p0 + p] = St[i];
  }
}

template <typename T, int PT>
int launch(const void* xe, const float* loga, const void* bm, const void* cm,
           float* y, float* fin, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int smem = smem_floats(N, PT) * static_cast<int>(sizeof(float));
  // above 48 KB dynamic shared memory must be granted (per device, so on
  // every launch: the call is cheap next to the kernel)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(P / PT, H, B);
  ssd_scan_kernel<T, PT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xe), loga, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, fin, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_pt(const void* xe, const float* loga, const void* bm,
                const void* cm, float* y, float* fin, int B, int S, int H,
                int P, int N, int Q, cudaStream_t st) {
  if (P == 16)
    return launch<T, 16>(xe, loga, bm, cm, y, fin, B, S, H, P, N, Q, st);
  return launch<T, 32>(xe, loga, bm, cm, y, fin, B, S, H, P, N, Q, st);
}

bool supported(int v) { return v == 16 || v == 32 || v == 64 || v == 128; }

}  // namespace

// dtype (of xe, b and c): 0 = float32, 1 = bfloat16; loga, y and final are
// float32.  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int ssd_scan_fwd(const void* xe, const void* loga, const void* b,
                            const void* c, void* y, void* fin, int B, int S,
                            int H, int P, int N, int Q, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || S % Q != 0 ||
      !supported(P) || !supported(N))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* la = static_cast<const float*>(loga);
  float* yo = static_cast<float*>(y);
  float* fo = static_cast<float*>(fin);
  if (dtype == 0)
    return dispatch_pt<float>(xe, la, b, c, yo, fo, B, S, H, P, N, Q, st);
  if (dtype == 1)
    return dispatch_pt<__nv_bfloat16>(xe, la, b, c, yo, fo, B, S, H, P, N, Q,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}
