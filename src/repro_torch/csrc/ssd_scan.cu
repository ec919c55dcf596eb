// Mamba2 SSD chunk scan (forward) for sm_90a: chunk-parallel, on the
// tensor cores.
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (body `_kernel`; wrapper kernels/ops.py `ssd_scan`).  Same contract:
// xe (B,S,H,P) dt-scaled input (bf16 or fp32), loga (B,S,H) fp32 per-step
// log decay, b/c (B,S,N) shared across heads; y (B,S,H,P) fp32 and the
// final state (B,H,N,P) fp32; no D*x skip term.  With L the cumulative
// log decay inside a chunk and S_prev the (N,P) state entering it:
//   y   = (tril(exp(L_s - L_t)) o (c b^T)) xe  +  exp(L_s) (c . S_prev)
//   S  <- S exp(L_end) + (b o exp(L_end - L))^T xe
// S may be any length: the last chunk is ragged.  The JAX package asserts
// S % chunk == 0 here; this kernel reads zeros for xe, b and c and 0 for
// loga past S through bounds checks (no padded copy), which is exact: a
// padded step multiplies the state by exp(0) = 1 and adds 0, and a real
// row s only sees t <= s.  The kernel's chunk, its tile, is the requested
// chunk (up to 256) cut to 128 and halved further where a pass's shared
// memory would not fit (`kernel_tile`; ssd_scan_tile reports it, so that
// the wrapper sizes the workspace): the chunking is a tiling choice,
// every chunk length gives the same scan up to rounding.
//
// What bounds it on an H100: at the serve path's prefill (B 1, S 512,
// H 64, P = N = 64, bf16) the bytes (13.9 MB in and out, 8.4 MB of it the
// fp32 y) take 4.2 us at 3.35 TB/s; the products below, ~3 GFLOP of
// mma.sync with the planes counted, take ~3 us at 989 TFLOP/s.  Neither
// is near: each block runs a chain of dependent steps (loads, the L scan,
// a few hundred mma.sync a warp, stores) with one or two blocks an SM, so
// the time is that chain's latency, three grids deep (PERF.md).
//
// Design: the SSD chunk decomposition in three kernels on one stream, the
// second and third launched as programmatic dependent launches (each is
// scheduled while the one before runs and waits for it with
// griddepcontrol.wait):
//   1. chunk states, grid (chunk, head, batch), 8 warps: b and xe are
//      staged (cp.async) while one warp scans the cumulative log decay L
//      in float64; then s_c = b^T (exp(L_end - L) o xe), an
//      (N,P) product of depth Q on mma.sync, each warp two 16x16 tiles at
//      a time, is written to a workspace with exp(L_end);
//   2. state passing, grid (N*P/1024, head, batch): the only serial part,
//      elementwise: walks the chunks in order (the loads of four chunks in
//      flight at once), turns each chunk's state into the state entering
//      it (in place) and writes the final state;
//   3. chunk scan, grid (chunk, head, batch), 8 warps (4 for P 16): c and
//      b are staged and the causal half of c b^T is built on the tensor
//      cores and kept in shared memory in the accumulators' layout.  It is
//      built again for every head: blocks that took two heads and shared
//      it were slower on the card (PERF.md, Findings).  Warp w owns the row
//      tiles w % 4 and 7 - w % 4 of 16 rows (nine 16-column tiles of the
//      causal triangle in all, so it splits evenly) and half of P.
//      exp(L_s) (c . S_prev) and the masked tile times xe accumulate in
//      registers and y is written once, as 16-byte stores.  Below the
//      diagonal the mask exp(L_s - L_t) is a product of three tabled
//      factors, each at most 1 (R[s] D[tile pair] F[t], see decay_tables);
//      on the diagonal tile it is exp of the float64 difference.  The
//      stages before the first read of S_prev (c, b, xe, L, the tables,
//      c b^T) run before griddepcontrol.wait; S_prev's planes then
//      overlay b's tile.  At zamba2's prefill (256 blocks) a block fits
//      twice on an SM.  The loops over tiles stay rolled: unrolled, they
//      were as slow.
// Precision against the 1e-4 gate: xe, b and c in bf16 are exact
// mma.sync operands, and products of two of them are exact in the fp32
// accumulators.  The operands that are fp32 -- the masked scores
// G = exp(L_s - L_t) (c b^T), the decayed xe of pass 1, S_prev -- are fed
// as three bf16 planes (three mma.sync, ~2^-26 relative): one plane (bf16)
// or TF32 is far off, and two planes (~2^-17) missed the 1e-4 gate on the
// card at zamba2's prefill, where y's terms cancel.  fp32 inputs
// (the tests; no serve path) take the same kernels with xe, b and c split
// into three planes too, six mma.sync a product (the plane pairs i + j < 3).
// L is summed in float64, as in the plain version: at strong decay it
// reaches ~-120 in a chunk, where fp32 resolves it to ~1e-5.  The
// exponential of the decay mask is taken only where t <= s (above the
// diagonal L_s - L_t > 0 and overflows at strong decay, and inf * 0 would
// be NaN).  Built without fast math: the inter-chunk factors exp(L) reach
// fp32 subnormals.  Every reduction has a fixed order and there are no
// atomics: two identical calls give bit-identical outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm80.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxChunk = 256;      // the largest chunk a caller asks for
constexpr int kMaxQ = 128;          // the kernel's chunk (8 row tiles)
constexpr int kThreadsState = 256;  // pass 1: 8 warps
constexpr int kThreadsPass = 256;   // pass 2: 4 state entries a thread
// pass 3: 4 warps, each with 2 row tiles, times 2 halves of P (P >= 32)
__host__ __device__ constexpr int scan_threads(int P) {
  return P >= 32 ? 256 : 128;
}
constexpr int kItems = 9;           // 16x16 tiles of c b^T a pass-3 warp owns
constexpr int kSmemMax = 232448;    // an H100 block's opt-in limit
constexpr unsigned kFull = 0xffffffffu;

// bf16 planes a value is held in: bf16 inputs are exact in one; fp32
// values (fp32 inputs, and the fp32 factors of every product) in three
constexpr int kF = 3;
template <typename T>
constexpr int kIn = std::is_same<T, float>::value ? kF : 1;

__host__ __device__ constexpr int pad16(int q) { return (q + 15) / 16 * 16; }
// bf16 per shared-memory row: 16 bytes of padding keep the eight rows of
// an ldmatrix in eight different bank groups at every width
__host__ __device__ constexpr int row_stride(int cols) { return cols + 8; }

// pass 3's c b^T, as accumulator fragments: 4 row pairs x 9 tiles x 32
// lanes x 8 floats
constexpr int kCbFloats = 4 * 9 * 32 * 8;

// bf16 of pass 3's b tile, which S_prev's three planes overlay once
// c b^T is built
__host__ __device__ constexpr int bs_elems(int Qp, int N, int P, int in) {
  return in * Qp * row_stride(N) > kF * N * row_stride(P)
             ? in * Qp * row_stride(N) : kF * N * row_stride(P);
}

// floats of pass 3's decay tables a head: F and R (Qp each), D (8 x 8)
__host__ __device__ constexpr int kTables(int Qp) { return 2 * Qp + 64; }

// dynamic shared memory of passes 1 and 3; `in` = planes of the inputs
// (1 or 3)
__host__ __device__ constexpr int smem_state(int Qp, int N, int P, int in) {
  return Qp * 8 + in * Qp * (row_stride(N) + row_stride(P)) * 2
         + kF * Qp * row_stride(P) * 2;
}
__host__ __device__ constexpr int smem_scan(int Qp, int N, int P, int in) {
  return kCbFloats * 4 + Qp * 8 + kTables(Qp) * 4
         + in * Qp * row_stride(N) * 2 + bs_elems(Qp, N, P, in) * 2
         + in * Qp * row_stride(P) * 2;
}

// the kernel's chunk for a requested chunk Q: Q itself up to kMaxQ,
// halved while a pass's shared memory would not fit
constexpr int kernel_tile(int Q, int N, int P, int in) {
  int q = Q < kMaxQ ? Q : kMaxQ;
  while (q > 16 && (smem_state(pad16(q), N, P, in) > kSmemMax ||
                    smem_scan(pad16(q), N, P, in) > kSmemMax))
    q = (q + 1) / 2;
  return q;
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// (a, b) fp32 -> three bf16 pairs whose sum is (a, b) to ~2^-26 (two
// planes, ~2^-17, miss the 1e-4 gate where y cancels), a in the low halves
__device__ __forceinline__ void split3(float a, float b, uint32_t (&o)[kF]) {
#pragma unroll
  for (int i = 0; i < kF; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    o[i] = *reinterpret_cast<const uint32_t*>(&h);
    a -= f.x;
    b -= f.y;
  }
}

// d[n] += a . b over 2 NP n-blocks (b: NP x4 loads, n-blocks 2 np and
// 2 np + 1) and the planes whose magnitudes matter (i + j < 3: the rest
// is below 2^-26 of the product); plane pairs outside, n-blocks inside,
// so that neighbouring mma.sync feed different accumulators
template <int PA, int PB, int NP>
__device__ __forceinline__ void mma_planes(float (&d)[2 * NP][4],
                                           const uint32_t (&a)[PA][4],
                                           const uint32_t (&b)[NP][PB][4]) {
#pragma unroll
  for (int i = 0; i < PA; ++i)
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (i + j < kF) {
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          mma_bf16(d[2 * np], a[i], b[np][j][0], b[np][j][1]);
          mma_bf16(d[2 * np + 1], a[i], b[np][j][2], b[np][j][3]);
        }
      }
}

// eight consecutive elements as floats (16-byte aligned source)
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// eight floats into the three planes (plane stride `plane` elements)
__device__ __forceinline__ void store8_planes(bf16* dst, int plane,
                                              const float (&v)[8]) {
  uint32_t o[4][kF];
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(v[2 * i], v[2 * i + 1], o[i]);
#pragma unroll
  for (int k = 0; k < kF; ++k)
    *reinterpret_cast<uint4*>(dst + k * plane) =
        make_uint4(o[0][k], o[1][k], o[2][k], o[3][k]);
}

// eight consecutive staged elements as floats: the sum of NP planes
template <int NP>
__device__ __forceinline__ void load8_planes(const bf16* p, int plane,
                                             float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float w[8];
    load8(p + k * plane, w);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += w[e];
  }
}

// rows [0, rows) of a (rows x cols) tile into shared memory planes, row t
// from src + t * ld; rows >= valid are zeros.  bf16: 16-byte cp.async into
// one plane (the caller commits and waits); fp32: split into three,
// synchronously.
template <typename T>
__device__ __forceinline__ void stage(bf16* dst, int plane, const T* src,
                                      size_t ld, int valid, int rows,
                                      int cols, int tid, int nthreads) {
  const int per_row = cols / 8, sd = row_stride(cols);
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row, ch = (i % per_row) * 8;
    const bool ok = r < valid;
    if constexpr (kIn<T> == kF) {
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ok) load8(src + r * ld + ch, v);
      store8_planes(dst + r * sd + ch, plane, v);
    } else {
      cp_async16(smem_u32(dst + r * sd + ch), src + (ok ? r * ld : 0) + ch,
                 ok);
    }
  }
}

// ldmatrix x4 (trans or not) of each of NP planes
template <int NP, bool kTrans>
__device__ __forceinline__ void ldsm_planes(const bf16* p, int plane,
                                            uint32_t (&r)[NP][4]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if constexpr (kTrans)
      ldsm_x4_t(smem_u32(p + i * plane), r[i][0], r[i][1], r[i][2], r[i][3]);
    else
      ldsm_x4(smem_u32(p + i * plane), r[i][0], r[i][1], r[i][2], r[i][3]);
  }
}

// L[t] = sum_{u <= t} loga[u] over the chunk in float64, by one warp, for
// t < Qp (loga = 0 past the chunk's valid rows, so L stays at L_end)
__device__ __forceinline__ void chunk_L(double* L, const float* loga,
                                        size_t row0, int Qk, int Qp, int H,
                                        int h, int lane) {
  const int per = Qp / 32 + (Qp % 32 != 0);   // <= 4
  double v[4], run = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = lane * per + i;
    if (i < per && t < Qk)
      run += static_cast<double>(loga[(row0 + t) * H + h]);
    v[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  const double excl = incl - run;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = lane * per + i;
    if (i < per && t < Qp) L[t] = excl + v[i];
  }
}

// Pass 3's decay factors of a head, by the warp that scanned L (tiles of
// 16 positions; e(j) = 16 j + 15 ends tile j):
//   F[t] = exp(L[e(tile t)] - L[t]),  R[s] = exp(L[s] - L[16 tile(s) - 1]),
//   D[r][j] = exp(L[16 r - 1] - L[e(j)])  for j < r,
// so that exp(L_s - L_t) = R[s] D[r][j] F[t] for s in tile r, t in tile
// j < r.  Every factor is at most 1 (L falls), so none overflows where
// exp(L_s - L_t) itself is finite, and a factor that underflows leaves a
// product that underflows too.
__device__ __forceinline__ void decay_tables(const double* L, float* tab,
                                             int Qp, int lane) {
  float* F = tab;
  float* R = tab + Qp;
  float* D = tab + 2 * Qp;
  __syncwarp();   // L is this warp's
  for (int t = lane; t < Qp; t += 32) {
    F[t] = expf(static_cast<float>(L[t | 15] - L[t]));
    R[t] = t >= 16 ? expf(static_cast<float>(L[t] - L[(t & ~15) - 1])) : 1.f;
  }
  for (int i = lane; i < 64; i += 32) {
    const int r = i >> 3, j = i & 7;
    D[i] = j < r && r * 16 < Qp
               ? expf(static_cast<float>(L[r * 16 - 1] - L[j * 16 + 15]))
               : 0.f;
  }
}

// one m16n8 accumulator fragment stored as 16-byte rows: lane pairs swap
// halves so that each lane holds four consecutive columns of one row
// (even lanes row g, odd lanes row g + 8); rows >= valid are not stored
__device__ __forceinline__ void store_frag(float* dst, size_t ld, int r0,
                                           int col0, const float (&f)[4],
                                           int lane, int valid) {
  const int g = lane >> 2, q = lane & 3;
  const bool even = (q & 1) == 0;
  const float s0 = __shfl_xor_sync(kFull, even ? f[2] : f[0], 1);
  const float s1 = __shfl_xor_sync(kFull, even ? f[3] : f[1], 1);
  const int row = r0 + g + (even ? 0 : 8);
  const float4 v = even ? make_float4(f[0], f[1], s0, s1)
                        : make_float4(s0, s1, f[2], f[3]);
  if (row < valid)
    *reinterpret_cast<float4*>(dst + row * ld + col0 + 2 * (q & ~1)) = v;
}

// ---------------------------------------------------------------------------
// pass 1: each chunk's own state and decay
// ---------------------------------------------------------------------------
template <typename T, int P>
__global__ void __launch_bounds__(kThreadsState)
ssd_state_kernel(const T* __restrict__ xe, const float* __restrict__ loga,
                 const T* __restrict__ bm, float* __restrict__ st,
                 float* __restrict__ dec, int S, int H, int N, int Q,
                 int nc) {
  constexpr int kB = kIn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qp = pad16(Q), sN = row_stride(N), sP = row_stride(P);
  const int plN = Qp * sN, plP = Qp * sP;   // plane strides
  double* L = reinterpret_cast<double*>(smem_raw);
  bf16* bs = reinterpret_cast<bf16*>(L + Qp);   // b: kB planes
  bf16* xr = bs + kB * plN;                     // xe as staged: kB planes
  bf16* xs = xr + kB * plP;                     // exp(L_end - L) xe: kF

  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  const int Qk = min(Q, S - k * Q);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * Q;
  const size_t ld = static_cast<size_t>(H) * P;
  griddep_launch();   // let pass 2 be scheduled now

  // all loads at once: b and xe (cp.async), loga (warp 0's scan)
  stage<T>(bs, plN, bm + row0 * N, N, Qk, Qp, N, tid, kThreadsState);
  stage<T>(xr, plP, xe + row0 * ld + static_cast<size_t>(h) * P, ld, Qk, Qp,
           P, tid, kThreadsState);
  cp_commit();
  if (warp == 0) chunk_L(L, loga, row0, Qk, Qp, H, h, lane);
  cp_wait<0>();
  __syncthreads();
  const double l_end = L[Qk - 1];
  // every load of the conversion first, then the stores (the two do not
  // overlap in shared memory, which the compiler cannot see)
  constexpr int kConv = kMaxQ * P / 8 / kThreadsState;   // most a thread
  float v[kConv][8];
#pragma unroll
  for (int c = 0; c < kConv; ++c) {
    const int j = tid + c * kThreadsState;
    if (j < Qp * (P / 8))
      load8_planes<kB>(xr + (j / (P / 8)) * sP + (j % (P / 8)) * 8, plP,
                       v[c]);
  }
#pragma unroll
  for (int c = 0; c < kConv; ++c) {
    const int j = tid + c * kThreadsState;
    if (j < Qp * (P / 8)) {
      const int t = j / (P / 8), ch = (j % (P / 8)) * 8;
      const float w = t < Qk ? expf(static_cast<float>(l_end - L[t])) : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] *= w;
      store8_planes(xs + t * sP + ch, plP, v[c]);
    }
  }
  __syncthreads();

  const size_t slot = (static_cast<size_t>(b) * nc + k) * H + h;
  float* out = st + slot * N * P;
  // the warp's 16x16 tiles two at a time, u and u + 8: the same column
  // tile n (8 is a multiple of P / 16), so one B operand, and four
  // independent accumulators.  A = b^T (rows: state index, k: position),
  // read transposed; B = the decayed xe
  const int n_units = (N / 16) * (P / 16);   // 16x16 tiles of the state
  constexpr int kW = kThreadsState / 32;
  for (int u0 = warp; u0 < n_units; u0 += 2 * kW) {
    const bool two = u0 + kW < n_units;
    const int n = u0 % (P / 16);
    const int m[2] = {u0 / (P / 16), (u0 + kW) / (P / 16)};
    float acc[2][2][4] = {};
    for (int kk = 0; kk < Qp / 16; ++kk) {
      uint32_t a[2][kB][4], x[1][kF][4];
      ldsm_planes<kF, true>(xs + (kk * 16 + (lm & 1) * 8 + lr) * sP
                                + n * 16 + (lm >> 1) * 8, plP, x[0]);
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (v == 0 || two)
          ldsm_planes<kB, true>(bs + (kk * 16 + (lm >> 1) * 8 + lr) * sN
                                    + m[v] * 16 + (lm & 1) * 8, plN, a[v]);
      mma_planes(acc[0], a[0], x);
      if (two) mma_planes(acc[1], a[1], x);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (v == 0 || two) {
        store_frag(out, P, m[v] * 16, n * 16, acc[v][0], lane, N);
        store_frag(out, P, m[v] * 16, n * 16 + 8, acc[v][1], lane, N);
      }
    }
  }
  if (tid == 0) dec[slot] = expf(static_cast<float>(l_end));
}

// ---------------------------------------------------------------------------
// pass 2: the state entering each chunk, in place, and the final state
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreadsPass)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ dec,
                float* __restrict__ fin, int H, int NP, int nc) {
  griddep_launch();   // let pass 3 be scheduled (its prologue overlaps)
  const int e = (blockIdx.x * kThreadsPass + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  griddep_wait();     // pass 1's states and decays are complete
  if (e >= NP) return;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 4;   // chunks whose loads are in flight at once
  for (int k0 = 0; k0 < nc; k0 += kAhead) {
    float4 sv[kAhead];
    float dv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k0 + i < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + k0 + i) * H + h;
        sv[i] = *reinterpret_cast<const float4*>(st + slot * NP + e);
        dv[i] = dec[slot];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (k0 + i < nc) {
        const size_t slot = (static_cast<size_t>(b) * nc + k0 + i) * H + h;
        *reinterpret_cast<float4*>(st + slot * NP + e) = carry;
        const float d = dv[i];
        carry = make_float4(
            fmaf(carry.x, d, sv[i].x), fmaf(carry.y, d, sv[i].y),
            fmaf(carry.z, d, sv[i].z), fmaf(carry.w, d, sv[i].w));
      }
    }
  }
  *reinterpret_cast<float4*>(fin + (static_cast<size_t>(b) * H + h) * NP
                             + e) = carry;
}

// ---------------------------------------------------------------------------
// pass 3: y, the intra-chunk products and the entering state's term
// ---------------------------------------------------------------------------
template <typename T, int P>
__global__ void __launch_bounds__(scan_threads(P))
ssd_chunk_scan_kernel(const T* __restrict__ xe,
                      const float* __restrict__ loga,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ st, float* __restrict__ y,
                      int S, int H, int N, int Q, int nc) {
  constexpr int kThreads = scan_threads(P);
  constexpr int kPW = P / (kThreads / 128);   // columns of y a warp owns
  constexpr int kNB = kPW / 8;                // its n-blocks
  constexpr int kX = kIn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qp = pad16(Q), sN = row_stride(N), sP = row_stride(P);
  const int plN = Qp * sN, plX = Qp * sP, plS = N * sP;   // plane strides
  float4* cbs = reinterpret_cast<float4*>(smem_raw);    // c b^T fragments
  double* L = reinterpret_cast<double*>(cbs + kCbFloats / 4);
  float* F = reinterpret_cast<float*>(L + Qp);   // decay tables F, R, D
  const float* R = F + Qp;
  const float* D = F + 2 * Qp;
  bf16* cs = reinterpret_cast<bf16*>(F + kTables(Qp));   // c
  bf16* bs = cs + kX * plN;          // b: kX planes, then S_prev: kF
  bf16* ps = bs;
  bf16* xs = bs + bs_elems(Qp, N, P, kX);   // xe: kX planes

  const int k = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lm = lane >> 3, lr = lane & 7, g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, p0 = (warp >> 2) * kPW;   // row pair, columns
  const int Qk = min(Q, S - k * Q);
  const int nR = Qp / 16;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * Q;
  const size_t ld = static_cast<size_t>(H) * P;   // y / xe row stride

  // prologue, independent of pass 2
  stage<T>(cs, plN, cm + row0 * N, N, Qk, Qp, N, tid, kThreads);
  stage<T>(bs, plN, bm + row0 * N, N, Qk, Qp, N, tid, kThreads);
  stage<T>(xs, plX, xe + row0 * ld + static_cast<size_t>(h) * P, ld, Qk,
           Qp, P, tid, kThreads);
  cp_commit();
  if (warp == 0) {
    chunk_L(L, loga, row0, Qk, Qp, H, h, lane);
    decay_tables(L, F, Qp, lane);
  }
  cp_wait<0>();
  __syncthreads();

  // the causal half of c b^T for each row pair: item i <= wr is tile
  // (rA, i), the rest (rB, i - wr - 1); an item is two n-blocks, 8 floats
  // a lane, kept in shared memory in the accumulators' own layout (two
  // conflict-free 16-byte loads a lane).  The two warps of a row pair
  // build alternate items.  The loops stay rolled: their bodies run once.
  const int rA = wr, rB = 7 - wr;
  const int half = warp >> 2, n_half = kThreads / 128;
  float4* cbw = cbs + wr * kItems * 64;   // this row pair's items
#pragma unroll 1
  for (int i0 = half; i0 < kItems; i0 += 2 * n_half) {
    // two items at a time, four independent accumulators
    int r[2], j[2];
    bool ok[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = i0 + v * n_half;
      const bool first = i <= wr;
      r[v] = first ? rA : rB;
      j[v] = first ? i : i - wr - 1;
      ok[v] = i < kItems && r[v] < nR;
    }
    float t[2][2][4] = {};
#pragma unroll 1
    for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (!ok[v]) continue;
        uint32_t a[kX][4], b4[1][kX][4];
        ldsm_planes<kX, false>(cs + (r[v] * 16 + (lm & 1) * 8 + lr) * sN
                                   + kk * 16 + (lm >> 1) * 8, plN, a);
        ldsm_planes<kX, false>(bs + (j[v] * 16 + (lm >> 1) * 8 + lr) * sN
                                   + kk * 16 + (lm & 1) * 8, plN, b4[0]);
        mma_planes(t[v], a, b4);
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (!ok[v]) continue;
      const int i = i0 + v * n_half;
      cbw[(i * 32 + lane) * 2] =
          make_float4(t[v][0][0], t[v][0][1], t[v][0][2], t[v][0][3]);
      cbw[(i * 32 + lane) * 2 + 1] =
          make_float4(t[v][1][0], t[v][1][1], t[v][1][2], t[v][1][3]);
    }
  }

  constexpr int kPrev = kMaxQ * P / 8 / kThreads;   // S_prev loads a thread
  __syncthreads();   // c b^T is built: S_prev may overlay b
  if (k > 0) {   // S_prev of this chunk and head, in three planes
    griddep_wait();   // written by pass 2
    const float* sp = st + ((static_cast<size_t>(b) * nc + k) * H + h)
                           * N * P;
    float v[kPrev][8];   // all loads first, then the splits and stores
#pragma unroll
    for (int c = 0; c < kPrev; ++c) {
      const int j = tid + c * kThreads;
      if (j < N * (P / 8)) load8(sp + j * 8, v[c]);
    }
#pragma unroll
    for (int c = 0; c < kPrev; ++c) {
      const int j = tid + c * kThreads;
      if (j < N * (P / 8))
        store8_planes(ps + (j / (P / 8)) * sP + (j % (P / 8)) * 8, plS,
                      v[c]);
    }
    __syncthreads();
  }

  float* yb = y + row0 * ld + static_cast<size_t>(h) * P;
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {
    const int r = tt == 0 ? rA : rB;
    if (r >= nR) continue;
    const int s0 = r * 16 + g;
    float acc[kNB][4];
#pragma unroll
    for (int n = 0; n < kNB; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (k > 0) {   // exp(L_s) (c_s . S_prev)
#pragma unroll 1
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[kX][4];
        ldsm_planes<kX, false>(cs + (r * 16 + (lm & 1) * 8 + lr) * sN
                                   + kk * 16 + (lm >> 1) * 8, plN, a);
        uint32_t pv[kNB / 2][kF][4];
#pragma unroll
        for (int np = 0; np < kNB / 2; ++np)
          ldsm_planes<kF, true>(ps + (kk * 16 + (lm & 1) * 8 + lr) * sP
                                    + p0 + np * 16 + (lm >> 1) * 8, plS,
                                pv[np]);
        mma_planes(acc, a, pv);
      }
      const float e0 = expf(static_cast<float>(L[s0]));
      const float e1 = expf(static_cast<float>(L[s0 + 8]));
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
    // + (decay-masked c b^T) xe over the row tile's column tiles
    const float R0 = R[s0], R1 = R[s0 + 8];
    const int it0 = tt == 0 ? 0 : wr + 1, it1 = tt == 0 ? wr + 1 : kItems;
#pragma unroll 1
    for (int it = it0; it < it1; ++it) {
      const int j = it - it0;
      const float4 c0 = cbw[(it * 32 + lane) * 2];
      const float4 c1 = cbw[(it * 32 + lane) * 2 + 1];
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float gv[8];
      if (j < r) {   // below the diagonal: R[s] D[r][j] F[t]
        const float d = D[r * 8 + j], f0 = R0 * d, f1 = R1 * d;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int t = j * 16 + (e >> 2) * 8 + 2 * q + (e & 1);
          gv[e] = cv[e] * ((e >> 1) & 1 ? f1 : f0) * F[t];
        }
      } else {       // the diagonal tile: exp(L_s - L_t) where t <= s
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int s = s0 + ((e >> 1) & 1) * 8;
          const int t = j * 16 + (e >> 2) * 8 + 2 * q + (e & 1);
          gv[e] = t <= s ? cv[e] * expf(static_cast<float>(L[s] - L[t]))
                         : 0.f;
        }
      }
      uint32_t ag[kF][4], o[kF];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split3(gv[2 * e], gv[2 * e + 1], o);
#pragma unroll
        for (int pl = 0; pl < kF; ++pl) ag[pl][e] = o[pl];
      }
      uint32_t xv[kNB / 2][kX][4];
#pragma unroll
      for (int np = 0; np < kNB / 2; ++np)
        ldsm_planes<kX, true>(xs + (j * 16 + (lm & 1) * 8 + lr) * sP
                                  + p0 + np * 16 + (lm >> 1) * 8, plX,
                              xv[np]);
      mma_planes(acc, ag, xv);
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n)
      store_frag(yb, ld, r * 16, p0 + n * 8, acc[n], lane, Qk);
  }
  // every block waits before it ends: the grid's end must imply pass 2's
  // (the final state), also when no block of chunk > 0 exists
  if (k == 0) griddep_wait();
}

template <typename K>
cudaError_t opt_in(K kernel, int smem) {
  // above 48 KB dynamic shared memory must be granted (per device, and
  // cheap next to the kernels: set on every call)
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int P>
int launch(const void* xe_, const float* loga, const void* b_,
           const void* c_, float* y, float* fin, float* ws, int B, int S,
           int H, int N, int chunk, cudaStream_t stream) {
  const T* xe = static_cast<const T*>(xe_);
  const T* bm = static_cast<const T*>(b_);
  const T* cm = static_cast<const T*>(c_);
  const int Q = kernel_tile(chunk, N, P, kIn<T>);
  const int Qp = pad16(Q), nc = (S + Q - 1) / Q, NP = N * P;
  const int sm1 = smem_state(Qp, N, P, kIn<T>);
  const int sm3 = smem_scan(Qp, N, P, kIn<T>);
  if (sm1 > kSmemMax || sm3 > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  float* st = ws;                                      // (B,nc,H,N,P)
  float* dec = ws + static_cast<size_t>(B) * nc * H * NP;   // (B,nc,H)
  cudaError_t e = opt_in(ssd_state_kernel<T, P>, sm1);
  if (e == cudaSuccess) e = opt_in(ssd_chunk_scan_kernel<T, P>, sm3);
  if (e != cudaSuccess) return static_cast<int>(e);

  ssd_state_kernel<T, P><<<dim3(nc, H, B), kThreadsState, sm1, stream>>>(
      xe, loga, bm, st, dec, S, H, N, Q, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // passes 2 and 3: programmatic dependent launches
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((NP / 4 + kThreadsPass - 1) / kThreadsPass, H, B);
  cfg.blockDim = dim3(kThreadsPass);
  e = cudaLaunchKernelEx(&cfg, ssd_pass_kernel, st,
                         static_cast<const float*>(dec), fin, H, NP, nc);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(nc, H, B);
  cfg.blockDim = dim3(scan_threads(P));
  cfg.dynamicSmemBytes = sm3;
  e = cudaLaunchKernelEx(&cfg, ssd_chunk_scan_kernel<T, P>, xe, loga, bm, cm,
                         static_cast<const float*>(st), y, S, H, N, Q, nc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_p(const void* xe, const float* loga, const void* b,
               const void* c, float* y, float* fin, float* ws, int B, int S,
               int H, int P, int N, int chunk, cudaStream_t st) {
  switch (P) {
    case 16:
      return launch<T, 16>(xe, loga, b, c, y, fin, ws, B, S, H, N, chunk, st);
    case 32:
      return launch<T, 32>(xe, loga, b, c, y, fin, ws, B, S, H, N, chunk, st);
    case 64:
      return launch<T, 64>(xe, loga, b, c, y, fin, ws, B, S, H, N, chunk, st);
    case 128:
      return launch<T, 128>(xe, loga, b, c, y, fin, ws, B, S, H, N, chunk,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool supported(int v) { return v == 16 || v == 32 || v == 64 || v == 128; }

}  // namespace

// The kernel's chunk for a requested chunk (1..256) at head dim P, state
// size N and dtype (of xe, b and c: 0 = float32, 1 = bfloat16), or 0 for
// what the kernel does not take.  The workspace of ssd_scan_fwd holds
// nc = ceil(S / tile) chunks.
extern "C" int ssd_scan_tile(int chunk, int P, int N, int dtype) {
  if (chunk <= 0 || chunk > kMaxChunk || !supported(P) || !supported(N) ||
      (dtype != 0 && dtype != 1))
    return 0;
  return kernel_tile(chunk, N, P, dtype == 0 ? kF : 1);
}

// dtype as above; loga, y and final are float32.  chunk is the requested
// chunk (1..256), scanned in tiles of ssd_scan_tile(chunk, P, N, dtype);
// ws is a float32 workspace of B*nc*H*(N*P + 1) elements, nc = ceil(S /
// tile) (the chunk states, then their decays).  Returns cudaGetLastError()
// after the launches (0 = launched), or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int ssd_scan_fwd(const void* xe, const void* loga, const void* b,
                            const void* c, void* y, void* fin, void* ws,
                            int B, int S, int H, int P, int N, int chunk,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      B > 65535 || H > 65535 || !supported(P) || !supported(N))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* la = static_cast<const float*>(loga);
  float* yo = static_cast<float*>(y);
  float* fo = static_cast<float*>(fin);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return dispatch_p<float>(xe, la, b, c, yo, fo, w, B, S, H, P, N, chunk,
                             st);
  if (dtype == 1)
    return dispatch_p<bf16>(xe, la, b, c, yo, fo, w, B, S, H, P, N, chunk,
                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}
