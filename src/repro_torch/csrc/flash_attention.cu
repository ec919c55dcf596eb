// Flash attention forward (blockwise online softmax, GQA) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`; wrapper
// kernels/ops.py `flash_attention`).  Same semantics: q (B,S,Hq,dh),
// k/v (B,T,Hk,dh), queries aligned to the end of the keys (offset T-S),
// causal / sliding-window / full masking, q-head h reads kv-head h/G,
// fp32 softmax statistics and accumulation, a row that sees no key emits
// 0, a masked key gets probability exactly 0, ragged S and T are masked
// (never padded).
//
// What bounds it on an H100: a causal prefill does 4*dh*S(S+1)/2
// operations per q-head against (q+k+v+o) bytes.  Against 989 TFLOP/s bf16
// and 3.35 TB/s, bytes bound it below S of about 900 (most prompts of the
// serve path, S = 257..512) and operations above.  At these sizes (~1
// GFLOP, 128-256 blocks) neither bound is near: each block walks its key
// tiles one after another, so the time is the heaviest query tile's chain
// of tile loads, mma.sync products and softmax steps.
//
// bf16 (the serve path): FlashAttention-2 on the tensor cores.  One block
// of 4 warps per (64-row query tile, q-head, batch row); each warp owns 16
// query rows.  Query tiles run heaviest first (reverse blockIdx.x), so the
// long tiles of the causal triangle start first.  Q is loaded once into
// registers as mma.sync.m16n8k16 A-fragments (ldmatrix).  K and V tiles of
// 64 keys x dh are staged in shared memory as bf16 by 16-byte cp.async
// copies, double-buffered: tile i+1 is copied while tile i computes, with
// one __syncthreads a tile.  Rows are padded by 16 bytes so that ldmatrix
// and ldmatrix.trans are free of bank conflicts (85 KB of dynamic shared
// memory at dh 128, opted in with cudaFuncSetAttribute; two blocks an SM;
// 67 KB at dh 96; 128 KB and one block an SM at dh 192, where the Q
// fragments and the O accumulator take 144 registers a thread).  Any head
// dim that is a multiple of 16 fits these layouts (dh 96 and 192: 6 and
// 12 k-steps of Q.K^T, 12 and 24 n-blocks of P.V).
// S = Q.K^T runs on mma.sync bf16 -> fp32; the causal / window / bounds
// mask is applied to the accumulator fragments only in tiles that
// straddle the diagonal, the window edge or the ragged end.  The online
// softmax stays in registers: row max by quad shuffles, 2^x by one SFU
// instruction with the scale and log2(e) folded into one FFMA (Q itself is
// not pre-scaled in bf16, which would add a rounding), per-thread partial
// row sums reduced once at the end.  P is rounded to bf16 in registers and
// fed straight in as the A-fragment of P.V (V through ldmatrix.trans).
// This differs from the TPU kernel, which keeps P in fp32; the plain
// version `ref.attention_ref` casts P to v.dtype too, and the bf16
// tolerance (2e-2) covers it.  The fp32 O accumulator stays in registers
// and is written once, through shared memory, as coalesced 16-byte stores.
// Splitting a tile's keys over two groups of 4 warps, or a third stage of
// K/V tiles, gained little at S 512 and lost at S 1024 and at dh 64 (fewer
// blocks an SM), so neither is here; wgmma is the next step.
//
// fp32 (the tests only): the blockwise kernel on the FMA units, two threads
// per query row each holding half of the head dim, 32-key fp32 tiles
// (48 KB of static shared memory at dh 192, the static limit).
// TF32 tensor cores keep ~3 decimal digits and cannot meet the fp32
// tolerance (2e-5), so fp32 stays off the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm80.cuh"

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: the FMA kernel
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 32;             // keys per shared-memory tile
constexpr int kThreads = 2 * kBQ;   // two threads per query row

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Tk, int Hq, int Hk, int causal, int has_window,
                 int window, float scale) {
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
  const float* qp = q + ((static_cast<size_t>(b) * S + (row_ok ? qi : 0))
                         * Hq + h) * DH + half * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) {
    qr[d] = row_ok ? qp[d] * scale : 0.f;
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
        kk = k[g];
        vv = v[g];
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
  float* op = o + ((static_cast<size_t>(b) * S + qi) * Hq + h) * DH
              + half * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) op[d] = acc[d] / safe;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int kTQ = 64;        // query rows per block (16 per warp)
constexpr int kTK = 64;        // keys per shared-memory tile

constexpr int kTThreads = 128;
constexpr int kStages = 2;     // K/V tiles in flight (double buffer)

// 2^x on the SFU in one instruction (exp2f adds a range fix-up around
// it); 2^-inf = +0, so a masked score still weighs exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
struct TcLayout {
  static constexpr int kStride = DH + 8;          // bf16 per padded row
  static constexpr int kTile = kTQ * kStride;     // bf16 per 64-row tile
  // Q (reused for the output), then kStages K tiles and kStages V tiles
  static constexpr size_t kBytes =
      (1 + 2 * kStages) * kTile * sizeof(__nv_bfloat16);
  // blocks an SM can hold by shared memory (227 KB a block, 228 an SM):
  // two up to dh 128 (85 KB), one at dh 192 (128 KB)
  static constexpr int kMinBlocks = 2 * kBytes <= 227 * 1024 ? 2 : 1;
};

template <int DH>
__global__ void __launch_bounds__(kTThreads, TcLayout<DH>::kMinBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int Tk, int Hq,
                     int Hk, int causal, int has_window, int window,
                     float scale_log2) {
  using L = TcLayout<DH>;
  constexpr int kStr = L::kStride;
  constexpr int kChunks = DH / 8;                      // 16-byte chunks a row
  constexpr int kCopies = kTQ * kChunks / kTThreads;   // per thread a tile
  constexpr int kKSteps = DH / 16;                     // k-steps of Q.K^T
  constexpr int kDBlocks = DH / 8;                     // n-blocks of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + L::kTile;                   // [kStages][64][kStr]
  __nv_bfloat16* vs = ks + kStages * L::kTile;         // [kStages][64][kStr]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int off = Tk - S;          // queries end at key position Tk-1

  int k_lo = 0, k_hi = Tk;         // keys visible to any row of the tile
  if (causal) {
    k_hi = min(Tk, q0 + kTQ + off);
    if (has_window) k_lo = max(0, q0 + off - window + 1);
  }
  k_lo = (k_lo / kTK) * kTK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTK - 1) / kTK : 0;

  const size_t kv_row = static_cast<size_t>(Hk) * DH;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Tk * Hk + hk) * DH;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Tk * Hk + hk) * DH;
  // tile `it` into stage it % kStages; rows past the visible keys are 0
  auto load_kv = [&](int it) {
    const int st = (it % kStages) * L::kTile;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kTThreads, row = c / kChunks, ch = c % kChunks;
      const int t = k_lo + it * kTK + row;
      const bool ok = t < k_hi;
      const size_t src = (ok ? t * kv_row : 0) + ch * 8;
      const int dst = st + row * kStr + ch * 8;
      cp_async16(smem_u32(ks + dst), kb + src, ok);
      cp_async16(smem_u32(vs + dst), vb + src, ok);
    }
  };

  // Q tile (zero rows past S) travels with tile 0; tiles 0..kStages-2
  // are in flight before the loop, one commit group each
  const size_t q_row = static_cast<size_t>(Hq) * DH;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * Hq + h) * DH;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = tid + i * kTThreads, r = c / kChunks, ch = c % kChunks;
    const bool ok = q0 + r < S;
    cp_async16(smem_u32(qs + r * kStr + ch * 8),
               qb + (ok ? (q0 + r) * q_row : 0) + ch * 8, ok);
  }
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) load_kv(it);
    cp_commit();
  }

  // this thread's accumulator rows within the tile: r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, row
  uint32_t qf[kKSteps][4];
  float oacc[kDBlocks][4];
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<kStages - 2>();    // tile `it` has landed (this thread's copies)
    __syncthreads();           // ... and everyone's; tile it-1 is consumed
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    cp_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldsm_x4(smem_u32(qs + (warp * 16 + (lm & 1) * 8 + lr) * kStr
                         + kk * 16 + (lm >> 1) * 8),
                qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }
    const int kt = k_lo + it * kTK;
    const __nv_bfloat16* kst = ks + (it % kStages) * L::kTile;
    const __nv_bfloat16* vst = vs + (it % kStages) * L::kTile;

    // S = Q.K^T: 8 n-blocks of 8 keys
    float sacc[kTK / 8][4];
#pragma unroll
    for (int n = 0; n < kTK / 8; ++n)
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kTK / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(kst + (np * 16 + (lm >> 1) * 8 + lr) * kStr
                         + kk * 16 + (lm & 1) * 8), b0, b1, b2, b3);
        mma_bf16(sacc[2 * np], qf[kk], b0, b1);
        mma_bf16(sacc[2 * np + 1], qf[kk], b2, b3);
      }
    }

    // mask only tiles that straddle the diagonal, window edge or ragged end
    const bool full = kt + kTK <= Tk &&
        (!causal || (kt + kTK - 1 <= q0 + off &&
                     (!has_window || kt > q0 + kTQ - 1 + off - window)));
    if (!full) {
#pragma unroll
      for (int n = 0; n < kTK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = kt + n * 8 + (lane & 3) * 2 + (e & 1);
          const int qpos = q0 + r0 + (e >> 1) * 8 + off;
          bool ok = t < Tk;
          if (causal) {
            ok = ok && t <= qpos;
            if (has_window) ok = ok && t > qpos - window;
          }
          if (!ok) sacc[n][e] = -INFINITY;
        }
      }
    }

    // online softmax, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sacc[n][2 * i], sacc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key yet keeps every p (and alpha) at 0
      const float ms = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float alpha = ex2(fmaf(m[i], scale_log2, -ms));
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTK / 8; ++n) {
        const float p0 = ex2(fmaf(sacc[n][2 * i], scale_log2, -ms));
        const float p1 = ex2(fmaf(sacc[n][2 * i + 1], scale_log2, -ms));
        sacc[n][2 * i] = p0;
        sacc[n][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kDBlocks; ++n) {
        oacc[n][2 * i] *= alpha;
        oacc[n][2 * i + 1] *= alpha;
      }
    }

    // O += P.V: P from registers (bf16), V by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kTK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(sacc[2 * j][0], sacc[2 * j][1]),
                             pack_bf16(sacc[2 * j][2], sacc[2 * j][3]),
                             pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]),
                             pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(vst + (j * 16 + (lm & 1) * 8 + lr) * kStr
                           + dp * 16 + (lm >> 1) * 8), b0, b1, b2, b3);
        mma_bf16(oacc[2 * dp], a, b0, b1);
        mma_bf16(oacc[2 * dp + 1], a, b2, b3);
      }
    }
  }
  if (n_tiles == 0) {  // no key: the Q copies are still landing in qs
    cp_wait<0>();
    __syncthreads();
  }

  // normalise (a row that saw no key -> 0) and stage this warp's 16 rows
  // in its own rows of qs, then write them as 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float s = l[i];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    inv[i] = s == 0.f ? 0.f : 1.f / s;
  }
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(qs + r0 * kStr + col) =
        pack_bf16(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(qs + (r0 + 8) * kStr + col) =
        pack_bf16(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + (static_cast<size_t>(b) * S * Hq + h) * DH;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = warp * 16 + c / kChunks, ch = c % kChunks;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + (q0 + r) * q_row + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + r * kStr + ch * 8);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Tk, int Hq, int Hk, int causal, int has_window,
               int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, Hq, Hk,
      causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int Tk, int Hq, int Hk, int causal, int has_window,
                int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = TcLayout<DH>::kBytes;
  static unsigned opted_in = 0;   // devices whose attribute is set (bit set)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 32 || !(opted_in >> dev & 1u)) {
    e = cudaFuncSetAttribute(flash_fwd_mma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32) opted_in |= 1u << dev;
  }
  const dim3 grid((S + kTQ - 1) / kTQ, Hq, B);
  flash_fwd_mma_kernel<DH><<<grid, kTThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Tk, Hq, Hk, causal, has_window, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int Hq, int Hk, int causal, int has_window, int window,
           float scale, int dtype, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<DH>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                          window, scale, st);
  if (dtype == 1)
    return launch_bf16<DH>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                           window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Tk, int Hq, int Hk, int dh, int causal,
                                   int has_window, int window, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Tk <= 0 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                        window, scale, dtype, st);
    case 64:
      return launch<64>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                        window, scale, dtype, st);
    case 96:                      // phi-3-vision-4.2b
      return launch<96>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                        window, scale, dtype, st);
    case 128:
      return launch<128>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                         window, scale, dtype, st);
    case 192:                     // nemotron-4-340b
      return launch<192>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                         window, scale, dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
