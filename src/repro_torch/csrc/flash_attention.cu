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
// and 3.35 TB/s, bytes bound it below S of about 900 (the serve path's
// prompts, S = 257..1088) and operations above.  At the serve shapes both
// bounds are a few microseconds, so what a design has to remove is
// latency: the chain of tile loads and products that one block walks.
//
// bf16 (the serve path): a warp-specialised Hopper kernel.  What it does
// about each cause that held the sm_80 design (mma.sync, cp.async on the
// compute warps, one block per q-head) back:
//  1. Products run on wgmma: S = Q.K^T as m64n64k16 with Q and K read from
//     shared memory through descriptors, O += P.V as m64n{dh}k16 with P
//     from registers (the S accumulator rounded to bf16 is wgmma's A
//     fragment) and V from shared memory, read MN-major, so V needs no
//     transposed copy.  S, the softmax statistics and O stay fp32.
//  2. Loads run on TMA, off the compute warps: one thread of a producer
//     warpgroup issues a block's Q once and K/V tiles of 64 keys into a
//     ring of 2-4 stages (`plan` picks), each stage a full and an empty
//     mbarrier; K and V have full barriers of their own, so Q.K^T starts
//     while V lands.  The producer gives up its registers (setmaxnreg);
//     ptxas still keeps each consumer thread within the block's entry
//     count (168 with two consumer warpgroups, 128 with one, two blocks an
//     SM), which is what rules out keeping a second score tile in flight.
//  O leaves the same way: normalised to bf16 into the block's Q tile in
//     the layout TMA read Q in, then stored by one thread with the
//     output's tensor map (whole 16-byte rows; positions past S dropped).
//  3. GQA packing: a block's 64 or 128 query rows are (position, q-head)
//     pairs of one KV group, so one K/V tile feeds all G heads.  G 7 and
//     12 leave the last rows of the tile empty (64 = 9 x 7 + 1, 128 =
//     10 x 12 + 8); those rows are never stored.  Masks depend on a row's
//     position only.
//  4. Occupancy at dh 192: two consumer warpgroups (128 rows, O 96 fp32
//     registers a thread) and three stages fit 193 KB; one block an SM
//     still keeps 8 warps of products and a warp of loads busy.
//  5. Small grids: `plan` (kernels/flash_attention.py) packs 128 rows a
//     block where that leaves at least 132 blocks, else 64, and splits a
//     query tile's keys over blocks when the grid is still short; a second
//     kernel in the same call merges the splits' (max, sum, O) partials in
//     split order, so the result does not depend on block timing.  Query
//     tiles run heaviest first (the slow grid axis walks them backwards).
// Tiles are swizzled as TMA writes them and wgmma reads them: 128-byte
// rows (64 bf16) for dh 64, 128 and 192, 64-byte rows (32 bf16) for dh 32
// and 96, which are not multiples of 64; a tile of dh columns is dh / 64
// (or dh / 32) such column blocks, each one box of the tensor map.  The
// tensor maps are encoded on the host each call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links -lcuda) and
// passed by value as __grid_constant__ parameters, which a CUDA graph
// records.  P is rounded to bf16 before P.V, as `ref.attention_ref` does;
// the TPU kernel keeps P in fp32, and the bf16 tolerance (2e-2) covers it.
//
// fp32 (the tests only): the blockwise kernel on the FMA units, two threads
// per query row each holding half of the head dim, 32-key fp32 tiles
// (48 KB of static shared memory at dh 192, the static limit).
// TF32 tensor cores keep ~3 decimal digits and cannot meet the fp32
// tolerance (2e-5), so fp32 stays off the tensor cores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
// bf16: the Hopper kernel
// ---------------------------------------------------------------------------
constexpr int kKeys = 64;          // keys a K/V tile (flash_attention.py KEYS)
constexpr int kMaxStages = 4;      // K/V stages at most (MAX_STAGES)

// 2^x on the SFU in one instruction (exp2f adds a range fix-up around
// it); 2^-inf = +0, so a masked score still weighs exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The layout of one block: NWG consumer warpgroups of 64 query rows each,
// then one producer warpgroup.  Shared memory, each tile 1024-byte
// aligned: Q [chunks][rows][W], then `stages` K tiles and `stages` V
// tiles [chunks][64 keys][W], then the mbarriers.
template <int DH, int NWG>
struct Hop {
  static constexpr int kW = DH % 64 == 0 ? 64 : 32;   // bf16 a swizzle row
  static constexpr int kChunks = DH / kW;
  static constexpr int kRows = 64 * NWG;
  static constexpr uint32_t kQChunk = kRows * kW * 2;    // bytes
  static constexpr uint32_t kQBytes = kRows * DH * 2;
  static constexpr uint32_t kKVChunk = kKeys * kW * 2;
  static constexpr uint32_t kKVBytes = kKeys * DH * 2;   // one K or V tile
  static constexpr int kThreads = 128 * (NWG + 1);
  // registers: entry count x warpgroups = producer + consumers
  // (384 threads, one block an SM: 3 x 168 = 24 + 2 x 240; 256 threads,
  // two blocks an SM: 2 x 128 = 24 + 232), though the consumers' code is
  // compiled within the entry count
  static_assert(NWG == 2 || DH <= 128, "dh 192 takes two consumer groups");
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = NWG == 1 ? 232 : 240;
  // flash_attention.py `smem_bytes`: tiles, alignment slack, barriers
  static size_t smem(int stages) {
    return kQBytes + 2 * static_cast<size_t>(stages) * kKVBytes + 1024 + 128;
  }
};

struct HopParams {
  __nv_bfloat16* o;
  float* part;      // splits > 1: [splits][B*S*Hq][dh] unnormalised O
  float* part_ml;   // [splits][B*S*Hq][2]: max (log2 units), sum
  int B, S, T, Hq, Hk, pack, positions, splits, stages;
  int causal, has_window, window;
  float scale_log2;
};

template <int DH, int NWG>
__global__ void __launch_bounds__(Hop<DH, NWG>::kThreads,
                                  Hop<DH, NWG>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const HopParams p) {
  using H = Hop<DH, NWG>;
  constexpr int W = H::kW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + H::kQBytes;
  unsigned char* vs = ks + p.stages * H::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + p.stages * H::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kMaxStages;
  uint64_t* empty = v_full + kMaxStages;

  // the block's work (tests/test_torch_flash_plan.py `block_work` mirrors
  // it)
  const int groups = p.Hq / p.pack;
  int bx = blockIdx.x;
  const int sp = bx % p.splits;
  bx /= p.splits;
  const int hq0 = (bx % groups) * p.pack, b = bx / groups;
  const int hk = hq0 / (p.Hq / p.Hk);
  const int s0 = (gridDim.y - 1 - blockIdx.y) * p.positions;  // heaviest first
  const int s_end = min(s0 + p.positions, p.S);
  const int off = p.T - p.S;       // queries end at key position T-1
  int k_lo = 0, k_hi = p.T;        // keys visible to any row of the block
  if (p.causal) {
    k_hi = min(p.T, s_end + off);
    if (p.has_window) k_lo = max(0, s0 + off - p.window + 1);
  }
  int n_all = 0;
  if (k_hi > k_lo) {
    k_lo = k_lo / kKeys * kKeys;
    n_all = (k_hi - k_lo + kKeys - 1) / kKeys;
  }
  const int t_first = sp * n_all / p.splits;   // this split's key tiles
  const int n_tiles = (sp + 1) * n_all / p.splits - t_first;
  const int key0 = k_lo + t_first * kKeys;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 4 * NWG);   // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, made warp-uniform for the compiler (a shuffle from lane
  // 0): each role then compiles under its own setmaxnreg budget
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    // ---- producer: one thread issues every TMA load of the block ----
    sm90::regs_dec<H::kProducerRegs>();
    if (threadIdx.x == NWG * 128 && n_tiles > 0) {
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_expect_tx(q_full, p.pack * p.positions * DH * 2);
      for (int c = 0; c < H::kChunks; ++c)
        sm90::tma_load_5d(qs + c * H::kQChunk, &tq, q_full, 0, hq0, s0, c, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % p.stages;
        sm90::mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
        const int kt = key0 + it * kKeys;
        sm90::mbar_expect_tx(&k_full[st], H::kKVBytes);
        sm90::tma_load_4d(ks + st * H::kKVBytes, &tk, &k_full[st], 0, kt,
                          hk * H::kChunks, b);
        sm90::mbar_expect_tx(&v_full[st], H::kKVBytes);
        sm90::tma_load_4d(vs + st * H::kKVBytes, &tv, &v_full[st], 0, kt,
                          hk * H::kChunks, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
    sm90::regs_inc<H::kConsumerRegs>();
    const int tw = threadIdx.x % 128, lane = tw % 32;
    const int r0 = wg * 64 + (tw / 32) * 16 + lane / 4;   // and r0 + 8
    int qpos[2];
    bool valid[2];
    size_t orow[2];                // the row's index in (B*S*Hq)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, pp = r / p.pack, s = s0 + pp;
      valid[i] = pp < p.positions && s < p.S;
      qpos[i] = s + off;
      orow[i] = (static_cast<size_t>(b) * p.S + s) * p.Hq + hq0
                + (r - pp * p.pack);
    }
    float oacc[DH / 2];
#pragma unroll
    for (int n = 0; n < DH / 2; ++n) oacc[n] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = sm90::smem_addr(qs) + wg * 64 * W * 2;

    // S = Q.K^T of the tile in stage st (64 rows x 64 keys), both operands
    // K-major; issued and committed as one wgmma group
    auto issue_qk = [&](float (&s)[32], int st) {
      const uint32_t k_addr = sm90::smem_addr(ks + st * H::kKVBytes);
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk / (W / 16);                 // column block
        const uint32_t at = (kk % (W / 16)) * 32;   // bytes into its row
        sm90::wgmma_ss_n64(
            s,
            sm90::desc<W>(q_addr + c * H::kQChunk + at, 16,
                          sm90::Swizzle<W>::kAtom),
            sm90::desc<W>(k_addr + c * H::kKVChunk + at, 16,
                          sm90::Swizzle<W>::kAtom),
            kk > 0);
      }
      sm90::wgmma_commit();
    };
    // O += P.V: P (bf16 pairs) from registers, V of stage st MN-major
    auto issue_pv = [&](const uint32_t (&pf)[16], int st) {
      const uint32_t v_addr = sm90::smem_addr(vs + st * H::kKVBytes);
      sm90::fence_regs(oacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {       // keys 16 j .. 16 j + 15
        sm90::wgmma_rs_tb<DH>(
            oacc, pf[4 * j], pf[4 * j + 1], pf[4 * j + 2], pf[4 * j + 3],
            sm90::desc<W>(v_addr + j * 16 * W * 2, H::kKVChunk,
                          sm90::Swizzle<W>::kAtom));
      }
      sm90::wgmma_commit();
    };
    // the online softmax of the scores s of keys kt..kt+63: masks (only
    // in tiles that straddle the diagonal, the window edge or the ragged
    // end; rows past the block's positions never store), the running max
    // and sum, P as bf16 pairs in pf, and each row's rescale of O
    auto softmax = [&](float (&s)[32], int kt, uint32_t (&pf)[16],
                       float (&alpha)[2]) {
      const bool full = kt + kKeys <= p.T &&
          (!p.causal || (kt + kKeys - 1 <= s0 + off &&
                         (!p.has_window || kt > s_end - 1 + off - p.window)));
      if (!full) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int t = kt + (e / 4) * 8 + (lane & 3) * 2 + (e & 1);
          const int i = (e >> 1) & 1;
          bool ok = valid[i] && t < p.T;
          if (p.causal) {
            ok = ok && t <= qpos[i];
            if (p.has_window) ok = ok && t > qpos[i] - p.window;
          }
          if (!ok) s[e] = -INFINITY;
        }
      }
      // rows r0 (e % 4 = 0, 1) and r0 + 8 (e % 4 = 2, 3)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row with no visible key yet keeps every p (and alpha) at 0
        const float ms = m_new == -INFINITY ? 0.f : m_new * p.scale_log2;
        alpha[i] = ex2(fmaf(m[i], p.scale_log2, -ms));
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float p0 = ex2(fmaf(s[4 * n + 2 * i], p.scale_log2, -ms));
          const float p1 = ex2(fmaf(s[4 * n + 2 * i + 1], p.scale_log2, -ms));
          pf[2 * n + i] = sm90::pack_bf16(p0, p1);
          sum += p0 + p1;
        }
        l[i] = l[i] * alpha[i] + sum;
      }
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        oacc[4 * n] *= alpha[0];
        oacc[4 * n + 1] *= alpha[0];
        oacc[4 * n + 2] *= alpha[1];
        oacc[4 * n + 3] *= alpha[1];
      }
    };

    // Each group walks its tiles in order: Q.K^T, the softmax, P.V.  The
    // products of the two consumer groups of a block interleave on the
    // tensor cores by themselves; explicit turns, or issuing Q.K^T of the
    // next tile before the softmax, measured no faster, and the latter
    // needs registers the 168 / 128 a thread of these layouts do not have.
    if (n_tiles > 0) {
      float sacc[32], alpha[2];
      uint32_t pf[16];
      sm90::mbar_wait(q_full, 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % p.stages;
        const uint32_t ph = (it / p.stages) & 1;
        sm90::mbar_wait(&k_full[st], ph);
        issue_qk(sacc, st);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sacc);
        softmax(sacc, key0 + it * kKeys, pf, alpha);
        rescale(alpha);
        sm90::mbar_wait(&v_full[st], ph);
        issue_pv(pf, st);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(oacc);
        if (lane == 0) sm90::mbar_arrive(&empty[st]);   // stage is free
      }
    }

    // rows that saw no key: l = 0 -> 0 (or an empty partial)
    float lt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lt[i] = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      lt[i] += __shfl_xor_sync(0xffffffffu, lt[i], 2);
    }
    if (p.splits == 1) {
      // O (bf16) into the Q tile, which every Q.K^T is done with, in the
      // layout TMA read Q in; one thread then stores the block's
      // (position, head) rows with the output's tensor map, which drops
      // positions past S (rows past the box are never stored)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float inv = lt[i] == 0.f ? 0.f : 1.f / lt[i];
        const int r = r0 + 8 * i;
        const int swz = W == 64 ? (r & 7) : ((r >> 1) & 3);
        unsigned char* row = qs + r * W * 2 + (lane & 3) * 4;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {   // 8 columns = 16 bytes
          const int c = n / (W / 8), j = n % (W / 8);
          *reinterpret_cast<uint32_t*>(row + c * H::kQChunk
                                       + ((j ^ swz) * 16)) =
              sm90::pack_bf16(oacc[4 * n + 2 * i] * inv,
                              oacc[4 * n + 2 * i + 1] * inv);
        }
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(1, 128 * NWG);
      if (threadIdx.x == 0) {
        for (int c = 0; c < H::kChunks; ++c)
          sm90::tma_store_5d(&to, qs + c * H::kQChunk, 0, hq0, s0, c, b);
        sm90::bulk_commit();
        sm90::bulk_wait_read();      // the tile is read before exit
      }
    } else {
      const size_t rows = static_cast<size_t>(p.B) * p.S * p.Hq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!valid[i]) continue;
        const size_t at = static_cast<size_t>(sp) * rows + orow[i];
        float* po = p.part + at * DH + (lane & 3) * 2;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
          *reinterpret_cast<float2*>(po + 8 * n) =
              make_float2(oacc[4 * n + 2 * i], oacc[4 * n + 2 * i + 1]);
        if ((lane & 3) == 0)
          *reinterpret_cast<float2*>(p.part_ml + 2 * at) = make_float2(
              m[i] == -INFINITY ? -INFINITY : m[i] * p.scale_log2, lt[i]);
      }
    }
  }
}

// Merge the key splits' partials of each (b, s, h) row in split order:
// O = sum_i 2^(m_i - M) O_i / sum_i 2^(m_i - M) l_i, M = max_i m_i.  One
// warp a row.
template <int DH>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ part,
                     const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ o, long long rows,
                     int splits) {
  const long long row = static_cast<long long>(blockIdx.x) * 8
                        + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp)
    mx = fmaxf(mx, part_ml[2 * (sp * rows + row)]);
  float acc[DH / 32], sum = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 32; ++c) acc[c] = 0.f;
  if (mx != -INFINITY) {
    for (int sp = 0; sp < splits; ++sp) {
      const long long at = sp * rows + row;
      const float w = ex2(part_ml[2 * at] - mx);
      sum += w * part_ml[2 * at + 1];
#pragma unroll
      for (int c = 0; c < DH / 32; ++c)
        acc[c] += w * part[at * DH + c * 32 + lane];
    }
  }
  const float inv = sum == 0.f ? 0.f : 1.f / sum;
#pragma unroll
  for (int c = 0; c < DH / 32; ++c)
    o[row * DH + c * 32 + lane] = __float2bfloat16(acc[c] * inv);
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

// cuTensorMapEncodeTiled from the driver, found once through the runtime
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Error codes of the launcher beyond CUDA's own: the driver entry point is
// missing, or cuTensorMapEncodeTiled refused a map (kEncodeError + its
// CUresult).
constexpr int kNoEncoder = 9999;
constexpr int kEncodeError = 10000;

// a bf16 tensor map, zeros outside the tensor, swizzled rows of W bf16
template <int W>
int encode(CUtensorMap* map, const void* base, cuuint32_t rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int DH, int NWG>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* work, int B, int S, int T, int Hq, int Hk, int causal,
                int has_window, int window, float scale, int pack, int splits,
                int stages, cudaStream_t stream) {
  using H = Hop<DH, NWG>;
  constexpr int W = H::kW, NC = H::kChunks;
  if (pack <= 0 || (Hq / Hk) % pack != 0 || pack > H::kRows || splits <= 0
      || stages < 2 || stages > kMaxStages || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int positions = H::kRows / pack;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  // Q as (W, Hq, S, chunks, B): a box is `pack` heads x `positions`
  // positions of one column block, so its rows in shared memory are the
  // block's (position, head) rows in order
  CUtensorMap tq, tk, tv, to;
  const cuuint64_t qd[5] = {W, cuuint64_t(Hq), cuuint64_t(S), NC,
                            cuuint64_t(B)};
  const cuuint64_t qst[4] = {DH * e, Hq * DH * e, W * e,
                             cuuint64_t(S) * Hq * DH * e};
  const cuuint32_t qb[5] = {W, cuuint32_t(pack), cuuint32_t(positions), 1, 1};
  // K, V as (W, T, Hk x chunks, B): a box is 64 keys x a head's chunks
  const cuuint64_t kd[4] = {W, cuuint64_t(T), cuuint64_t(Hk) * NC,
                            cuuint64_t(B)};
  const cuuint64_t kst[3] = {Hk * DH * e, W * e, cuuint64_t(T) * Hk * DH * e};
  const cuuint32_t kb[4] = {W, kKeys, NC, 1};
  int err = encode<W>(&tq, q, 5, qd, qst, qb);
  if (!err) err = encode<W>(&tk, k, 4, kd, kst, kb);
  if (!err) err = encode<W>(&tv, v, 4, kd, kst, kb);
  if (!err) err = encode<W>(&to, o, 5, qd, qst, qb);   // O as Q
  if (err) return err;

  static unsigned opted_in = 0;   // devices whose attribute is set (bit set)
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (dev >= 32 || !(opted_in >> dev & 1u)) {
    ce = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DH, NWG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              227 * 1024);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    if (dev < 32) opted_in |= 1u << dev;
  }
  const long long rows = static_cast<long long>(B) * S * Hq;
  HopParams prm;
  prm.o = static_cast<__nv_bfloat16*>(o);
  prm.part = static_cast<float*>(work);
  prm.part_ml = splits > 1 ? prm.part + splits * rows * DH : nullptr;
  prm.B = B;
  prm.S = S;
  prm.T = T;
  prm.Hq = Hq;
  prm.Hk = Hk;
  prm.pack = pack;
  prm.positions = positions;
  prm.splits = splits;
  prm.stages = stages;
  prm.causal = causal;
  prm.has_window = has_window;
  prm.window = window;
  prm.scale_log2 = scale * kLog2e;
  const dim3 grid(splits * (Hq / pack) * B, (S + positions - 1) / positions);
  flash_fwd_wgmma_kernel<DH, NWG><<<grid, H::kThreads, H::smem(stages),
                                    stream>>>(tq, tk, tv, to, prm);
  ce = cudaGetLastError();
  if (ce != cudaSuccess || splits == 1) return static_cast<int>(ce);
  flash_combine_kernel<DH><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             stream>>>(prm.part, prm.part_ml,
                                       prm.o, rows, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, void* work,
           int B, int S, int Tk, int Hq, int Hk, int causal, int has_window,
           int window, float scale, int dtype, int rows, int pack, int splits,
           int stages, cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<DH>(q, k, v, o, B, S, Tk, Hq, Hk, causal, has_window,
                          window, scale, st);
  if (dtype == 1 && rows == 128)
    return launch_bf16<DH, 2>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                              has_window, window, scale, pack, splits, stages,
                              st);
  if constexpr (DH <= 128) {      // dh 192 takes two consumer groups
    if (dtype == 1 && rows == 64)
      return launch_bf16<DH, 1>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                                has_window, window, scale, pack, splits,
                                stages, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (Hopper kernel).  The bf16
// kernel takes its plan (kernels/flash_attention.py `plan`): query rows a
// block (64 or 128), q-heads packed into them, key splits, K/V stages, and
// `work`, fp32 scratch of splits x B*S*Hq x (dh + 2) when splits > 1; the
// fp32 kernel ignores them.  Returns cudaGetLastError() after the launches
// (0 = launched), or an encode error (see kEncodeError).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Tk, int Hq, int Hk, int dh, int causal,
                                   int has_window, int window, float scale,
                                   int dtype, int rows, int pack, int splits,
                                   int stages, void* work, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || Tk <= 0 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                        has_window, window, scale, dtype, rows, pack, splits,
                        stages, st);
    case 64:
      return launch<64>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                        has_window, window, scale, dtype, rows, pack, splits,
                        stages, st);
    case 96:                      // phi-3-vision-4.2b
      return launch<96>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                        has_window, window, scale, dtype, rows, pack, splits,
                        stages, st);
    case 128:
      return launch<128>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                         has_window, window, scale, dtype, rows, pack, splits,
                         stages, st);
    case 192:                     // nemotron-4-340b
      return launch<192>(q, k, v, o, work, B, S, Tk, Hq, Hk, causal,
                         has_window, window, scale, dtype, rows, pack, splits,
                         stages, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
