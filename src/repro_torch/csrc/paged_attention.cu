// Paged-attention decode and verify (S query rows per table row, read
// through a block table) for sm_90a, split across a row's pages
// ("flash-decoding").
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`; wrapper
// kernels/ops.py `paged_attention`, which crops the table).  Same
// semantics: q (B,S,Hq,dh) (S = 1 is the TPU kernel's (B,Hq,dh)), k/v
// pools (Np,P,Hk,dh), block_tables (B,n) int32, pos (B,S) int32; query
// (b, i) attends logical positions 0..pos[b,i] of table row b, where
// position t lives in page block_tables[b, t/P] at offset t%P; pages
// wholly past a block's last position are never read (their table entries
// may name pages of other rows), positions past a query's own position
// weigh exactly 0; fp32 softmax statistics and accumulation; q-head h
// reads kv-head h/G; a query that sees no key (pos < 0) emits 0.
//
// What bounds it on an H100: a block reads each live K and V row of its
// table row once for all G*S query rows of the KV group and does 4*dh
// operations per (query row, position): G*S operations a byte (7-48 on
// the serve and verify paths), far below the card's ~295.  It is bound
// by bytes (3.35 TB/s): the live K+V of every table row, 4-17 us at the
// decode sizes, the order of a kernel launch, so the design keeps many
// bytes in flight on every SM and the chain of dependent steps short.
//
// bf16 (the serve path): a warp-specialised Hopper kernel, one block per
// (split, kv-head, table row), five warps.  What it does about what held
// the previous design (one warp group per (query row, kv-head), FMA
// arithmetic on CUDA cores, loads issued by the computing lanes) back:
//  1. One pass over a table row's pages for all its query rows: the G
//     q-heads of the KV group and the S candidate rows of a verify round
//     are the M = G*S rows of one block (row r = i*G + g), so a page that
//     lands once feeds every one of them, each masked by its own
//     position.  attention_verify passes its table unrepeated.
//  2. Products on the tensor cores: S = Q.K^T and O += P.V as
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulators), operands read from
//     shared memory by ldmatrix (V transposed by ldmatrix.trans), P
//     rounded to bf16 in registers as the accumulator of Q.K^T is the A
//     fragment of P.V.  mma.sync over wgmma: its 16-row tiles take G*S of
//     1-16 with little padding, where wgmma pads every group to 64 rows;
//     and a warp owns its tile, so the four consumer warps split a
//     stage's keys between them (each with its own running max, sum and
//     O, merged at the end in a fixed order) instead of holding 64 rows
//     of which 1-48 are real.  With G*S of 17-32 two warps take a tile
//     each and split the keys in two; with 33-64 each warp takes a tile
//     and all keys.  A warp's O is one 16-row tile: dh/2 fp32 registers
//     a thread (96 at dh 192), so G*S = 48 at dh 192 fits as three warps
//     of one tile each.  G*S of 1 or 2 keeps the tensor cores too: the
//     arithmetic is a few percent of the bytes' time either way.  A
//     group of more than 64 rows (a verify round of many candidates) is
//     cut into chunks of 64 rows, a block each (grid y is kv-head x
//     chunk); each chunk reads the pages its own rows reach.
//  3. Many bytes in flight: pages arrive by TMA into a ring of 1-4 stages
//     (`plan` picks) of 64 keys or more, a stage being whole pages
//     (4 pages of 16), tracked by a full and an empty mbarrier each; at
//     dh 128 a stage is 32 KB of K and V and a block keeps up to 96 KB in
//     flight, issued as soon as its positions and table entries land.
//  4. Copies overlap the products: one lane of a fifth (producer) warp
//     reads the split's table entries from shared memory and issues every
//     copy; the consumer warps compute on the stages that have landed and
//     free each stage as they leave it.
//  5. No idle lanes at dh 96: a tile is read by ldmatrix, whose lanes
//     each address one 16-byte row segment, whatever dh is.
// Each page is one TMA box of a kv-head's P x dh rows (the pool as the
// 4-D tensor (W, P, Hk x dh/W, Np), the page id from the table as the
// outer coordinate); the box is `slot` rows tall (P rounded up to a power
// of two, at least 8), so the rows past P, and whole pages past the
// block's live pages (asked for at page id Np), arrive as zeros that cost
// no memory traffic and are masked out.  Rows are swizzled as TMA writes
// them and ldmatrix reads them: 128-byte rows (64 bf16) for dh 64, 128 and
// 192, 64-byte rows for dh 32 and 96; every tile starts on a multiple of
// the swizzle's repeat (1024 or 512 bytes), so the swizzle of a row is
// that of its index.  The two tensor maps (K and V pool) are encoded once
// per pool tensor (cached by pointer and shape in each host thread, every
// layer's pool of a model kept) and passed by value as __grid_constant__
// parameters, which a CUDA graph records.
//
// Splits: `plan` (kernels/paged_attention.py) splits a table row's pages
// only where the (table row, kv-head) pairs leave SMs idle, into spans
// for two blocks an SM at G*S <= 4 and one above (the end of a block
// merges its warps' partials, which costs more with more rows than a
// second block an SM gains).  A split wholly past its row's last
// position exits without reading a page.  At the end of a block the
// consumer warps of a tile merge their partial (max, sum, O) in shared
// memory in a fixed order (each thread 4 columns of a row).  With one
// split the block writes the output; otherwise it writes its partial
// (m, l, acc[dh]) per query row in fp32 to a workspace the wrapper
// allocates, and a second small kernel, launched on the same stream by
// the same entry point as a programmatic dependent launch (scheduled
// while the split grid runs, waiting for it with griddepcontrol.wait),
// merges the live splits in a fixed order, all of a row's loads in
// flight at once.  No atomics: two calls on the same input give
// bit-identical outputs.  Measured slower on the card and dropped
// (PERF.md): the splits of a row as one thread-block cluster
// merged over distributed shared memory (a cluster's blocks are
// scheduled together and hold their shared memory until the slowest
// split ends), each warp's partial to the merge kernel (four times the
// workspace bytes), warps splitting dh instead of keys (every warp then
// runs Q.K^T for all the keys of a stage).
//
// fp32 (the card tests only): the FMA design, one block of 4 warps per
// (query row, kv-head, split), lanes loading K and V rows themselves, the
// same merge kernel.  TF32 tensor cores keep ~3 decimal digits and cannot
// meet the fp32 tolerance (2e-5), so fp32 stays off the tensor cores, and
// no serve path runs it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <functional>
#include <unordered_map>

#include "mma_sm80.cuh"
#include "sm90.cuh"

namespace {

constexpr int kMaxSpan = 64;   // pages an fp32 split may take (its table in smem)
constexpr float kLog2e = 1.4426950408889634f;

// exp2 of x - m, with m = -inf (nothing seen yet) taken as 0 so that a
// state that saw nothing weighs exactly 0
__device__ __forceinline__ float weight(float x, float m) {
  return exp2f(x - (m == -INFINITY ? 0.f : m));
}

// ---------------------------------------------------------------------------
// fp32: the FMA kernel
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// K/V rows a lane loads at once, over the G heads it folds them into
constexpr int kRowsInFlight = 8;

__device__ __forceinline__ void spread(const float4& r, float* f) {
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

// the least power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Grid (n_splits, Hk, B*S): block z is query row z = b*S + i of table row
// b, with all G heads of kv-head hk; its 4 warps walk the split's
// positions, a group of lanes per K/V row (16-byte loads), 8/G rows a lane
// in flight, the G scores reduced by shuffles across the row's lanes and
// folded into the lanes' running max, sum and accumulator, merged across
// lanes and warps at the end.
template <int DH, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                    const float* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ pos, float* __restrict__ o,
                    float* __restrict__ ws, int S, int P, int Hk, int n_pages,
                    int bt_stride, int n_splits, int span,
                    float scale_log2) {
  constexpr int kVec = 4;                  // floats per 16-byte load
  constexpr int kChunks = DH / kVec;       // 16-byte chunks a K/V row
  // lanes per K/V row; lane c of a row takes chunks c, c + kLanes, ...
  constexpr int kLanes = kChunks >= 32 ? 32 : pow2_at_least(kChunks);
  constexpr int kC = (kChunks + kLanes - 1) / kLanes;   // chunks a lane
  constexpr int kE = kC * kVec;            // elements a lane holds a row
  constexpr int kRows = 32 / kLanes;       // rows a warp takes per step
  constexpr int kU = kRowsInFlight > G ? kRowsInFlight / G : 1;
  constexpr int kStep = kWarps * kRows * kU;
  __shared__ int tbl[kMaxSpan];
  __shared__ float red_acc[kWarps][G][DH];
  __shared__ float red_ml[kWarps][G][2];

  // the merge grid may start launching now: it waits for this grid's
  // completion (griddepcontrol.wait) before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  const int b = z / S;                     // the query row's table row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLanes, c = lane % kLanes;
  const int Hq = Hk * G;
  const int pg0 = split * span;
  const int t0 = pg0 * P;
  const int p_b = pos[z];
  const int n_tbl = min(span, n_pages - pg0);
  const int page = tid < n_tbl ? bt[static_cast<size_t>(b) * bt_stride
                                    + pg0 + tid] : 0;
  bool live[kC];                           // chunk i of this lane is in
#pragma unroll
  for (int i = 0; i < kC; ++i) live[i] = c + i * kLanes < kChunks;
  float qr[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[i])
        v = *reinterpret_cast<const float4*>(
            q + (static_cast<size_t>(z) * Hq + hk * G + g) * DH
            + (c + i * kLanes) * kVec);
      spread(v, qr[g] + i * kVec);
#pragma unroll
      for (int e = 0; e < kVec; ++e) qr[g][i * kVec + e] *= scale_log2;
    }
  if (t0 > p_b) {            // wholly past the row's position: read nothing
    if (n_splits == 1)       // (only pos < 0 gets here) no key -> 0
      for (int i = tid; i < G * DH; i += kThreads)
        o[(static_cast<size_t>(z) * Hq + hk * G) * DH + i] = 0.f;
    return;
  }
  const int t_end = min(min(t0 + span * P, n_pages * P), p_b + 1);
  if (tid < n_tbl) tbl[tid] = page;
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
  const float* kb = kp + static_cast<size_t>(hk) * DH + c * kVec;
  const float* vb = vp + static_cast<size_t>(hk) * DH + c * kVec;
  for (int tb = t0; tb < t_end; tb += kStep) {
    float4 kr[kU][kC], vr[kU][kC];
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
        kr[u][i] = vr[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok[u] && live[i]) {
          kr[u][i] = *reinterpret_cast<const float4*>(kb + row
                                                      + i * kLanes * kVec);
          vr[u][i] = *reinterpret_cast<const float4*>(vb + row
                                                      + i * kLanes * kVec);
        }
      }
    }
    float s[kU][G];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kE];
#pragma unroll
      for (int i = 0; i < kC; ++i) spread(kr[u][i], kf + i * kVec);
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
        for (int i = 0; i < kC; ++i) spread(vr[u][i], vf + i * kVec);
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
    const size_t h = static_cast<size_t>(z) * Hq + hk * G + g;
    if (n_splits == 1) {
      o[h * DH + d] = sum == 0.f ? 0.f : out / sum;
    } else {                 // partial of this split (the merge's layout)
      const size_t part = h * n_splits + split;
      ws[part * DH + d] = out;
      if (d == 0) {
        float* ml = ws + static_cast<size_t>(gridDim.z) * Hq * n_splits * DH;
        ml[2 * part] = mn;
        ml[2 * part + 1] = sum;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the Hopper kernel
// ---------------------------------------------------------------------------
constexpr int kConsumers = 4;                  // consumer warps a block
constexpr int kTcThreads = 32 * (kConsumers + 1);
constexpr int kMaxRows = 16 * kConsumers;      // rows (of G*S) a block
constexpr int kMaxStages = 4;

// 2^x on the SFU in one instruction; 2^-inf = +0, so a masked score
// weighs exactly 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The layout of one block (kernels/paged_attention.py `smem_bytes`
// mirrors it): from a 1024-byte aligned base, the ring (`stages` K stages,
// then `stages` V stages, each `keys` rows of dh), which the end of the
// block reuses for the warps' partial states; then Q (16 x `tiles` rows of
// dh + 8 bf16, the 16-byte pad keeping ldmatrix off bank conflicts), the
// split's table entries, the rows' positions and the mbarriers.
template <int DH>
struct Tc {
  static constexpr int kW = DH % 64 == 0 ? 64 : 32;   // bf16 a swizzle row
  static constexpr int kChunks = DH / kW;
  static constexpr uint32_t kRowBytes = kW * 2;
  static constexpr uint32_t kQStride = DH * 2 + 16;
  // the end of the block reuses the ring for the warps' O rows (dh + 8
  // fp32) and their (max, sum)
  static constexpr int kRedStride = DH + 8;
  static constexpr uint32_t kRedBytes =
      4 * kConsumers * 16 * (kRedStride + 2);
  static __host__ __device__ size_t ring_bytes(int stages, int keys) {
    const size_t ring = 2 * static_cast<size_t>(stages) * keys * DH * 2;
    return ring > kRedBytes ? ring : kRedBytes;
  }
  static __host__ __device__ size_t table_bytes(int span) {
    return 16 * static_cast<size_t>((span + 3) / 4);
  }
  static size_t smem(int stages, int keys, int tiles, int span) {
    return 1024 + ring_bytes(stages, keys) + 16 * tiles * kQStride
           + table_bytes(span) + 4 * kMaxRows + 8 * 2 * kMaxStages;
  }
  // the 16-byte group of a row that holds logical group j (the swizzle:
  // bits 4-6 of the address XOR bits 7-9, or bits 4-5 XOR 7-8)
  static __device__ __forceinline__ uint32_t swz(int row) {
    return kW == 64 ? (row & 7) : ((row >> 1) & 3);
  }
};

struct TcParams {
  const __nv_bfloat16* q;
  const int* bt;
  const int* pos;
  __nv_bfloat16* o;
  float* ws;                  // splits > 1: the splits' partials
  int S, Hq, G, M;            // query rows a table row, heads, M = G*S
  int tiles;                  // 16-row tiles (1, 2 or 4)
  int chunks;                 // blocks of 16*tiles rows a KV group takes
  int P, slot_shift, pages;   // page size, log2 rows a page slot, pages a stage
  int stages, n_pages, Np, bt_stride, splits, span;
  float scale_log2;
};

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 2)
paged_tc_kernel(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const TcParams p) {
  using L = Tc<DH>;
  constexpr int W = L::kW, NC = L::kChunks;
  // the merge grid may start launching now: it waits for this grid's
  // completion (griddepcontrol.wait) before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int slot = 1 << p.slot_shift;          // rows a page slot
  const int keys = p.pages * slot;             // rows a stage
  const uint32_t chunk_bytes = slot * L::kRowBytes;   // one chunk of a page
  const uint32_t page_bytes = chunk_bytes * NC;
  const uint32_t stage_bytes = page_bytes * p.pages;  // K (or V) of a stage
  unsigned char* qs = ring + L::ring_bytes(p.stages, keys);
  int* tbl = reinterpret_cast<int*>(qs + 16 * p.tiles * L::kQStride);
  int* rpos = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(tbl)
                                     + L::table_bytes(p.span));
  uint64_t* full = reinterpret_cast<uint64_t*>(rpos + kMaxRows);
  uint64_t* empty = full + kMaxStages;

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / p.chunks, chunk = blockIdx.y - hk * p.chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's rows of the group, R = row0 + r for r < M; their
  // queries i0 .. i0 + nq - 1 (at most 64 of them)
  const int row0 = chunk * 16 * p.tiles;
  const int M = min(16 * p.tiles, p.M - row0);
  const int i0 = row0 / p.G, nq = (row0 + M - 1) / p.G - i0 + 1;
  const int pg0 = split * p.span;
  const int pg_end = min(pg0 + p.span, p.n_pages);
  // the tensor maps, the rows' positions, the split's table entries and q
  // do not depend on each other: their loads are all in flight at once
  if (tid == 32 * kConsumers) {
    sm90::tma_prefetch(&tk);
    sm90::tma_prefetch(&tv);
  }
  if (tid < nq) rpos[tid] = p.pos[static_cast<size_t>(b) * p.S + i0 + tid];
  if (warp == kConsumers) {
    for (int j = lane; j < pg_end - pg0; j += 32)
      tbl[j] = p.bt[static_cast<size_t>(b) * p.bt_stride + pg0 + j];
    if (lane == 0) {
      for (int s = 0; s < p.stages; ++s) {
        sm90::mbar_init(&full[s], 1);
        sm90::mbar_init(&empty[s], kConsumers);   // lane 0 of each consumer
      }
      sm90::mbar_fence_init();
    }
  } else {
    // Q rows R = i*G + g of this kv-head, zeros past M
    for (int idx = tid; idx < 16 * p.tiles * (DH / 8);
         idx += 32 * kConsumers) {
      const int r = idx / (DH / 8), c = idx % (DH / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M) {
        const int i = (row0 + r) / p.G, g = row0 + r - i * p.G;
        v = *reinterpret_cast<const uint4*>(
            p.q + ((static_cast<size_t>(b) * p.S + i) * p.Hq + hk * p.G + g)
                  * DH + c * 8);
      }
      *reinterpret_cast<uint4*>(qs + r * L::kQStride + c * 16) = v;
    }
  }
  __syncthreads();
  int pos_max = -1;
  for (int i = 0; i < nq; ++i) pos_max = max(pos_max, rpos[i]);
  if (pg0 * p.P > pos_max) {   // no query of the block reaches this split
    if (p.splits == 1)         // (only pos < 0 gets here) no key -> 0
      for (int idx = tid; idx < M * DH; idx += kTcThreads) {
        const int R = row0 + idx / DH, d = idx % DH, i = R / p.G;
        p.o[((static_cast<size_t>(b) * p.S + i) * p.Hq + hk * p.G
             + (R - i * p.G)) * DH + d] = __float2bfloat16(0.f);
      }
    return;
  }
  // pages to read, [pg0, live_end), and the stages that hold them
  const int live_end = min(pg_end, pos_max / p.P + 1);
  const int n_iter = (live_end - pg0 + p.pages - 1) / p.pages;

  if (warp == kConsumers) {
    // ---- producer: one lane issues every copy of the block ----
    if (lane == 0) {
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % p.stages;
        sm90::mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[st], 2 * stage_bytes);
        unsigned char* kd = ring + static_cast<size_t>(st) * stage_bytes;
        unsigned char* vd = ring + static_cast<size_t>(p.stages + st)
                                   * stage_bytes;
        for (int j = 0; j < p.pages; ++j) {
          const int pg = pg0 + it * p.pages + j;
          // past the live pages: page id Np, outside the pool, lands as
          // zeros without reading memory
          const int id = pg < live_end ? tbl[pg - pg0] : p.Np;
          sm90::tma_load_4d(kd + j * page_bytes, &tk, &full[st], 0, 0,
                            hk * NC, id);
          sm90::tma_load_4d(vd + j * page_bytes, &tv, &full[st], 0, 0,
                            hk * NC, id);
        }
      }
    }
  } else {
    // ---- consumers: warp (tile, group) takes 16 rows and its share of
    // each stage's keys ----
    const int tile = warp % p.tiles, grp = warp / p.tiles;
    const int groups = kConsumers / p.tiles;
    const int share = keys / groups;           // keys a warp takes a stage
    const bool idle = tile * 16 >= M;          // a tile past the rows
    const int g = lane >> 2, qd = lane & 3;
    // each of this lane's two rows sees positions up to lim (-1: none); a
    // split ends at pg_end, the next split's positions are not its own
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tile * 16 + g + 8 * i;
      lim[i] = r < M ? min(rpos[(row0 + r) / p.G - i0], pg_end * p.P - 1)
                     : -1;
    }
    float oacc[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const float sl = p.scale_log2;
    const uint32_t ring_a = sm90::smem_addr(ring);
    // ldmatrix rows of this lane: Q row (A, non-transposed), K row (B of
    // Q.K^T, non-transposed: keys are its n), V row (B of P.V, transposed)
    const uint32_t q_a = sm90::smem_addr(qs)
        + (tile * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * L::kQStride
        + ((lane >> 4) << 4);
    const int k_lane = (lane & 7) + ((lane >> 4) << 3);
    const int k_half = (lane >> 3) & 1;
    const int v_lane = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_half = lane >> 4;
    auto row_at = [&](int r) -> uint32_t {   // a stage row's byte offset
      return (r >> p.slot_shift) * page_bytes
             + (r & (slot - 1)) * L::kRowBytes;
    };

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % p.stages;
      sm90::mbar_wait(&full[st], (it / p.stages) & 1);
      const uint32_t kbase = ring_a + st * stage_bytes;
      const uint32_t vbase = ring_a + (p.stages + st) * stage_bytes;
      const int pos0 = (pg0 + it * p.pages) * p.P;   // position of row 0
      // rows of live pages in this stage (the rest are zeros)
      const int rows = min(keys, (live_end - pg0 - it * p.pages) * slot);
      const int r_end = idle ? 0 : min((grp + 1) * share, rows);
      for (int r0 = grp * share; r0 < r_end; r0 += 16) {
        // S = Q.K^T over keys r0 .. r0 + 15 (two 8-key n tiles)
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        {
          const int kr = r0 + k_lane;
          const uint32_t ka = kbase + row_at(kr);
          const uint32_t ks = L::swz(kr & (slot - 1));
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk) {
            uint32_t a[4], b0, b1, b2, b3;
            ldsm_x4(q_a + kk * 32, a[0], a[1], a[2], a[3]);
            const int c = kk / (W / 16);
            const uint32_t j = (kk % (W / 16)) * 2 + k_half;
            ldsm_x4(ka + c * chunk_bytes + ((j ^ ks) << 4), b0, b1, b2, b3);
            mma_bf16(s[0], a, b0, b1);
            mma_bf16(s[1], a, b2, b3);
          }
        }
        // masks: a key weighs 0 past a row's position, in a page slot's
        // padding rows and past the split
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = r0 + 8 * n + 2 * qd + e;
            const int off = col & (slot - 1);
            const int t = pos0 + (col >> p.slot_shift) * p.P + off;
            const bool in_page = off < p.P;
            if (!(in_page && t <= lim[0])) s[n][e] = -INFINITY;
            if (!(in_page && t <= lim[1])) s[n][2 + e] = -INFINITY;
          }
        // the online softmax of rows g (i = 0) and g + 8 (i = 1)
        float alpha[2];
        uint32_t pa[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                           fmaxf(s[1][2 * i], s[1][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);
          // a row with no visible key yet keeps every p (and alpha) at 0
          const float ms = m_new == -INFINITY ? 0.f : m_new * sl;
          alpha[i] = ex2(fmaf(m[i], sl, -ms));
          m[i] = m_new;
          const float p0 = ex2(fmaf(s[0][2 * i], sl, -ms));
          const float p1 = ex2(fmaf(s[0][2 * i + 1], sl, -ms));
          const float p2 = ex2(fmaf(s[1][2 * i], sl, -ms));
          const float p3 = ex2(fmaf(s[1][2 * i + 1], sl, -ms));
          l[i] = l[i] * alpha[i] + ((p0 + p1) + (p2 + p3));
          // the A fragment of P.V: keys 2q.. (n tile 0), 2q + 8.. (tile 1)
          pa[i] = pack_bf16(p0, p1);
          pa[2 + i] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          oacc[n][0] *= alpha[0];
          oacc[n][1] *= alpha[0];
          oacc[n][2] *= alpha[1];
          oacc[n][3] *= alpha[1];
        }
        // O += P.V over keys r0 .. r0 + 15, 16 columns of dh at a time
        {
          const int vr = r0 + v_lane;
          const uint32_t va = vbase + row_at(vr);
          const uint32_t vs = L::swz(vr & (slot - 1));
#pragma unroll
          for (int nd = 0; nd < DH / 16; ++nd) {
            uint32_t b0, b1, b2, b3;
            const int c = nd / (W / 16);
            const uint32_t j = (nd % (W / 16)) * 2 + v_half;
            ldsm_x4_t(va + c * chunk_bytes + ((j ^ vs) << 4), b0, b1, b2,
                      b3);
            mma_bf16(oacc[2 * nd], pa, b0, b1);
            mma_bf16(oacc[2 * nd + 1], pa, b2, b3);
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[st]);   // the stage is free
    }

    const size_t ml_at = static_cast<size_t>(gridDim.z) * p.S * p.Hq
                         * p.splits * DH;
    // the output (one split) or this split's partial and, once a row, its
    // (max, sum), of block row r from 4 columns of O, its sum and max
    auto store = [&](int r, int d, float4 out, float sum, float mn) {
      const int R = row0 + r, q = R / p.G;
      const size_t h = (static_cast<size_t>(b) * p.S + q) * p.Hq
                       + hk * p.G + (R - q * p.G);
      if (p.splits == 1) {
        const float inv = sum == 0.f ? 0.f : 1.f / sum;
        uint2 packed;
        packed.x = pack_bf16(out.x * inv, out.y * inv);
        packed.y = pack_bf16(out.z * inv, out.w * inv);
        *reinterpret_cast<uint2*>(p.o + h * DH + d) = packed;
      } else {
        const size_t part = h * p.splits + split;
        *reinterpret_cast<float4*>(p.ws + part * DH + d) = out;
        if (d == 0)
          *reinterpret_cast<float2*>(p.ws + ml_at + 2 * part) =
              make_float2(mn, sum);
      }
    };
    if (groups == 1) {
      // each warp holds whole rows: stored from its registers (4 columns
      // from lanes q and q ^ 1 of a row)
      if (idle) return;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int r = tile * 16 + g + 8 * i;
        const float mn = m[i] == -INFINITY ? -INFINITY : m[i] * sl;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          const float x0 = __shfl_xor_sync(0xffffffffu, oacc[n][2 * i], 1);
          const float x1 = __shfl_xor_sync(0xffffffffu, oacc[n][2 * i + 1],
                                           1);
          if (r < M && !(qd & 1))
            store(r, 8 * n + 2 * qd, make_float4(oacc[n][2 * i],
                                                 oacc[n][2 * i + 1], x0, x1),
                  lt, mn);
        }
      }
      return;
    }
    // every stage has landed and been read: the ring takes the warps'
    // partial states (O rows of dh + 8 fp32, the pad keeping the float2
    // stores off bank conflicts; max and sum) of the tiles' real rows,
    // merged over the warps of each tile in a fixed order
    float* red = reinterpret_cast<float*>(ring);
    float* red_ml = red + kConsumers * 16 * L::kRedStride;
    sm90::bar_sync(1, 32 * kConsumers);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      if (tile * 16 + g + 8 * i >= M) continue;
      const int r = warp * 16 + g + 8 * i;
      float* row = red + r * L::kRedStride + 2 * qd;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(oacc[n][2 * i], oacc[n][2 * i + 1]);
      if (qd == 0) {
        red_ml[2 * r] = m[i] == -INFINITY ? -INFINITY : m[i] * sl;
        red_ml[2 * r + 1] = lt;
      }
    }
    sm90::bar_sync(1, 32 * kConsumers);
    // 4 columns a thread, each row's weights over the warps of its tile,
    // 2^(m_k - max), taken by the thread itself
    for (int idx = tid; idx < M * (DH / 4); idx += 32 * kConsumers) {
      const int r = idx / (DH / 4), d = 4 * (idx - r * (DH / 4));
      const int t = r >> 4, r16 = r & 15;
      float mk[kConsumers], mn = -INFINITY;
#pragma unroll
      for (int k = 0; k < kConsumers; ++k) {
        mk[k] = k < groups ? red_ml[2 * ((t + k * p.tiles) * 16 + r16)]
                           : -INFINITY;
        mn = fmaxf(mn, mk[k]);
      }
      const float ms = mn == -INFINITY ? 0.f : mn;
      float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kConsumers; ++k)
        if (k < groups) {
          const int w = (t + k * p.tiles) * 16 + r16;
          const float a = ex2(mk[k] - ms);
          const float4 v = *reinterpret_cast<const float4*>(
              red + w * L::kRedStride + d);
          sum = fmaf(red_ml[2 * w + 1], a, sum);
          out.x = fmaf(v.x, a, out.x);
          out.y = fmaf(v.y, a, out.y);
          out.z = fmaf(v.z, a, out.z);
          out.w = fmaf(v.w, a, out.w);
        }
      store(r, d, out, sum, mn);
    }
  }
}

// ---------------------------------------------------------------------------
// the merge of the splits, for both kernels
// ---------------------------------------------------------------------------
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one block per (q-head, query row), one thread per column: the live
// splits' partials merged in split order, kMergeBatch splits' loads in
// flight at once (one round trip for the serve paths' split counts)
constexpr int kMergeBatch = 8;
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
paged_merge_kernel(const float* __restrict__ ws, const int* __restrict__ pos,
                   T* __restrict__ o, int Hq, int P, int n_splits, int span) {
  const int h = blockIdx.x, z = blockIdx.y, d = threadIdx.x;
  const int p_z = pos[z];
  const int live = p_z < 0 ? 0 : min(n_splits, p_z / (span * P) + 1);
  const size_t part = (static_cast<size_t>(z) * Hq + h) * n_splits;
  const float* acc = ws + part * DH + d;
  const float* ml = ws + static_cast<size_t>(gridDim.y) * Hq * n_splits * DH
                    + 2 * part;
  // launched early (programmatic dependent launch): wait here until the
  // split grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mn = -INFINITY, sum = 0.f, out = 0.f;
  for (int s0 = 0; s0 < live; s0 += kMergeBatch) {
    float m[kMergeBatch], l[kMergeBatch], a[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      m[j] = -INFINITY;
      l[j] = a[j] = 0.f;
      if (s0 + j < live) {
        m[j] = ml[2 * (s0 + j)];
        l[j] = ml[2 * (s0 + j) + 1];
        a[j] = acc[static_cast<size_t>(s0 + j) * DH];
      }
    }
    float mb = mn;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) mb = fmaxf(mb, m[j]);
    const float r = weight(mn, mb);     // the earlier batches, rescaled
    sum *= r;
    out *= r;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const float w = weight(m[j], mb);
      sum = fmaf(l[j], w, sum);
      out = fmaf(a[j], w, out);
    }
    mn = mb;
  }
  o[(static_cast<size_t>(z) * Hq + h) * DH + d] =
      from_f<T>(sum == 0.f ? 0.f : out / sum);
}

// programmatic dependent launch: the merge grid is launched while the
// split grid runs, and waits for it inside (griddepcontrol.wait)
template <typename T, int DH>
int launch_merge(const float* ws, const int* pos, void* o, int rows, int Hq,
                 int P, int n_splits, int span, cudaStream_t st) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, rows);
  cfg.blockDim = dim3(DH);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, DH>, ws, pos,
                                     static_cast<T*>(o), Hq, P, n_splits,
                                     span);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *q, *kp, *vp;
  const int *bt, *pos;
  void* o;
  float* ws;
  int B, S, Hq, Hk, P, Np, n_pages, bt_stride, splits, span;
  int tiles, slot_shift, pages, stages;
  float scale;
  cudaStream_t st;
};

template <int DH, int G>
int launch_f32(const Args& a) {
  const dim3 grid(a.splits, a.Hk, a.B * a.S);
  paged_decode_kernel<DH, G><<<grid, kThreads, 0, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
      static_cast<const float*>(a.vp), a.bt, a.pos, static_cast<float*>(a.o),
      a.ws, a.S, a.P, a.Hk, a.n_pages, a.bt_stride, a.splits, a.span,
      a.scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  return launch_merge<float, DH>(a.ws, a.pos, a.o, a.B * a.S, a.Hq, a.P,
                                 a.splits, a.span, a.st);
}

template <int DH>
int dispatch_f32(const Args& a) {
  switch (a.Hq / a.Hk) {
    case 1: return launch_f32<DH, 1>(a);
    case 2: return launch_f32<DH, 2>(a);
    case 4: return launch_f32<DH, 4>(a);
    case 7: return launch_f32<DH, 7>(a);     // 56/8 heads (arctic-480b)
    case 8: return launch_f32<DH, 8>(a);
    case 12: return launch_f32<DH, 12>(a);   // 96/8 heads (nemotron-4-340b)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// A pool's tensor map: (W, P, Hk x dh/W, Np), a box of one page's `slot`
// rows (past P: zeros) of one kv-head's dh/W column blocks of W, swizzled
// rows.  Encoded once per (pool, page slot) and kept in a map of the
// calling host thread (no lock), which holds every pool it has seen: a
// serve tick calls the kernel on each layer's pool, one slice of a
// stacked tensor each, so a cache of a few entries would miss on every
// call.  A map holds only the pool's address, shape and strides, so a
// pool freed and another allocated at the same address with the same
// shape reuses it rightly; the map is emptied past kMapCache entries.
struct MapKey {
  const void* base;
  int Np, P, Hk, dh, slot;
  bool operator==(const MapKey& o) const {
    return base == o.base && Np == o.Np && P == o.P && Hk == o.Hk
           && dh == o.dh && slot == o.slot;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.base);
    for (int v : {k.Np, k.P, k.Hk, k.dh, k.slot})
      h = h * 1000003u ^ static_cast<size_t>(v);
    return h;
  }
};
constexpr size_t kMapCache = 4096;
thread_local std::unordered_map<MapKey, CUtensorMap, MapKeyHash> map_cache;
std::atomic<int> map_encodes{0};   // maps encoded, all threads

template <int DH>
int pool_map(const void* base, int Np, int P, int Hk, int slot,
             CUtensorMap* out) {
  const MapKey key{base, Np, P, Hk, DH, slot};
  const auto hit = map_cache.find(key);
  if (hit != map_cache.end()) {
    *out = hit->second;
    return 0;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  constexpr int W = Tc<DH>::kW, NC = Tc<DH>::kChunks;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {W, cuuint64_t(P), cuuint64_t(Hk) * NC,
                              cuuint64_t(Np)};
  const cuuint64_t strides[3] = {cuuint64_t(Hk) * DH * e, W * e,
                                 cuuint64_t(P) * Hk * DH * e};
  const cuuint32_t box[4] = {W, cuuint32_t(slot), NC, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  ++map_encodes;
  if (map_cache.size() >= kMapCache) map_cache.clear();
  map_cache.emplace(key, *out);
  return 0;
}

template <int DH>
int launch_bf16(const Args& a) {
  using L = Tc<DH>;
  const int G = a.Hq / a.Hk, M = G * a.S, slot = 1 << a.slot_shift;
  if ((a.tiles != 1 && a.tiles != 2 && a.tiles != 4) || a.slot_shift < 3 || slot > 256 || slot < a.P || a.pages < 1
      || (a.pages * slot) % (16 * (kConsumers / a.tiles)) != 0
      || a.stages < 1 || a.stages > kMaxStages
      || (a.splits > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tk, tv;
  int err = pool_map<DH>(a.kp, a.Np, a.P, a.Hk, slot, &tk);
  if (!err) err = pool_map<DH>(a.vp, a.Np, a.P, a.Hk, slot, &tv);
  if (err) return err;
  static unsigned opted_in = 0;   // devices whose attribute is set (bit set)
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  if (dev >= 32 || !(opted_in >> dev & 1u)) {
    ce = cudaFuncSetAttribute(paged_tc_kernel<DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              227 * 1024);
    if (ce != cudaSuccess) return static_cast<int>(ce);
    if (dev < 32) opted_in |= 1u << dev;
  }
  TcParams prm;
  prm.q = static_cast<const __nv_bfloat16*>(a.q);
  prm.bt = a.bt;
  prm.pos = a.pos;
  prm.o = static_cast<__nv_bfloat16*>(a.o);
  prm.ws = a.ws;
  prm.S = a.S;
  prm.Hq = a.Hq;
  prm.G = G;
  prm.M = M;
  prm.tiles = a.tiles;
  prm.chunks = (M + 16 * a.tiles - 1) / (16 * a.tiles);
  prm.P = a.P;
  prm.slot_shift = a.slot_shift;
  prm.pages = a.pages;
  prm.stages = a.stages;
  prm.n_pages = a.n_pages;
  prm.Np = a.Np;
  prm.bt_stride = a.bt_stride;
  prm.splits = a.splits;
  prm.span = a.span;
  prm.scale_log2 = a.scale * kLog2e;
  const dim3 grid(a.splits, a.Hk * prm.chunks, a.B);
  paged_tc_kernel<DH><<<grid, kTcThreads,
                        L::smem(a.stages, a.pages * slot, a.tiles, a.span),
                        a.st>>>(tk, tv, prm);
  ce = cudaGetLastError();
  if (ce != cudaSuccess || a.splits == 1) return static_cast<int>(ce);
  return launch_merge<__nv_bfloat16, DH>(a.ws, a.pos, a.o, a.B * a.S, a.Hq,
                                         a.P, a.splits, a.span, a.st);
}

template <int DH>
int launch(const Args& a, int dtype) {
  if (dtype == 0) return dispatch_f32<DH>(a);
  if (dtype == 1) return launch_bf16<DH>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (FMA kernel, a block per query row), 1 = bfloat16
// (Hopper kernel, a block per table row and 16*tiles of its G*S rows).
// q (B,S,Hq,dh), pos (B,S); a
// split takes `span` pages of a table row; with splits > 1, `workspace`
// holds B*S*Hq*splits*(dh+2) floats.  The bf16 kernel takes the rest of
// its plan (kernels/paged_attention.py `plan`): 16-row tiles (1, 2 or 4),
// log2 of a page slot's rows, pages a stage and stages; the fp32 kernel
// ignores them.  Returns cudaGetLastError() after the launches
// (0 = launched), or an encode error (see kEncodeError).
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* block_tables,
                                   const void* pos, void* o, void* workspace,
                                   int B, int S, int Hq, int Hk, int dh, int P,
                                   int Np, int n_pages, int bt_stride,
                                   int splits, int span, int tiles,
                                   int slot_shift, int pages, int stages,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hk <= 0 || Hq % Hk != 0 || P <= 0 || Np <= 0 ||
      n_pages <= 0 || splits <= 0 || span <= 0 ||
      static_cast<long long>(splits) * span < n_pages ||
      (splits > 1 && workspace == nullptr) || (dtype == 0 && span > kMaxSpan))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.kp = k_pool;
  a.vp = v_pool;
  a.bt = static_cast<const int*>(block_tables);
  a.pos = static_cast<const int*>(pos);
  a.o = o;
  a.ws = static_cast<float*>(workspace);
  a.B = B;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.P = P;
  a.Np = Np;
  a.n_pages = n_pages;
  a.bt_stride = bt_stride;
  a.splits = splits;
  a.span = span;
  a.tiles = tiles;
  a.slot_shift = slot_shift;
  a.pages = pages;
  a.stages = stages;
  a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 96: return launch<96>(a, dtype);     // phi-3-vision-4.2b
    case 128: return launch<128>(a, dtype);
    case 192: return launch<192>(a, dtype);   // nemotron-4-340b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the bf16 kernel at head dim `dh` that one SM holds with `smem`
// bytes of dynamic shared memory each (the card's occupancy calculator:
// registers, shared memory, threads), or -1 for a head dim it lacks.
extern "C" int paged_tc_blocks_per_sm(int dh, int smem) {
  int n = -1;
  cudaError_t e = cudaSuccess;
  auto query = [&](auto kernel) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        kTcThreads, smem);
  };
  switch (dh) {
    case 32: query(paged_tc_kernel<32>); break;
    case 64: query(paged_tc_kernel<64>); break;
    case 96: query(paged_tc_kernel<96>); break;
    case 128: query(paged_tc_kernel<128>); break;
    case 192: query(paged_tc_kernel<192>); break;
    default: return -1;
  }
  return e == cudaSuccess ? n : -1;
}

// Tensor maps the bf16 launcher has encoded since the library loaded, in
// all host threads (a cached map is not encoded again).
extern "C" int paged_map_encodes() {
  return static_cast<int>(map_encodes.load());
}
