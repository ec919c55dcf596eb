// Natural compression to the uint8 wire format, and back, for sm_90a.
//
// Replaces the Pallas TPU kernels `nc_pack` and `nc_unpack` in
// src/repro/kernels/nat_compress.py (bodies `_pack_kernel`,
// `_unpack_kernel`).  Same semantics: |x| = 2^e (1 + p) with p in [0, 1)
// rounds up to 2^(e+1) when the caller's uniform u < p, else down to 2^e;
// the byte holds the sign in bit 7 and the code e + up + 70 clipped to
// 1..127 in bits 0-6, code 0 for x == 0.  Unpack writes sign * 2^(code-70).
//
// Exactness: e and p come from the float's bit fields (a subnormal is
// scaled by 2^23 first, exactly), where the TPU kernel takes
// floor(log2|x|) and exp2(e); log2 and exp2 are inexact near powers of
// two on some backends, the bit fields never are.  Unpack builds 2^(code-70)
// from its exponent bits; every such power is a normal fp32 and bf16
// number, so both output types are exact.  The kernel and the plain
// version (kernels/ref.py `nc_pack_ref`, `nc_unpack_ref`) agree bit for bit.
//
// What bounds it on an H100: pack reads x (4 B fp32, 2 B bf16) and u (4 B)
// and writes 1 B per element; unpack reads 1 B and writes 4 or 2 B.  A
// handful of integer operations per element is far below the card's rate,
// so memory bandwidth (3.35 TB/s) bounds both.
//
// Design: one pass over the flat array, no padding to the TPU's (256, 128)
// tiles.  Each thread takes groups of four elements in a grid-stride loop:
// a 16-byte load of u (and of fp32 x, 8 bytes of bf16 x), one 4-byte store
// of the four codes; unpack reads four codes as one word and writes 16
// (fp32) or 8 (bf16) bytes.  A tail of n % 4 elements, or every element
// when a pointer is not aligned for the vector access, goes one at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBias = 70;
constexpr uint32_t kSubnormalLimit = 1u << 23;   // bit patterns below
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float bf16_bits_to_f(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t pack1(float x, float u) {
  float a = fabsf(x);
  uint32_t bits = __float_as_uint(a);
  int e_adj = 0;
  if (bits < kSubnormalLimit) {                 // zero or subnormal
    bits = __float_as_uint(a * 8388608.0f);     // * 2^23, exact
    e_adj = 23;
  }
  int e = static_cast<int>(bits >> 23) - 127 - e_adj;
  float p = static_cast<float>(bits & (kSubnormalLimit - 1)) *
            (1.0f / 8388608.0f);
  int code = e + (u < p ? 1 : 0) + kBias;
  code = min(max(code, 1), 127);
  if (a == 0.0f) code = 0;
  return static_cast<uint32_t>(code | (x < 0.0f ? 0x80 : 0));
}

__device__ __forceinline__ uint32_t unpack1_bits(uint32_t b) {
  uint32_t code = b & 0x7Fu;
  uint32_t mag = code == 0 ? 0u : (code - kBias + 127) << 23;
  return mag | ((b & 0x80u) << 24);              // sign to bit 31
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float load(const void* x, int64_t i) {
    return static_cast<const float*>(x)[i];
  }
  __device__ static void load4(const void* x, int64_t g, float v[4]) {
    float4 w = static_cast<const float4*>(x)[g];
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
  __device__ static void store(void* o, int64_t i, uint32_t fbits) {
    static_cast<uint32_t*>(o)[i] = fbits;
  }
  __device__ static void store4(void* o, int64_t g, const uint32_t f[4]) {
    static_cast<uint4*>(o)[g] = make_uint4(f[0], f[1], f[2], f[3]);
  }
  static constexpr int kAlign = 16;
};

// bf16 stays raw 16-bit words: widening is a shift, and the powers of two
// unpack writes are exact in bf16, so narrowing is a shift too.
struct Bf16 {};
template <>
struct Elem<Bf16> {
  __device__ static float load(const void* x, int64_t i) {
    return bf16_bits_to_f(static_cast<const uint16_t*>(x)[i]);
  }
  __device__ static void load4(const void* x, int64_t g, float v[4]) {
    uint2 w = static_cast<const uint2*>(x)[g];
    v[0] = bf16_bits_to_f(w.x & 0xFFFFu); v[1] = bf16_bits_to_f(w.x >> 16);
    v[2] = bf16_bits_to_f(w.y & 0xFFFFu); v[3] = bf16_bits_to_f(w.y >> 16);
  }
  __device__ static void store(void* o, int64_t i, uint32_t fbits) {
    static_cast<uint16_t*>(o)[i] = static_cast<uint16_t>(fbits >> 16);
  }
  __device__ static void store4(void* o, int64_t g, const uint32_t f[4]) {
    static_cast<uint2*>(o)[g] = make_uint2((f[0] >> 16) | (f[1] & 0xFFFF0000u),
                                           (f[2] >> 16) | (f[3] & 0xFFFF0000u));
  }
  static constexpr int kAlign = 8;
};

template <typename T>
__global__ void pack_kernel(const void* __restrict__ x,
                            const float* __restrict__ u,
                            uint8_t* __restrict__ out, int64_t n,
                            int64_t n_groups) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t g = tid; g < n_groups; g += stride) {
    float v[4];
    Elem<T>::load4(x, g, v);
    float4 r = reinterpret_cast<const float4*>(u)[g];
    uint32_t w = pack1(v[0], r.x) | (pack1(v[1], r.y) << 8) |
                 (pack1(v[2], r.z) << 16) | (pack1(v[3], r.w) << 24);
    reinterpret_cast<uint32_t*>(out)[g] = w;
  }
  for (int64_t i = 4 * n_groups + tid; i < n; i += stride)
    out[i] = static_cast<uint8_t>(pack1(Elem<T>::load(x, i), u[i]));
}

template <typename T>
__global__ void unpack_kernel(const uint8_t* __restrict__ b,
                              void* __restrict__ out, int64_t n,
                              int64_t n_groups) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t g = tid; g < n_groups; g += stride) {
    uint32_t w = reinterpret_cast<const uint32_t*>(b)[g];
    uint32_t f[4] = {unpack1_bits(w & 0xFFu), unpack1_bits((w >> 8) & 0xFFu),
                     unpack1_bits((w >> 16) & 0xFFu), unpack1_bits(w >> 24)};
    Elem<T>::store4(out, g, f);
  }
  for (int64_t i = 4 * n_groups + tid; i < n; i += stride)
    Elem<T>::store(out, i, unpack1_bits(b[i]));
}

bool aligned(const void* p, int a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int launch_pack(const void* x, const float* u, uint8_t* out, int64_t n,
                cudaStream_t st) {
  const bool vec = aligned(x, Elem<T>::kAlign) && aligned(u, 16) &&
                   aligned(out, 4);
  const int64_t groups = vec ? n / 4 : 0;
  pack_kernel<T><<<grid_for(groups > 0 ? groups : n), kThreads, 0, st>>>(
      x, u, out, n, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_unpack(const uint8_t* b, void* out, int64_t n, cudaStream_t st) {
  const bool vec = aligned(b, 4) && aligned(out, Elem<T>::kAlign);
  const int64_t groups = vec ? n / 4 : 0;
  unpack_kernel<T><<<grid_for(groups > 0 ? groups : n), kThreads, 0, st>>>(
      b, out, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x for pack, of out for unpack).
// Each returns cudaGetLastError() after its launch (0 = launched).
extern "C" int nc_pack_fwd(const void* x, const void* u, void* out,
                           long long n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* uf = static_cast<const float*>(u);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (dtype == 0) return launch_pack<float>(x, uf, o, n, st);
  if (dtype == 1) return launch_pack<Bf16>(x, uf, o, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int nc_unpack_fwd(const void* b, void* out, long long n, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* bb = static_cast<const uint8_t*>(b);
  if (dtype == 0) return launch_unpack<float>(bb, out, n, st);
  if (dtype == 1) return launch_unpack<Bf16>(bb, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
