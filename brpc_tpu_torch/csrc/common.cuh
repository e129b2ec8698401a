// Helpers shared by every kernel source (flash_fwd.cu, flash_bwd.cu,
// rmsnorm.cu): fp32 / bf16 loads and stores, the row layout of the
// attention kernels, and the error-string export every library carries.
//
// Each source is built into its own shared library, so the extern "C"
// function below exists once per library; _build.py hashes this header
// into every library's name, so an edit rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace brpc {

// NEG_INF of brpc_tpu_torch/tpu/pallas_ops.py: the lse of a row that saw
// no key; the backward kernels treat lse <= kNegInf / 2 as P = 0.
constexpr float kNegInf = -1e30f;

// dtype codes of the C interface (pallas_ops._DTYPES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the cast the JAX kernels apply to P and dS
// before their products (p.astype(v.dtype), ds.astype(k.dtype))
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// four consecutive elements as a float4; p is aligned to 4 elements
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------
// Row layout of the attention kernels. A row of D values (one query, or
// one key) is held by G = D / 8 neighbouring lanes of a warp; lane c of
// the group holds the float4 chunks c and c + G, that is dims 4c..4c+3
// and 4(c+G)..4(c+G)+3. The G lanes then read a row staged in shared
// memory as consecutive 16-byte words (no bank conflict), and a dot
// product of two rows is the lanes' partial sums reduced by log2(G)
// shuffles. Every lane of the warp must take part in the shuffles, so a
// row past the end of the sequence computes on zeros and writes nothing.
// ---------------------------------------------------------------------
constexpr int kThreads = 128;  // threads per block
constexpr int kTile = 32;      // rows per shared-memory tile

template <int D>
struct Rows {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static constexpr int G = D / 8;            // lanes per row
  static constexpr int kPerBlock = kThreads / G;  // rows per block
};

// this lane's 8 values of a row in global memory (zeros when !live)
template <int D, typename T>
__device__ __forceinline__ void load_row(const T* row, int lane, bool live,
                                         float (&r)[8]) {
  constexpr int G = Rows<D>::G;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (live) {
    a = load4(row + 4 * lane);
    b = load4(row + 4 * (lane + G));
  }
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

template <int D, typename T>
__device__ __forceinline__ void store_row(T* row, int lane, const float (&r)[8],
                                          float scale) {
  constexpr int G = Rows<D>::G;
  store4(row + 4 * lane, make_float4(r[0] * scale, r[1] * scale,
                                     r[2] * scale, r[3] * scale));
  store4(row + 4 * (lane + G), make_float4(r[4] * scale, r[5] * scale,
                                           r[6] * scale, r[7] * scale));
}

// this lane's 8 values of a row staged in shared memory
template <int D>
__device__ __forceinline__ void shared_row(const float* srow, int lane,
                                           float (&r)[8]) {
  constexpr int G = Rows<D>::G;
  const float4 a = *reinterpret_cast<const float4*>(srow + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(srow + 4 * (lane + G));
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ float dot8(const float (&a)[8], const float (&b)[8]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// sum over the G lanes of one row group
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// rows [r0, r0 + kTile) of a [rows, D] matrix whose rows lie `rs`
// elements apart into a float tile in shared memory, zeros past `rows`;
// called by all kThreads threads
template <int D, typename T>
__device__ __forceinline__ void stage_tile(const T* src, int r0, int rows,
                                           float (*tile)[D], int64_t rs = D) {
  constexpr int kChunks = D / 4;             // float4 chunks of a row
  constexpr int kStep = kThreads / kChunks;  // rows the block loads at once
  static_assert(kThreads % kChunks == 0, "a pass covers whole rows");
  const int c = threadIdx.x % kChunks;
  int j = threadIdx.x / kChunks;
  // the row pointer advances by a fixed step: no multiply per load
  const T* p = src + static_cast<int64_t>(r0 + j) * rs + 4 * c;
  for (; j < kTile; j += kStep, p += kStep * rs) {
    const float4 x = r0 + j < rows ? load4(p)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&tile[j][4 * c]) = x;
  }
}

}  // namespace brpc

extern "C" const char* brpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
