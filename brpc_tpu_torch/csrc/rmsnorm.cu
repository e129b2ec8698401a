// Fused RMSNorm, forward and backward, fp32 or bf16, for Hopper (sm_90a).
//
// The forward replaces the TPU kernel `_rmsnorm_kernel` behind
// `_rmsnorm_fwd_call` / `rmsnorm` in brpc_tpu/tpu/pallas_ops.py:
//
//   out = x * r * w,   r = rsqrt(mean(x^2) + eps)   over the last dim,
//
// in fp32, written in the input dtype. The backward replaces the JAX
// package's `_rmsnorm_diff_bwd` (pallas_ops.py:95, left to XLA, which fuses
// it into two passes; PyTorch eager has no such fusion):
//
//   dx = g * w * r - x * (r^3 / D) * sum(g * w * x)     per row
//   dw = sum over rows of g * x * r
//
// in fp32, dx cast to x's dtype and dw to w's. x, g, dx are [N, D] (any N:
// each row is independent), w and dw are [D].
//
// What bounds both on this card: bytes. At the flagship training shape
// (8192 x 1024, bf16) the forward must move 33.6 MB (x read, out written)
// and the backward 50.3 MB (x and g read, dx written): 0.0100 and 0.0150
// ms at 3.35 TB/s; the arithmetic is a few FLOP an element in fp32.
//
// Design. A persistent grid (the SM count times the blocks an SM holds)
// of 8-warp blocks; a warp takes one row at a time.
// - Rows of 16-byte multiples (D * sizeof(T) % 16 == 0) up to a register
//   cap ride in registers: each lane loads its 16-byte vectors of the row
//   once (8 bf16 or 4 fp32 a load), the row's sums are warp shuffles, and
//   the lane writes its vectors of the result from the same registers, so
//   x is read from device memory once and never again. The forward holds
//   w in registers, loaded once per warp; the backward stages it in shared
//   memory once per block, and keeps its dw partials there too, so its
//   registers hold little more than x and g.
// - Odd rows (not 16-byte multiples, so row starts are not aligned) take
//   the same kernels' looped form with scalar loads; rows past the cap
//   take it with vector loads. The looped forward reads x twice (the
//   second pass from L1/L2), the looped backward runs one row per block.
// - dw without atomics: each warp keeps fp32 partials for its lanes'
//   columns across its rows in shared memory; a block's warps add theirs
//   into one row of a [blocks, D] fp32 buffer in a fixed order (warp 0,
//   1, ... 7), and a second short kernel sums the blocks' rows in a fixed
//   order and casts. The result is the same bits run after run.

#include "common.cuh"

#include <atomic>
#include <math.h>

namespace {

using namespace brpc;

constexpr int kWarps = 8;              // warps (rows in flight) per block
constexpr int kBlock = kWarps * 32;    // threads per block
// the register cap: 16-byte vectors a lane holds of a row, of x and w in
// the forward, of x and g in the backward (packed)
constexpr int kFwdMaxVecs = 8;         // D <= 2048 bf16, 1024 fp32
constexpr int kBwdMaxVecs = 4;         // D <= 1024 bf16, 512 fp32
// the backward's blocks an SM holds (up to 128 registers a thread, 34 KB
// of shared memory a block; 1, 3 or 4 ran slower: bench/rmsnorm_designs.py):
// pallas_ops._RMS_BWD_BLOCKS_PER_SM
constexpr int kBwdBlocksPerSm = 2;
constexpr int kFinishCols = 8;         // columns per block of the finish
constexpr int kFinishGroups = 64;      // its row groups

// 16 bytes of T as floats: N elements, element 0 in the low bits
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// E consecutive elements at index j * E of p: one 16-byte access when E is
// Pack<T>::N (p and the offset 16-byte aligned), else E == 1
template <typename T, int E>
__device__ __forceinline__ void load(const T* p, int j, float (&f)[E]) {
  if constexpr (E == 1) {
    f[0] = to_f32(p[j]);
  } else {
    static_assert(E == Pack<T>::N, "16-byte access");
    Pack<T>::unpack(reinterpret_cast<const uint4*>(p)[j], f);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store(T* p, int j, const float (&f)[E]) {
  if constexpr (E == 1) {
    p[j] = from_f32<T>(f[0]);
  } else {
    reinterpret_cast<uint4*>(p)[j] = Pack<T>::pack(f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------- forward

// rows in registers: NV 16-byte vectors a lane (vector j = lane + 32 k)
template <typename T, int NV>
__global__ void __launch_bounds__(kBlock)
rmsnorm_fwd_regs(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int64_t rows, int d, float eps) {
  constexpr int E = Pack<T>::N;
  const int lane = threadIdx.x % 32;
  const int nvec = d / E;
  uint4 wv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + 32 * k < nvec) {
      wv[k] = reinterpret_cast<const uint4*>(w)[lane + 32 * k];
    }
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                     threadIdx.x / 32;
       row < rows; row += step) {  // the whole warp takes the same rows
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4 xv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) xv[k] = xr[lane + 32 * k];
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) {
        float f[E];
        Pack<T>::unpack(xv[k], f);
#pragma unroll
        for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
      }
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) {
        float f[E], wf[E];
        Pack<T>::unpack(xv[k], f);
        Pack<T>::unpack(wv[k], wf);
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = f[e] * r * wf[e];
        orow[lane + 32 * k] = Pack<T>::pack(f);
      }
    }
  }
}

// any width: E elements an access (1, or a 16-byte vector), two passes
template <typename T, int E>
__global__ void __launch_bounds__(kBlock)
rmsnorm_fwd_loop(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int n = d / E;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                     threadIdx.x / 32;
       row < rows; row += step) {
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int j = lane; j < n; j += 32) {
      float f[E];
      load<T, E>(xr, j, f);
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
    }
    const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
    T* orow = out + row * d;
    for (int j = lane; j < n; j += 32) {
      float f[E], wf[E];
      load<T, E>(xr, j, f);
      load<T, E>(w, j, wf);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = f[e] * r * wf[e];
      store<T, E>(orow, j, f);
    }
  }
}

int sm_count() {
  // per device, read once: the persistent grids' size
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<int>& slot = cache[dev & 63];
  int n = slot.load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    n = n > 0 ? n : 1;
    slot.store(n, std::memory_order_relaxed);
  }
  return n;
}

// one launch of the forward kernel of a path (NV > 0: rows in registers,
// NV 16-byte vectors a lane; NV == 0: looped, E elements an access) on a
// persistent grid: as many blocks as the card holds at once (asked once
// per kernel), no more than the rows need
template <typename T, int NV, int E>
void launch_fwd(const void* x, const void* w, void* out, int64_t rows, int d,
                float eps, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, T*, int64_t, int, float);
  if constexpr (NV > 0) {
    kernel = rmsnorm_fwd_regs<T, NV>;
  } else {
    kernel = rmsnorm_fwd_loop<T, E>;
  }
  static const int per_sm = [kernel] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBlock, 0);
    return n > 0 ? n : 1;
  }();
  const int64_t want = (rows + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm;
  kernel<<<static_cast<unsigned>(want < cap ? want : cap), kBlock, 0,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                     static_cast<T*>(out), rows, d, eps);
}

template <typename T>
void forward(const void* x, const void* w, void* out, int64_t rows, int d,
             float eps, cudaStream_t st) {
  constexpr int E = Pack<T>::N;
  const int nvec = d / E;
  if ((d * sizeof(T)) % 16 != 0) {
    launch_fwd<T, 0, 1>(x, w, out, rows, d, eps, st);
  } else if (nvec <= 32) {
    launch_fwd<T, 1, E>(x, w, out, rows, d, eps, st);
  } else if (nvec <= 64) {
    launch_fwd<T, 2, E>(x, w, out, rows, d, eps, st);
  } else if (nvec <= 128) {
    launch_fwd<T, 4, E>(x, w, out, rows, d, eps, st);
  } else if (nvec <= 32 * kFwdMaxVecs) {
    launch_fwd<T, kFwdMaxVecs, E>(x, w, out, rows, d, eps, st);
  } else {
    launch_fwd<T, 0, E>(x, w, out, rows, d, eps, st);
  }
}

// --------------------------------------------------------------- backward

// the contiguous chunk of rows block b takes: [lo, hi)
__device__ __forceinline__ void block_rows(int64_t rows, int64_t& lo,
                                           int64_t& hi) {
  const int64_t chunk = (rows + gridDim.x - 1) / gridDim.x;
  lo = static_cast<int64_t>(blockIdx.x) * chunk;
  hi = lo + chunk < rows ? lo + chunk : rows;
}

// rows in registers: NV 16-byte vectors a lane of x and of g; each warp
// keeps fp32 partials of dw for its lanes' columns in shared memory across
// its rows, laid out so that the lanes of a warp touch consecutive
// 16-byte words
template <typename T, int NV>
__global__ void __launch_bounds__(kBlock, kBwdBlocksPerSm)
rmsnorm_bwd_regs(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partials, int64_t rows, int d,
                 float eps) {
  constexpr int E = Pack<T>::N;
  constexpr int Q = E / 4;                 // float4s of one vector's values
  constexpr int kVecs = 32 * NV;           // vectors of the widest row
  __shared__ uint4 sw[kVecs];              // w, staged once
  // warp k's partial of column 4 (q + Q j) + t at sacc[k][q * kVecs + j].t
  __shared__ float4 sacc[kWarps][Q * kVecs];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nvec = d / E;
  for (int j = threadIdx.x; j < nvec; j += kBlock) {
    sw[j] = reinterpret_cast<const uint4*>(w)[j];
  }
  for (int i = lane; i < Q * kVecs; i += 32) {
    sacc[warp][i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const float inv_d = 1.f / static_cast<float>(d);
  int64_t lo, hi;
  block_rows(rows, lo, hi);
  for (int64_t row = lo + warp; row < hi; row += kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    const uint4* gr = reinterpret_cast<const uint4*>(g + row * d);
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) {
        xv[k] = xr[lane + 32 * k];
        gv[k] = gr[lane + 32 * k];
      }
    }
    float ss = 0.f, sgwx = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) {
        float xf[E], gf[E], wf[E];
        Pack<T>::unpack(xv[k], xf);
        Pack<T>::unpack(gv[k], gf);
        Pack<T>::unpack(sw[lane + 32 * k], wf);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          sgwx = fmaf(gf[e] * wf[e], xf[e], sgwx);
        }
      }
    }
    ss = warp_sum(ss);
    sgwx = warp_sum(sgwx);
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = r * r * r * inv_d * sgwx;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + 32 * k;
      if (j < nvec) {
        float xf[E], gf[E], wf[E], o[E];
        Pack<T>::unpack(xv[k], xf);
        Pack<T>::unpack(gv[k], gf);
        Pack<T>::unpack(sw[j], wf);
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = gf[e] * wf[e] * r - xf[e] * c;
        dxr[j] = Pack<T>::pack(o);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float4& a = sacc[warp][q * kVecs + j];
          a.x = fmaf(gf[4 * q] * xf[4 * q], r, a.x);
          a.y = fmaf(gf[4 * q + 1] * xf[4 * q + 1], r, a.y);
          a.z = fmaf(gf[4 * q + 2] * xf[4 * q + 2], r, a.z);
          a.w = fmaf(gf[4 * q + 3] * xf[4 * q + 3], r, a.w);
        }
      }
    }
  }
  __syncthreads();
  // the warps' partials into the block's row, in warp order
  float4* prow = reinterpret_cast<float4*>(
      partials + static_cast<int64_t>(blockIdx.x) * d);
  for (int i = threadIdx.x; i < d / 4; i += kBlock) {
    const int at = (i % Q) * kVecs + i / Q;  // float4 i = (j, q) = (i/Q, i%Q)
    float4 s = sacc[0][at];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      const float4 v = sacc[k][at];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    prow[i] = s;
  }
}

// any width, one row at a time per block: E elements an access (1, or a
// 16-byte vector); thread t owns the accesses t, t + kBlock, ... of every
// row, and keeps its dw partials in the block's row of `partials`
template <typename T, int E>
__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_loop(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partials, int64_t rows, int d,
                 float eps) {
  __shared__ float red[2][kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = d / E;
  const float inv_d = 1.f / static_cast<float>(d);
  float* prow = partials + static_cast<int64_t>(blockIdx.x) * d;
  for (int j = threadIdx.x; j < n; j += kBlock) {
    // this thread's own columns, which the same thread adds to below
#pragma unroll
    for (int e = 0; e < E; ++e) prow[j * E + e] = 0.f;
  }
  int64_t lo, hi;
  block_rows(rows, lo, hi);
  for (int64_t row = lo; row < hi; ++row) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float ss = 0.f, sgwx = 0.f;
    for (int j = threadIdx.x; j < n; j += kBlock) {
      float xf[E], gf[E], wf[E];
      load<T, E>(xr, j, xf);
      load<T, E>(gr, j, gf);
      load<T, E>(w, j, wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ss = fmaf(xf[e], xf[e], ss);
        sgwx = fmaf(gf[e] * wf[e], xf[e], sgwx);
      }
    }
    ss = warp_sum(ss);
    sgwx = warp_sum(sgwx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sgwx;
    }
    __syncthreads();
    ss = 0.f;
    sgwx = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {  // in a fixed order
      ss += red[0][i];
      sgwx += red[1][i];
    }
    __syncthreads();  // red is written again for the next row
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = r * r * r * inv_d * sgwx;
    T* dxr = dx + row * d;
    for (int j = threadIdx.x; j < n; j += kBlock) {
      float xf[E], gf[E], wf[E], o[E];
      load<T, E>(xr, j, xf);
      load<T, E>(gr, j, gf);
      load<T, E>(w, j, wf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[e] = gf[e] * wf[e] * r - xf[e] * c;
        prow[j * E + e] = fmaf(gf[e] * xf[e], r, prow[j * E + e]);
      }
      store<T, E>(dxr, j, o);
    }
  }
}

// dw[c] = the blocks' partial rows summed in a fixed order: thread (tx, ty)
// sums rows ty, ty + kFinishGroups, ... of column c, then the groups' sums
// meet in a fixed tree (ty += ty + stride, stride = kFinishGroups / 2 ...)
template <typename T>
__global__ void __launch_bounds__(kFinishCols * kFinishGroups)
rmsnorm_bwd_finish(const float* __restrict__ partials, T* __restrict__ dw,
                   int blocks, int d) {
  static_assert((kFinishGroups & (kFinishGroups - 1)) == 0, "a tree");
  __shared__ float part[kFinishGroups][kFinishCols + 1];
  const int tx = threadIdx.x % kFinishCols, ty = threadIdx.x / kFinishCols;
  const int col = blockIdx.x * kFinishCols + tx;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int b = ty; b < blocks; b += kFinishGroups) {
      s += partials[static_cast<int64_t>(b) * d + col];
    }
  }
  part[ty][tx] = s;
#pragma unroll
  for (int stride = kFinishGroups / 2; stride > 0; stride /= 2) {
    __syncthreads();
    if (ty < stride) part[ty][tx] += part[ty + stride][tx];
  }
  if (ty == 0 && col < d) dw[col] = from_f32<T>(part[0][tx]);
}

// one launch of the backward kernel of a path (as launch_fwd's) on the
// caller's grid, then the finishing sum
template <typename T, int NV, int E>
void launch_bwd(const void* x, const void* w, const void* g, void* dx,
                void* dw, void* partials, int64_t rows, int d, int blocks,
                float eps, cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, float*, int64_t, int,
                 float);
  if constexpr (NV > 0) {
    kernel = rmsnorm_bwd_regs<T, NV>;
  } else {
    kernel = rmsnorm_bwd_loop<T, E>;
  }
  kernel<<<blocks, kBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(partials), rows, d, eps);
  rmsnorm_bwd_finish<T><<<(d + kFinishCols - 1) / kFinishCols,
                          kFinishCols * kFinishGroups, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(dw), blocks, d);
}

template <typename T>
void backward(const void* x, const void* w, const void* g, void* dx,
              void* dw, void* partials, int64_t rows, int d, int blocks,
              float eps, cudaStream_t st) {
  constexpr int E = Pack<T>::N;
  const int nvec = d / E;
  if ((d * sizeof(T)) % 16 != 0) {
    launch_bwd<T, 0, 1>(x, w, g, dx, dw, partials, rows, d, blocks, eps, st);
  } else if (nvec <= 32) {
    launch_bwd<T, 1, E>(x, w, g, dx, dw, partials, rows, d, blocks, eps, st);
  } else if (nvec <= 64) {
    launch_bwd<T, 2, E>(x, w, g, dx, dw, partials, rows, d, blocks, eps, st);
  } else if (nvec <= 32 * kBwdMaxVecs) {
    launch_bwd<T, kBwdMaxVecs, E>(x, w, g, dx, dw, partials, rows, d, blocks,
                                  eps, st);
  } else {
    launch_bwd<T, 0, E>(x, w, g, dx, dw, partials, rows, d, blocks, eps, st);
  }
}

}  // namespace

// x and out [rows, d], w [d], all contiguous and 16-byte aligned in one
// dtype (0 = fp32, 1 = bf16). Launches on `stream` and returns
// cudaGetLastError(); an unsupported dtype returns cudaErrorInvalidValue
// without launching.
extern "C" int brpc_rmsnorm(const void* x, const void* w, void* out,
                            int64_t rows, int d, int dtype, float eps,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    forward<float>(x, w, out, rows, d, eps, st);
  } else if (dtype == kBFloat16) {
    forward<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, g and dx [rows, d], w and dw [d], all contiguous and 16-byte aligned
// in one dtype; partials [blocks, d] fp32 scratch, blocks >= 1 (any count
// is right; pallas_ops takes the SM count times kBwdBlocksPerSm, at most
// ceil(rows / 8)). Two launches on `stream`, the rows and the finishing
// sum; returns cudaGetLastError(), or cudaErrorInvalidValue without
// launching for an unsupported dtype or no block.
extern "C" int brpc_rmsnorm_bwd(const void* x, const void* w, const void* g,
                                void* dx, void* dw, void* partials,
                                int64_t rows, int d, int blocks, int dtype,
                                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32) {
    backward<float>(x, w, g, dx, dw, partials, rows, d, blocks, eps, st);
  } else if (dtype == kBFloat16) {
    backward<__nv_bfloat16>(x, w, g, dx, dw, partials, rows, d, blocks, eps,
                            st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
