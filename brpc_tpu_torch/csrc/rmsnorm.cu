// Fused RMSNorm forward, fp32 or bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rmsnorm_kernel` behind `_rmsnorm_fwd_call` /
// `rmsnorm` in brpc_tpu/tpu/pallas_ops.py:
//
//   out = x * rsqrt(mean(x^2) + eps) * w     over the last dim, in fp32,
//
// written in the input dtype. x is [N, D] (any N: the TPU wrapper pads
// rows to a 256-row grid, here each row is independent), w is [D] in the
// same dtype. The backward stays plain PyTorch, as it stays XLA in the
// JAX package.
//
// Design: one warp per row, kWarps rows per block. Each lane sums the
// squares of every 32nd element in fp32, a shuffle reduction gives the
// row's sum, and the lanes write the scaled row in a second pass over x
// (read again from L1/L2, not from device memory, for rows of a few KB).
// Loads are coalesced across the warp; any D is taken.
//
// What bounds it on this card: bytes. At the flagship training shape
// (8192 x 1024, bf16) it must move about 33.6 MB (x read once, the output
// written once, w) and do about 25 MFLOP: 0.010 ms at 3.35 TB/s.

#include "common.cuh"

#include <math.h>

namespace {

using namespace brpc;

constexpr int kWarps = 8;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xv = to_f32(xr[i]);
    ss = fmaf(xv, xv, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int64_t rows, int d,
            float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                      stream>>>(static_cast<const T*>(x),
                                static_cast<const T*>(w),
                                static_cast<T*>(out), rows, d, eps);
}

}  // namespace

// x and out [rows, d], w [d], all contiguous in one dtype (0 = fp32,
// 1 = bf16). Launches on `stream` and returns cudaGetLastError(); an
// unsupported dtype returns cudaErrorInvalidValue without launching.
extern "C" int brpc_rmsnorm(const void* x, const void* w, void* out,
                            int64_t rows, int d, int dtype, float eps,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    launch<float>(x, w, out, rows, d, eps, st);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
