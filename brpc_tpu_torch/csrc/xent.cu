// Fused softmax cross-entropy forward, per-row NLL, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_xent_kernel` behind `_xent_forward_rows` /
// `softmax_xent` in brpc_tpu/tpu/pallas_ops.py:
//
//   nll[r] = logsumexp(x[r, :]) - x[r, t[r]]     in fp32,
//
// where x[r, t] is taken as 0 for a target outside [0, V), as the TPU
// kernel's sum of where(cols == t, x, 0) gives. logits x are [N, V] fp32 or
// bf16 (widened to fp32), targets int32 or int64, nll [N] fp32. Any N and
// any V: each row is independent, so nothing is padded. The mean stays in
// PyTorch, as JAX takes jnp.mean outside its kernel, and so does the
// backward.
//
// Design: one block per row. Each row is read once from device memory:
// every thread walks its float4 chunks of the row (chunk c, c + kThreads,
// ...) keeping an online (max, sum of exp) pair, and picks x[t] in the
// same pass when t falls in one of its chunks. Warp shuffles and then
// shared memory combine the threads' pairs; thread 0 writes the row's NLL.
// A row whose start is not 16-byte aligned (V % 4 != 0) takes the scalar
// loop, one element per step.
//
// What bounds it on this card: bytes. At the flagship (8192 x 16384 fp32
// logits) it must read 537 MB and does ~4 operations per logit (0.5
// GFLOP): 0.160 ms at 3.35 TB/s.

#include "common.cuh"

#include <math.h>

namespace {

using namespace brpc;

constexpr int kXentThreads = 256;
constexpr int kXentWarps = kXentThreads / 32;

// (m, s) <- the pair of the union of the two element sets; s is the sum of
// exp(x - m). A side that has seen nothing has m = -inf and s = 0.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// fold four more values into this thread's pair
__device__ __forceinline__ void fold4(float& m, float& s, float4 x) {
  const float mc = fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
  const float mx = fmaxf(m, mc);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + expf(x.x - mx) + expf(x.y - mx) + expf(x.z - mx) +
      expf(x.w - mx);
  m = mx;
}

__device__ __forceinline__ float pick4(float4 x, int64_t i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <typename T, typename TT, bool kVec>
__global__ void __launch_bounds__(kXentThreads)
xent_kernel(const T* __restrict__ logits, const TT* __restrict__ targets,
            float* __restrict__ nll, int v) {
  __shared__ float ms[kXentWarps], ss[kXentWarps], ps[kXentWarps];

  const int64_t row = blockIdx.x;
  const T* x = logits + row * v;
  const int64_t t = static_cast<int64_t>(targets[row]);

  float m = -INFINITY, s = 0.f, picked = 0.f;
  if (kVec) {
    for (int c = threadIdx.x; 4 * c < v; c += kXentThreads) {
      const float4 x4 = load4(x + 4 * c);
      fold4(m, s, x4);
      const int64_t i = t - 4 * c;
      if (i >= 0 && i < 4) picked = pick4(x4, i);
    }
  } else {
    for (int c = threadIdx.x; c < v; c += kXentThreads) {
      const float xv = to_f32(x[c]);
      merge(m, s, xv, 1.f);
      if (c == t) picked = xv;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    picked += __shfl_xor_sync(0xffffffffu, picked, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    ms[warp] = m;
    ss[warp] = s;
    ps[warp] = picked;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kXentWarps; ++w) {
      merge(m, s, ms[w], ss[w]);
      picked += ps[w];
    }
    nll[row] = m + logf(s) - picked;
  }
}

template <typename T, typename TT>
void launch(const void* logits, const void* targets, void* nll,
            int64_t rows, int v, cudaStream_t stream) {
  // float4 loads need every row's start 16-byte aligned (fp32) or 8-byte
  // aligned (bf16): V a multiple of 4 and the base aligned (the wrapper
  // checks the base)
  const bool vec = v % 4 == 0;
  const dim3 grid(static_cast<unsigned>(rows));
  const T* x = static_cast<const T*>(logits);
  const TT* t = static_cast<const TT*>(targets);
  float* out = static_cast<float*>(nll);
  if (vec) {
    xent_kernel<T, TT, true><<<grid, kXentThreads, 0, stream>>>(x, t, out, v);
  } else {
    xent_kernel<T, TT, false><<<grid, kXentThreads, 0, stream>>>(x, t, out,
                                                                  v);
  }
}

template <typename T>
int launch_targets(int target_bits, const void* logits, const void* targets,
                   void* nll, int64_t rows, int v, cudaStream_t stream) {
  if (target_bits == 32) {
    launch<T, int32_t>(logits, targets, nll, rows, v, stream);
  } else if (target_bits == 64) {
    launch<T, int64_t>(logits, targets, nll, rows, v, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [rows, v] contiguous (dtype 0 = fp32, 1 = bf16, base 16-byte
// aligned), targets [rows] int32 or int64 (target_bits 32 or 64), nll
// [rows] fp32. rows must be in [1, 2^31). Launches on `stream` and returns
// cudaGetLastError(); an unsupported dtype or target width returns
// cudaErrorInvalidValue without launching.
extern "C" int brpc_xent(const void* logits, const void* targets, void* nll,
                         int64_t rows, int v, int dtype, int target_bits,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_targets<float>(target_bits, logits, targets, nll, rows, v,
                                 st);
  }
  if (dtype == kBFloat16) {
    return launch_targets<__nv_bfloat16>(target_bits, logits, targets, nll,
                                         rows, v, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
