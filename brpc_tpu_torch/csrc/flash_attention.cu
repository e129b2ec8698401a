// Causal / full flash attention forward, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` behind `flash_attention` in
// brpc_tpu/tpu/pallas_ops.py: softmax(q k^T / sqrt(D)) v with an online
// softmax (running max m, denominator l and accumulator acc in fp32), an
// optional causal mask with the key tiles above the diagonal skipped, and
// rows that saw no live key (l == 0) written as zeros, not NaN.
//
// Layout: q, k, v and o are (S, H, D) addressed through element strides
// (row stride, head stride; the last dim must be contiguous), so the
// serving model's q/k/v views of its fused QKV product are read in place.
// One launch covers all heads: grid = (ceil(Sq / rows per block), H).
//
// Design (simple and right, not yet fast): each block owns a tile of
// query rows of one head. A query row is held by G = D / 8 neighbouring
// threads of one warp, each owning 8 of its D dims of q and acc in
// registers; a score is the sum of their partial dot products, reduced
// with warp shuffles. Key and value tiles of 32 rows are staged in shared
// memory and every thread runs plain fp32 FMAs; no tensor cores.
//
// What bounds it on the card: at the serving path's shapes (S <= 1024,
// H = 4, D = 16) one call moves about 1 MB and does about 0.13 GFLOP, a
// fraction of a microsecond at 3.35 TB/s or 67 TFLOP/s fp32. It is bound
// by the launch and by the latency of its serial key loop, not by bytes
// or operations. Tensor cores (wgmma), TMA and bf16 are for a later
// change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // threads per block
constexpr int kDimsPerThread = 8;   // dims of one row held by one thread
constexpr int kBlockK = 32;         // key rows per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int sq, int sk,
              int64_t q_rs, int64_t q_hs, int64_t k_rs, int64_t k_hs,
              int64_t v_rs, int64_t v_hs, int64_t o_rs, int64_t o_hs,
              int causal, float scale) {
  constexpr int G = D / kDimsPerThread;   // threads per query row
  constexpr int BQ = kThreads / G;        // query rows per block
  static_assert(G >= 1 && G <= 32 && (32 % G) == 0, "row must fit a warp");

  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int h = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int q0 = blockIdx.x * BQ;
  const int qrow = q0 + threadIdx.x / G;
  const bool live_row = qrow < sq;
  const int d0 = lane * kDimsPerThread;

  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
  const float* qp = q + h * q_hs + static_cast<int64_t>(qrow) * q_rs + d0;
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    qr[i] = live_row ? qp[i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // causal: keys past the block's last query row are above the diagonal
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int kr = k0 + j;
      const bool in = kr < sk;
      ks[j][d] = in ? k[h * k_hs + static_cast<int64_t>(kr) * k_rs + d] : 0.f;
      vs[j][d] = in ? v[h * v_hs + static_cast<int64_t>(kr) * v_rs + d] : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        part = fmaf(qr[i], ks[j][d0 + i], part);
      }
      // every lane of the warp takes part: rows past sq compute on zeros
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      const int kr = k0 + j;
      const bool live = kr < sk && (!causal || kr <= qrow);
      s[j] = live ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    if (m_tile == -INFINITY) continue;  // no live key for this row here

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);  // 0 on the first live tile
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys give exactly 0
      psum += p;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        acc[i] = fmaf(p, vs[j][d0 + i], acc[i]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live_row) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* op = o + h * o_hs + static_cast<int64_t>(qrow) * o_rs + d0;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) op[i] = acc[i] * inv;
  }
}

template <int D>
void launch(const float* q, const float* k, const float* v, float* o,
            int sq, int sk, int heads, int64_t q_rs, int64_t q_hs,
            int64_t k_rs, int64_t k_hs, int64_t v_rs, int64_t v_hs,
            int64_t o_rs, int64_t o_hs, int causal, cudaStream_t stream) {
  constexpr int BQ = kThreads / (D / kDimsPerThread);
  const dim3 grid((sq + BQ - 1) / BQ, heads);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, o, sq, sk, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, o_rs, o_hs,
      causal, scale);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// an unsupported head dim returns cudaErrorInvalidValue without launching.
extern "C" int brpc_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int sq, int sk,
    int heads, int head_dim, int64_t q_rs, int64_t q_hs, int64_t k_rs,
    int64_t k_hs, int64_t v_rs, int64_t v_hs, int64_t o_rs, int64_t o_hs,
    int causal, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      launch<16>(qf, kf, vf, of, sq, sk, heads, q_rs, q_hs, k_rs, k_hs,
                 v_rs, v_hs, o_rs, o_hs, causal, st);
      break;
    case 32:
      launch<32>(qf, kf, vf, of, sq, sk, heads, q_rs, q_hs, k_rs, k_hs,
                 v_rs, v_hs, o_rs, o_hs, causal, st);
      break;
    case 64:
      launch<64>(qf, kf, vf, of, sq, sk, heads, q_rs, q_hs, k_rs, k_hs,
                 v_rs, v_hs, o_rs, o_hs, causal, st);
      break;
    case 128:
      launch<128>(qf, kf, vf, of, sq, sk, heads, q_rs, q_hs, k_rs, k_hs,
                  v_rs, v_hs, o_rs, o_hs, causal, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* brpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
