// Flash attention forward with the row logsumexp, fp32 or bf16, for
// Hopper (sm_90a).
//
// Replaces three TPU kernels of brpc_tpu/tpu/pallas_ops.py that compute
// softmax(q k^T / sqrt(D)) v with an online softmax: `_flash_kernel`
// behind `flash_attention` (serving prefill, o only), and the two that
// also give lse, `_flash_fwd_bhsd_kernel` (the (q-tile, k-tile) grid) and
// `_flash_fwd_folded_kernel` (the triangular grid of causal
// self-attention). The port wrappers `flash_attention`, `_flash_fwd_bhsd`
// and `_flash_fwd_folded` all launch this one kernel.
//
// What it computes: q [N, Sq, D], k and v [N, Sk, D], o [N, Sq, D], each
// addressed through element strides of its N and row axes (the last dim
// contiguous), so the serving model's (S, H, D) views of its fused QKV
// product are read in place and training's contiguous [B*H, S, D] alike.
// o is in the input dtype and lse = m + log l is [N, Sq] fp32 (skipped
// when lse is null), with an optional causal mask aligned at position 0
// (query row r sees keys c <= r). A row that saw no key gets o = 0 and
// lse = NEG_INF, as the TPU kernels write it. bf16 inputs are widened to
// fp32 for every product; P is rounded to the input dtype before P V, as
// the TPU kernel's p.astype(v.dtype) does.
//
// Design (simple and right, not yet fast): grid = (q-tiles, N). A block
// owns kThreads / (D / 8) query rows of one head, each row held by D / 8
// lanes of a warp (common.cuh). It walks the key tiles of 32 rows in a
// loop, staged through shared memory as fp32, and stops at the diagonal
// when causal; m, l and the output accumulator stay in registers, and
// every product is an fp32 FMA (no tensor cores).
//
// What bounds it on this card: at the flagship training shape (N = 64,
// S = 1024, D = 128, causal, bf16) it does about 17.2 GFLOP (4 D per live
// (q, k) pair) and must move about 67 MB: 0.017 ms at 989 TFLOP/s of bf16
// tensor-core math against 0.020 ms at 3.35 TB/s, so its bound is bytes.
// With fp32 FMAs it cannot come near that: 17.2 GFLOP at 67 TFLOP/s of
// fp32 outside the tensor cores is already 0.26 ms, and the layout spends
// a shuffle reduction and a shared-memory load per score on top; wgmma on
// bf16 tiles is a later PR. At the serving path's shapes (S <= 1024,
// H = 4, D = 16, fp32) a call moves about 1 MB and is bound by the launch
// and the latency of its serial key loop.

#include "common.cuh"

#include <math.h>

namespace {

using namespace brpc;

// element strides of a tensor's N axis and row axis
struct Strides {
  int64_t n, row;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, Strides qs,
                 Strides kst, Strides vst, Strides ost, int causal,
                 float scale) {
  constexpr int G = Rows<D>::G;
  constexpr int BQ = Rows<D>::kPerBlock;

  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int n = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int q0 = blockIdx.x * BQ;
  const int qrow = q0 + threadIdx.x / G;
  const bool live_row = qrow < sq;
  const T* kn = k + n * kst.n;
  const T* vn = v + n * vst.n;

  float qr[8], acc[8];
  load_row<D>(q + n * qs.n + qrow * qs.row, lane, live_row, qr);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // causal: keys past the block's last query row are above the diagonal
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<D>(kn, k0, sk, ks, kst.row);
    stage_tile<D>(vn, k0, sk, vs, vst.row);
    __syncthreads();

    float s[kTile];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float kr[8];
      shared_row<D>(ks[j], lane, kr);
      const float dot = group_sum<G>(dot8(qr, kr));
      const int kc = k0 + j;
      const bool live = kc < sk && (!causal || kc <= qrow);
      s[j] = live ? dot * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    if (m_tile == -INFINITY) continue;  // no live key for this row here

    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);  // 0 on the first live tile
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(s[j] - m_new);  // masked keys give exactly 0
      psum += p;
      const float pv = round_to<T>(p);
      float vr[8];
      shared_row<D>(vs[j], lane, vr);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(pv, vr[i], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (live_row) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    store_row<D>(o + n * ost.n + qrow * ost.row, lane, acc, inv);
    if (lse != nullptr && lane == 0) {
      lse[static_cast<int64_t>(n) * sq + qrow] =
          l == 0.f ? kNegInf : m + logf(l);
    }
  }
}

// what one launch needs besides the head dim and the dtype
struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int n, sq, sk, causal;
  Strides qs, ks, vs, os;
  cudaStream_t stream;
};

template <int D, typename T>
void launch(const Args& a) {
  constexpr int BQ = Rows<D>::kPerBlock;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.n);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<D, T><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.qs, a.ks, a.vs, a.os,
      a.causal, scale);
}

template <typename T>
int launch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: launch<16, T>(a); break;
    case 32: launch<32, T>(a); break;
    case 64: launch<64, T>(a); break;
    case 128: launch<128, T>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [n, sq, d], k and v [n, sk, d], o [n, sq, d] (dtype 0 = fp32,
// 1 = bf16), each with the element strides of its n and row axes (rows
// and the base 16-byte aligned, the last dim contiguous); lse [n, sq]
// fp32, contiguous, or null when the caller wants o only. Launches on
// `stream` and returns cudaGetLastError() (0 on success); an unsupported
// dtype or head dim returns cudaErrorInvalidValue without launching.
extern "C" int brpc_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int n, int sq, int sk,
                              int head_dim, int dtype, int causal,
                              int64_t q_ns, int64_t q_rs, int64_t k_ns,
                              int64_t k_rs, int64_t v_ns, int64_t v_rs,
                              int64_t o_ns, int64_t o_rs, void* stream) {
  const Args a{q, k, v, o, lse, n, sq, sk, causal,
               {q_ns, q_rs}, {k_ns, k_rs}, {v_ns, v_rs}, {o_ns, o_rs},
               static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return launch_dim<float>(head_dim, a);
  if (dtype == kBFloat16) return launch_dim<__nv_bfloat16>(head_dim, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
