// Flash attention backward, the dQ kernel and the dK/dV kernel, fp32 or
// bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel`
// behind `_flash_bwd_bhsd` in brpc_tpu/tpu/pallas_ops.py. Both recompute
// P = exp(s - lse) from q, k and the forward's lse instead of storing it:
//
//   s  = q k^T / sqrt(D), masked when causal at absolute positions
//        (q_start + row >= k_start + col), so a ring hop can pass its
//        block's offsets;
//   P  = exp(s - lse), and P = 0 on a row whose lse <= NEG_INF / 2 (a row
//        that attended to nothing: never exp(s - NEG_INF));
//   dP = dO v^T,  dS = P * (dP - delta),  delta = rowsum(dO * O);
//   dQ = dS k / sqrt(D),  dK = dS^T q / sqrt(D),  dV = P^T dO.
//
// bf16 inputs are widened to fp32 for every product; P and dS are rounded
// to the input dtype before the products that take them, as the TPU
// kernels' p.astype(do.dtype) and ds.astype(q.dtype) do. Outputs are in
// the input dtype.
//
// Design (simple and right, not yet fast), with the row layout of
// common.cuh (a row of D values held by D / 8 lanes of a warp):
// - dQ: grid = (q-tiles, N). A block owns kThreads / (D / 8) query rows,
//   keeps q, dO and the dQ sum in registers and walks the key tiles (k and
//   v staged in shared memory), stopping past the diagonal when causal.
// - dK/dV: grid = (k-tiles, N). A block owns kThreads / (D / 8) key rows,
//   keeps k, v and the dK and dV sums in registers and walks the query
//   tiles (q, dO, lse and delta staged in shared memory) from the diagonal
//   on when causal. Each block owns its output rows, so there are no
//   atomics and the result does not change from run to run.
//
// What bounds them on this card: at the flagship training shape (N = 64,
// S = 1024, D = 128, causal, bf16) dQ does 6 D and dK/dV 8 D FLOP per live
// (q, k) pair, about 25.8 and 34.4 GFLOP, against about 84 MB moved each:
// 0.39 and 0.51 ms at 67 TFLOP/s of fp32 FMA, so both are bound by
// operations. Like the forward they spend shuffles and shared-memory
// loads per score and run well below that bound.

#include "common.cuh"

#include <math.h>

namespace {

using namespace brpc;

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int sq,
                int sk, int q_start, int k_start, int causal, float scale) {
  constexpr int G = Rows<D>::G;
  constexpr int BQ = Rows<D>::kPerBlock;

  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int n = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int q0 = blockIdx.x * BQ;
  const int qrow = q0 + threadIdx.x / G;
  const bool live_row = qrow < sq;
  const T* kn = k + static_cast<int64_t>(n) * sk * D;
  const T* vn = v + static_cast<int64_t>(n) * sk * D;
  const int64_t row = static_cast<int64_t>(n) * sq + qrow;

  float qr[8], dor[8], acc[8];
  load_row<D>(q + row * D, lane, live_row, qr);
  load_row<D>(dout + row * D, lane, live_row, dor);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const float row_lse = live_row ? lse[row] : kNegInf;
  const float row_delta = live_row ? delta[row] : 0.f;
  const bool attended = row_lse > kNegInf / 2;
  const int q_abs = q_start + qrow;

  // causal: key c is live for some row of the block iff
  // k_start + c <= q_start + q0 + BQ - 1
  const int k_end = causal
      ? max(0, min(sk, q_start + q0 + BQ - k_start)) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    stage_tile<D>(kn, k0, sk, ks);
    stage_tile<D>(vn, k0, sk, vs);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kr[8], vr[8];
      shared_row<D>(ks[j], lane, kr);
      shared_row<D>(vs[j], lane, vr);
      const float s = group_sum<G>(dot8(qr, kr)) * scale;
      const float dp = group_sum<G>(dot8(dor, vr));
      const int kc = k0 + j;
      const bool live = attended && kc < sk &&
                        (!causal || q_abs >= k_start + kc);
      const float p = live ? expf(s - row_lse) : 0.f;
      const float ds = round_to<T>(p * (dp - row_delta));
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  if (live_row) store_row<D>(dq + row * D, lane, acc, scale);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int q_start,
                 int k_start, int causal, float scale) {
  constexpr int G = Rows<D>::G;
  constexpr int BK = Rows<D>::kPerBlock;

  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lses[kTile];
  __shared__ float deltas[kTile];

  const int n = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int k0 = blockIdx.x * BK;
  const int krow = k0 + threadIdx.x / G;
  const bool live_row = krow < sk;
  const T* qn = q + static_cast<int64_t>(n) * sq * D;
  const T* don = dout + static_cast<int64_t>(n) * sq * D;
  const float* lsen = lse + static_cast<int64_t>(n) * sq;
  const float* deltan = delta + static_cast<int64_t>(n) * sq;
  const int64_t row = static_cast<int64_t>(n) * sk + krow;

  float kr[8], vr[8], dka[8], dva[8];
  load_row<D>(k + row * D, lane, live_row, kr);
  load_row<D>(v + row * D, lane, live_row, vr);
#pragma unroll
  for (int i = 0; i < 8; ++i) dka[i] = dva[i] = 0.f;
  const int k_abs = k_start + krow;

  // causal: query r is live for some key of the block iff
  // q_start + r >= k_start + k0
  const int q_begin = causal ? max(0, k_start + k0 - q_start) : 0;
  for (int qt = q_begin; qt < sq; qt += kTile) {
    __syncthreads();
    stage_tile<D>(qn, qt, sq, qs);
    stage_tile<D>(don, qt, sq, dos);
    if (threadIdx.x < kTile) {
      const int r = qt + threadIdx.x;
      lses[threadIdx.x] = r < sq ? lsen[r] : kNegInf;
      deltas[threadIdx.x] = r < sq ? deltan[r] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float qr[8], dor[8];
      shared_row<D>(qs[j], lane, qr);
      shared_row<D>(dos[j], lane, dor);
      const float s = group_sum<G>(dot8(kr, qr)) * scale;
      const float dp = group_sum<G>(dot8(vr, dor));
      const int r = qt + j;
      const float row_lse = lses[j];
      const bool live = r < sq && row_lse > kNegInf / 2 &&
                        (!causal || q_start + r >= k_abs);
      const float p = live ? expf(s - row_lse) : 0.f;
      const float pv = round_to<T>(p);
      const float ds = round_to<T>(p * (dp - deltas[j]));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dva[i] = fmaf(pv, dor[i], dva[i]);
        dka[i] = fmaf(ds, qr[i], dka[i]);
      }
    }
  }
  if (live_row) {
    store_row<D>(dk + row * D, lane, dka, scale);
    store_row<D>(dv + row * D, lane, dva, 1.f);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int n, sq, sk, q_start, k_start, causal;
};

template <int D, typename T>
void launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int BQ = Rows<D>::kPerBlock;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.n);
  flash_dq_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.sq, a.sk, a.q_start, a.k_start, a.causal,
      1.0f / sqrtf(static_cast<float>(D)));
}

template <int D, typename T>
void launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int BK = Rows<D>::kPerBlock;
  const dim3 grid((a.sk + BK - 1) / BK, a.n);
  flash_dkv_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.q_start,
      a.k_start, a.causal, 1.0f / sqrtf(static_cast<float>(D)));
}

// which: 0 = dQ, 1 = dK/dV
template <typename T>
int launch_dim(int which, int head_dim, const Args& a, cudaStream_t st) {
  switch (head_dim) {
    case 32: which ? launch_dkv<32, T>(a, st) : launch_dq<32, T>(a, st); break;
    case 64: which ? launch_dkv<64, T>(a, st) : launch_dq<64, T>(a, st); break;
    case 128:
      which ? launch_dkv<128, T>(a, st) : launch_dq<128, T>(a, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int which, int head_dim, int dtype, const Args& a,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_dim<float>(which, head_dim, a, st);
  if (dtype == kBFloat16) {
    return launch_dim<__nv_bfloat16>(which, head_dim, a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dout [n, sq, d], k, v [n, sk, d] (dtype 0 = fp32, 1 = bf16, all
// contiguous), lse and delta [n, sq] fp32, dq [n, sq, d] in the input
// dtype. Launches on `stream` and returns cudaGetLastError().
extern "C" int brpc_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int n, int sq,
                                 int sk, int head_dim, int dtype,
                                 int q_start, int k_start, int causal,
                                 void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               n, sq, sk, q_start, k_start, causal};
  return dispatch(0, head_dim, dtype, a, stream);
}

// As brpc_flash_bwd_dq, writing dk and dv [n, sk, d] in the input dtype.
extern "C" int brpc_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int n, int sq, int sk,
                                  int head_dim, int dtype, int q_start,
                                  int k_start, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               n, sq, sk, q_start, k_start, causal};
  return dispatch(1, head_dim, dtype, a, stream);
}
