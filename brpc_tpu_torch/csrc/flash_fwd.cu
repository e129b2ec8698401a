// Flash attention forward with the row logsumexp, and its carry form, fp32
// or bf16, for Hopper (sm_90a).
//
// Replaces five TPU kernels of brpc_tpu/tpu/pallas_ops.py that compute
// softmax(q k^T / sqrt(D)) v with an online softmax: `_flash_kernel`
// behind `flash_attention` (serving prefill, o only), the three that also
// give lse, `_flash_fwd_bhsd_kernel` (the (q-tile, k-tile) grid),
// `_flash_fwd_folded_kernel` (the triangular grid of causal
// self-attention) and `_flash_fwd_qgrid_kernel` (K/V resident, a k-chunk
// loop inside the kernel), and the carry form `_flash_carry_kernel`, the
// inner kernel of ring attention. The port wrappers `flash_attention`,
// `_flash_fwd_bhsd`, `_flash_fwd_folded` and `_flash_fwd_qgrid` launch the
// plain form, `flash_attention_carry` the carry form; both forms are one
// loop body.
//
// What it computes: q [N, Sq, D], k and v [N, Sk, D], o [N, Sq, D], each
// addressed through element strides of its N and row axes (the last dim
// contiguous), so the serving model's (S, H, D) views of its fused QKV
// product are read in place and training's contiguous [B*H, S, D] alike.
// o is in the input dtype and lse = m + log l is [N, Sq] fp32 (skipped
// when lse is null), with an optional causal mask at absolute positions:
// query row r sees key c iff q_start + r >= k_start + c (both offsets 0
// outside the ring). A row that saw no key gets o = 0 and lse = NEG_INF,
// as the TPU kernels write it. bf16 inputs are widened to fp32 for every
// product; P is rounded to the input dtype before P V, as the TPU kernel's
// p.astype(v.dtype) does.
//
// The carry form starts each row from the running state (m, l, acc) of
// earlier passes instead of (-inf, 0, 0) and writes the state back, not
// normalised: m and l [N, Sq] and acc [N, Sq, D], fp32, contiguous. The
// state's "seen nothing" is m = NEG_INF (-1e30), finite, so the first live
// tile rescales by exp(NEG_INF - m_new) = 0. A tile in which a row has no
// live key is skipped for that row, so a row that sees no key in the whole
// pass (a key block wholly in its future) writes its state back bit for
// bit, and its rescale is never exp(0).
//
// Design (simple and right, not yet fast): grid = (q-tiles, N). A block
// owns kThreads / (D / 8) query rows of one head, each row held by D / 8
// lanes of a warp (common.cuh). It walks the key tiles of 32 rows in a
// loop, staged through shared memory as fp32, and stops at the block's
// last live key when causal; m, l and the output accumulator stay in
// registers, and every product is an fp32 FMA (no tensor cores). The TPU's
// q-grid kernel keeps K/V resident in VMEM and runs exact causal trip
// counts; this loop already stops at the diagonal, and K/V tiles come from
// L2 across the q-tiles of a head.
//
// What bounds it on this card: at the flagship training shape (N = 64,
// S = 1024, D = 128, causal, bf16) it does about 17.2 GFLOP (4 D per live
// (q, k) pair) and must move about 67 MB: 0.017 ms at 989 TFLOP/s of bf16
// tensor-core math against 0.020 ms at 3.35 TB/s, so its bound is bytes.
// With fp32 FMAs it cannot come near that: 17.2 GFLOP at 67 TFLOP/s of
// fp32 outside the tensor cores is already 0.26 ms, and the layout spends
// a shuffle reduction and a shared-memory load per score on top; wgmma on
// bf16 tiles is a later PR. A full ring hop of the carry form at
// (32, 512, 128) bf16 moves about 29.6 MB (q, k, v and the fp32 state in
// and out): 0.0088 ms at 3.35 TB/s, against 0.0043 ms of bf16 operations.
// At the serving path's shapes (S <= 1024, H = 4, D = 16, fp32) a call
// moves about 1 MB and is bound by the launch and the latency of its
// serial key loop.

#include "common.cuh"

#include <math.h>

namespace {

using namespace brpc;

// element strides of a tensor's N axis and row axis
struct Strides {
  int64_t n, row;
};

// the carry form's running state, in and out: m and l [N, Sq], acc
// [N, Sq, D], fp32, contiguous (all null for the plain form)
struct Carry {
  const float *m_in, *l_in, *acc_in;
  float *m_out, *l_out, *acc_out;
};

template <int D, typename T, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Carry c, int sq, int sk,
                 Strides qs, Strides kst, Strides vst, Strides ost,
                 int causal, int q_start, int k_start, float scale) {
  constexpr int G = Rows<D>::G;
  constexpr int BQ = Rows<D>::kPerBlock;

  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int n = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int q0 = blockIdx.x * BQ;
  const int qrow = q0 + threadIdx.x / G;
  const bool live_row = qrow < sq;
  const int64_t srow = static_cast<int64_t>(n) * sq + qrow;  // lse, state
  const T* kn = k + n * kst.n;
  const T* vn = v + n * vst.n;

  float qr[8], acc[8];
  load_row<D>(q + n * qs.n + qrow * qs.row, lane, live_row, qr);
  float m, l;
  if constexpr (kCarry) {
    load_row<D>(c.acc_in + srow * D, lane, live_row, acc);
    m = live_row ? c.m_in[srow] : kNegInf;
    l = live_row ? c.l_in[srow] : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  // causal: key c is live for some row of the block iff
  // k_start + c <= q_start + q0 + BQ - 1; a bound <= 0 runs no tile
  const int k_end = causal
      ? max(0, min(sk, q_start + q0 + BQ - k_start)) : sk;
  const int q_abs = q_start + qrow;
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
      const bool live = kc < sk && (!causal || q_abs >= k_start + kc);
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

  if (!live_row) return;
  if constexpr (kCarry) {
    store_row<D>(c.acc_out + srow * D, lane, acc, 1.f);
    if (lane == 0) {
      c.m_out[srow] = m;
      c.l_out[srow] = l;
    }
  } else {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    store_row<D>(o + n * ost.n + qrow * ost.row, lane, acc, inv);
    if (lse != nullptr && lane == 0) {
      lse[srow] = l == 0.f ? kNegInf : m + logf(l);
    }
  }
}

// what one launch needs besides the head dim and the dtype
struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  Carry c;
  int n, sq, sk, causal, q_start, k_start;
  Strides qs, ks, vs, os;
  cudaStream_t stream;
};

template <int D, typename T, bool kCarry>
void launch(const Args& a) {
  constexpr int BQ = Rows<D>::kPerBlock;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.n);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<D, T, kCarry><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.c, a.sq, a.sk, a.qs, a.ks, a.vs, a.os,
      a.causal, a.q_start, a.k_start, scale);
}

template <typename T, bool kCarry>
int launch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 16: launch<16, T, kCarry>(a); break;
    case 32: launch<32, T, kCarry>(a); break;
    case 64: launch<64, T, kCarry>(a); break;
    case 128: launch<128, T, kCarry>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCarry>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == kFloat32) return launch_dim<float, kCarry>(head_dim, a);
  if (dtype == kBFloat16) {
    return launch_dim<__nv_bfloat16, kCarry>(head_dim, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [n, sq, d], k and v [n, sk, d], o [n, sq, d] (dtype 0 = fp32,
// 1 = bf16), each with the element strides of its n and row axes (rows
// and the base 16-byte aligned, the last dim contiguous); lse [n, sq]
// fp32, contiguous, or null when the caller wants o only. The causal mask
// is aligned at position 0. Launches on `stream` and returns
// cudaGetLastError() (0 on success); an unsupported dtype or head dim
// returns cudaErrorInvalidValue without launching.
extern "C" int brpc_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int n, int sq, int sk,
                              int head_dim, int dtype, int causal,
                              int64_t q_ns, int64_t q_rs, int64_t k_ns,
                              int64_t k_rs, int64_t v_ns, int64_t v_rs,
                              int64_t o_ns, int64_t o_rs, void* stream) {
  const Args a{q, k, v, o, lse, Carry{},
               n, sq, sk, causal, 0, 0,
               {q_ns, q_rs}, {k_ns, k_rs}, {v_ns, v_rs}, {o_ns, o_rs},
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}

// The carry form: q, k and v as for brpc_flash_fwd; m_in, l_in [n, sq],
// acc_in [n, sq, d] the running state and m_out, l_out, acc_out the state
// after this pass, all fp32 and contiguous (out must not alias in). The
// causal mask is at absolute positions: row r sees key c iff
// q_start + r >= k_start + c. Returns as brpc_flash_fwd.
extern "C" int brpc_flash_carry(const void* q, const void* k, const void* v,
                                const void* m_in, const void* l_in,
                                const void* acc_in, void* m_out, void* l_out,
                                void* acc_out, int n, int sq, int sk,
                                int head_dim, int dtype, int causal,
                                int q_start, int k_start, int64_t q_ns,
                                int64_t q_rs, int64_t k_ns, int64_t k_rs,
                                int64_t v_ns, int64_t v_rs, void* stream) {
  const Carry c{static_cast<const float*>(m_in),
                static_cast<const float*>(l_in),
                static_cast<const float*>(acc_in),
                static_cast<float*>(m_out), static_cast<float*>(l_out),
                static_cast<float*>(acc_out)};
  const Args a{q, k, v, nullptr, nullptr, c,
               n, sq, sk, causal, q_start, k_start,
               {q_ns, q_rs}, {k_ns, k_rs}, {v_ns, v_rs}, {0, 0},
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}
