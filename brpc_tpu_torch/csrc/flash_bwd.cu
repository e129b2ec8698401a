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
// Products accumulate in fp32; P and dS are rounded to the input dtype
// before the products that take them, as the TPU kernels' p.astype(do.dtype)
// and ds.astype(q.dtype) do. Outputs are in the input dtype.
//
// - dQ, fp32: `flash_dq_kernel`, FMA on the CUDA cores, with the row
//   layout of common.cuh (a row of D values held by D / 8 lanes of a
//   warp). grid = (q-tiles, N). A block owns kThreads / (D / 8) query rows,
//   keeps q, dO and the dQ sum in registers and walks the key tiles (k and
//   v staged in shared memory), stopping past the diagonal when causal.
// - dQ, bf16 at head dim 32, 64 and 128: `dq_wgmma_kernel`, on the tensor
//   cores (hopper.cuh). grid = (N, q-blocks), the q-blocks in reverse so
//   that the heaviest causal blocks start first. A block owns kDqRows = 128
//   query rows, 64 per warpgroup; TMA brings its q, dO, lse and delta once
//   and then the key tiles of kDqKeys = 64 rows of k and v, from key 0 to
//   the causal end, into two stages on mbarriers. Per key tile each
//   warpgroup takes S = q k^T and dP = dO v^T as wgmma chains from shared
//   memory (both operands K-major), forms P and dS on the fp32 fragments
//   (lse and delta broadcast along the rows), and adds dS k into dQ with dS
//   rounded to bf16 in registers as the A operand and k read MN-major. dQ
//   stays in registers for the whole block and is written once.
// - dK/dV, fp32: `flash_dkv_kernel`, the same FMA layout. grid = (k-tiles,
//   N). A block owns kThreads / (D / 8) key rows, keeps k, v and the dK
//   and dV sums in registers and walks the query tiles (q, dO, lse and
//   delta staged in shared memory) from the diagonal on when causal.
// - dK/dV, bf16 at head dim 32, 64 and 128: `dkv_wgmma_kernel`, on the
//   tensor cores. grid = (N, k-tiles). A block owns kBK = 128
//   key rows, 64 per warpgroup; TMA brings its k and v once and then, per
//   q-tile of kBQ = 64 rows from the first live one, q, dO, lse and delta
//   into two stages on mbarriers. Per q-tile each warpgroup takes S^T =
//   k q^T and dP^T = v dO^T as wgmma chains from shared memory, forms P^T
//   and dS^T on the fp32 fragments (lse and delta broadcast along the
//   columns), and adds P^T dO into dV and dS^T q into dK with P^T and dS^T
//   rounded to bf16 in registers as the A operands (dO and q MN-major).
//   dK and dV stay in registers for the whole block and are written once.
// Each block owns its output rows, so there are no atomics and the result
// does not change from run to run. bf16 at those head dims reaches only the
// tensor-core kernels; the FMA kernels are instantiated for fp32 alone.
//
// What bounds them on this card: at the flagship training shape (N = 64,
// S = 1024, D = 128, causal, bf16) dQ does 6 D and dK/dV 8 D FLOP per live
// (q, k) pair, about 25.8 and 34.4 GFLOP, against about 84 MB moved each:
// 0.026 and 0.035 ms at 989 TFLOP/s of bf16 tensor-core math, so both are
// bound by operations.

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------
// bf16 dK/dV: the tensor-core kernel
// ---------------------------------------------------------------------
using hopper::kLog2e;
using hopper::kWgThreads;
constexpr int kBK = 128;  // key rows per block, 64 per warpgroup
constexpr int kBQ = 64;   // query rows per tile

template <int D>
struct DkvSmem {  // each tile a multiple of 1024 bytes: every tile aligned
  __nv_bfloat16 k[kBK * D];
  __nv_bfloat16 v[kBK * D];
  __nv_bfloat16 q[2][kBQ * D];
  __nv_bfloat16 dout[2][kBQ * D];
  float lse[2][kBQ];
  float delta[2][kBQ];
  uint64_t kv_full, full[2];
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tlse,
                 const __grid_constant__ CUtensorMap tdelta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int sq, int sk,
                 int q_start, int k_start, int causal, float scale,
                 float scale_log2) {
  using namespace hopper;
  using T = Tile<D>;
  constexpr int kAcc = D / 2;       // dK and dV registers per thread
  constexpr int kScores = kBQ / 2;  // S^T and dP^T registers per thread
  constexpr uint32_t kStageBytes = 2 * kBQ * D * 2 + 2 * kBQ * 4;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int n = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const Frag f(tid % 128);
  const int key_lo = k0 + 64 * wg + f.row0;  // this thread's keys: +0, +8
  // causal: query r is live for some key of the block iff
  // q_start + r >= k_start + k0
  const int q_begin = causal ? max(0, k_start + k0 - q_start) : 0;
  const int t0 = q_begin / kBQ;
  const int tiles = max(0, (sq + kBQ - 1) / kBQ - t0);

  auto load_q = [&](int i) {  // q-tile t0 + i into stage i % 2
    const int s = i & 1;
    const int qt = (t0 + i) * kBQ;
    mbar_expect_tx(&sm.full[s], kStageBytes);
#pragma unroll
    for (int b = 0; b < T::kBlocks; ++b) {
      tma_load_3d(sm.q[s] + b * kBQ * T::kAtom, &tq, &sm.full[s],
                  b * T::kAtom, qt, n);
      tma_load_3d(sm.dout[s] + b * kBQ * T::kAtom, &tdo, &sm.full[s],
                  b * T::kAtom, qt, n);
    }
    tma_load_1d(sm.lse[s], &tlse, &sm.full[s], n * sq + qt);
    tma_load_1d(sm.delta[s], &tdelta, &sm.full[s], n * sq + qt);
  };
  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && tiles > 0) {
    mbar_expect_tx(&sm.kv_full, 2 * kBK * D * 2);
#pragma unroll
    for (int b = 0; b < T::kBlocks; ++b) {
      tma_load_3d(sm.k + b * kBK * T::kAtom, &tk, &sm.kv_full, b * T::kAtom,
                  k0, n);
      tma_load_3d(sm.v + b * kBK * T::kAtom, &tv, &sm.kv_full, b * T::kAtom,
                  k0, n);
    }
    load_q(0);
    if (tiles > 1) load_q(1);
  }

  float dka[kAcc], dva[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dka[i] = dva[i] = 0.f;
  if (tiles > 0) mbar_wait(&sm.kv_full, 0);
  const int first_key = k_start + k0 + 64 * wg;  // this warpgroup's, absolute
  for (int i = 0; i < tiles; ++i) {
    const int s = i & 1;
    const int qt = (t0 + i) * kBQ;
    mbar_wait(&sm.full[s], (i >> 1) & 1);

    // S^T = k q^T and dP^T = v dO^T: rows are keys, columns queries
    float st[kScores], dpt[kScores];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBQ>::ss(st, desc_k_major<D>(sm.k, kBK, 64 * wg, kk),
                     desc_k_major<D>(sm.q[s], kBQ, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBQ>::ss(dpt, desc_k_major<D>(sm.v, kBK, 64 * wg, kk),
                     desc_k_major<D>(sm.dout[s], kBQ, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T - lse[col]), 0 for a query that attended to nothing and,
    // on tiles that reach past the end or the diagonal, for masked pairs;
    // dS^T = P^T (dP^T - delta[col])
    const bool edge = qt + kBQ > sq ||
                      (causal && q_start + qt < first_key + 63);
#pragma unroll
    for (int r = 0; r < kScores; ++r) {
      const int cq = f.col(r);
      const float row_lse = sm.lse[s][cq];
      bool live = row_lse > kNegInf / 2;
      if (edge) {
        live = live && qt + cq < sq &&
               (!causal || q_start + qt + cq >= first_key + f.row(r));
      }
      const float p =
          live ? exp2f(fmaf(st[r], scale_log2, -row_lse * kLog2e)) : 0.f;
      st[r] = p;
      dpt[r] = p * (dpt[r] - sm.delta[s][cq]);
    }

    // dV += P^T dO and dK += dS^T q, P^T and dS^T rounded to bf16 in
    // registers (the JAX kernel's p.astype and ds.astype)
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      a_fragment(st, kk, pa[kk]);
      a_fragment(dpt, kk, da[kk]);
    }
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Wgmma<D>::rs(dva, pa[kk], desc_mn_major<D>(sm.dout[s], kBQ, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Wgmma<D>::rs(dka, da[kk], desc_mn_major<D>(sm.q[s], kBQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && i + 2 < tiles) load_q(i + 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key_lo + 8 * h;
    if (row >= sk) continue;
    const int64_t off = (static_cast<int64_t>(n) * sk + row) * D + f.col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(
          dka[4 * j + 2 * h] * scale, dka[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 dQ: the tensor-core kernel
// ---------------------------------------------------------------------
constexpr int kDqRows = 128;  // query rows per block, 64 per warpgroup
constexpr int kDqKeys = 64;   // keys per tile

template <int D>
struct DqSmem {  // each tile a multiple of 1024 bytes: every tile aligned
  __nv_bfloat16 q[kDqRows * D];
  __nv_bfloat16 dout[kDqRows * D];
  __nv_bfloat16 k[2][kDqKeys * D];
  __nv_bfloat16 v[2][kDqKeys * D];
  float lse[kDqRows];
  float delta[kDqRows];
  uint64_t rows_full, full[2];
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tlse,
                const __grid_constant__ CUtensorMap tdelta,
                __nv_bfloat16* __restrict__ dq, int sq, int sk, int q_start,
                int k_start, int causal, float scale, float scale_log2) {
  using namespace hopper;
  using T = Tile<D>;
  constexpr int kAcc = D / 2;           // dQ registers per thread
  constexpr int kScores = kDqKeys / 2;  // S and dP registers per thread
  constexpr uint32_t kRowBytes = 2 * kDqRows * D * 2 + 2 * kDqRows * 4;
  constexpr uint32_t kStageBytes = 2 * kDqKeys * D * 2;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int n = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const Frag f(tid % 128);
  const int row_lo = q0 + 64 * wg + f.row0;  // this thread's rows: +0, +8
  // causal: key c is live for some row of the block iff
  // k_start + c <= q_start + q0 + kDqRows - 1; a bound <= 0 runs no tile
  const int k_end = causal
      ? max(0, min(sk, q_start + q0 + kDqRows - k_start)) : sk;
  const int tiles = (k_end + kDqKeys - 1) / kDqKeys;

  auto load_kv = [&](int t) {  // key tile t into stage t % 2
    const int s = t & 1;
    mbar_expect_tx(&sm.full[s], kStageBytes);
#pragma unroll
    for (int b = 0; b < T::kBlocks; ++b) {
      tma_load_3d(sm.k[s] + b * kDqKeys * T::kAtom, &tk, &sm.full[s],
                  b * T::kAtom, t * kDqKeys, n);
      tma_load_3d(sm.v[s] + b * kDqKeys * T::kAtom, &tv, &sm.full[s],
                  b * T::kAtom, t * kDqKeys, n);
    }
  };
  if (tid == 0) {
    mbar_init(&sm.rows_full, 1);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && tiles > 0) {
    mbar_expect_tx(&sm.rows_full, kRowBytes);
#pragma unroll
    for (int b = 0; b < T::kBlocks; ++b) {
      tma_load_3d(sm.q + b * kDqRows * T::kAtom, &tq, &sm.rows_full,
                  b * T::kAtom, q0, n);
      tma_load_3d(sm.dout + b * kDqRows * T::kAtom, &tdo, &sm.rows_full,
                  b * T::kAtom, q0, n);
    }
    tma_load_1d(sm.lse, &tlse, &sm.rows_full, n * sq + q0);
    tma_load_1d(sm.delta, &tdelta, &sm.rows_full, n * sq + q0);
    load_kv(0);
    if (tiles > 1) load_kv(1);
  }

  float dqa[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dqa[i] = 0.f;
  // lse (in base 2) and delta of rows row_lo and row_lo + 8. A row that
  // attended to nothing, or lies past sq (its lse read from the next head
  // or zero-filled), takes lse = +inf: its P is exp2(-inf) = 0 exactly.
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  if (tiles > 0) {
    mbar_wait(&sm.rows_full, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + f.row0 + 8 * h;
      const float l = sm.lse[r];
      lse2[h] = q0 + r < sq && l > kNegInf / 2 ? l * kLog2e : INFINITY;
      dlt[h] = sm.delta[r];
    }
  }
  const int first_row = q_start + q0 + 64 * wg;  // this warpgroup's, absolute
  for (int t = 0; t < tiles; ++t) {
    const int s = t & 1;
    const int k0 = t * kDqKeys;
    mbar_wait(&sm.full[s], (t >> 1) & 1);

    // S = q k^T and dP = dO v^T: rows are queries, columns keys
    float sc[kScores], dp[kScores];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kDqKeys>::ss(sc, desc_k_major<D>(sm.q, kDqRows, 64 * wg, kk),
                         desc_k_major<D>(sm.k[s], kDqKeys, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kDqKeys>::ss(dp, desc_k_major<D>(sm.dout, kDqRows, 64 * wg, kk),
                         desc_k_major<D>(sm.v[s], kDqKeys, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(S - lse[row]), and on tiles that reach past the end of the
    // keys or past this warpgroup's first row, 0 for masked pairs (keys
    // past sk arrive as zeros, whose P would be exp(-lse), not 0);
    // dS = P (dP - delta[row]), kept in dp
    const bool edge = k0 + kDqKeys > sk ||
                      (causal && k_start + k0 + kDqKeys - 1 > first_row);
#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
      if (edge) {
        const int kc = k0 + f.col(i);
        if (kc >= sk || (causal && first_row + f.row(i) < k_start + kc)) {
          p = 0.f;
        }
      }
      dp[i] = p * (dp[i] - dlt[h]);
    }

    // dQ += dS k, dS rounded to bf16 in registers (the JAX kernel's
    // ds.astype(k.dtype)), k read MN-major
    uint32_t da[kDqKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) a_fragment(dp, kk, da[kk]);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      Wgmma<D>::rs(dqa, da[kk], desc_mn_major<D>(sm.k[s], kDqKeys, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && t + 2 < tiles) load_kv(t + 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    if (row >= sq) continue;
    const int64_t off = (static_cast<int64_t>(n) * sq + row) * D + f.col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dq + off + 8 * j) = pack_bf16(
          dqa[4 * j + 2 * h] * scale, dqa[4 * j + 2 * h + 1] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int n, sq, sk, q_start, k_start, causal;
};

template <int D>
void launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int BQ = Rows<D>::kPerBlock;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.n);
  flash_dq_kernel<D, float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.sq, a.sk, a.q_start, a.k_start, a.causal,
      1.0f / sqrtf(static_cast<float>(D)));
}

// the tensor maps of the bf16 backward kernels: q and dO in boxes of
// q_box rows, k and v in boxes of k_box rows, lse and delta as flat
// vectors in boxes of q_box values
template <int D>
cudaError_t bwd_tensor_maps(const Args& a, int q_box, int k_box,
                            CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                            CUtensorMap* tdo, CUtensorMap* tlse,
                            CUtensorMap* tdelta) {
  using hopper::tensor_map_rows;
  const int64_t q_ns = static_cast<int64_t>(a.sq) * D;
  const int64_t k_ns = static_cast<int64_t>(a.sk) * D;
  const int64_t rows = static_cast<int64_t>(a.n) * a.sq;
  cudaError_t rc = tensor_map_rows<D>(tq, a.q, a.n, a.sq, q_ns, D, q_box);
  if (!rc) rc = tensor_map_rows<D>(tdo, a.dout, a.n, a.sq, q_ns, D, q_box);
  if (!rc) rc = tensor_map_rows<D>(tk, a.k, a.n, a.sk, k_ns, D, k_box);
  if (!rc) rc = tensor_map_rows<D>(tv, a.v, a.n, a.sk, k_ns, D, k_box);
  if (!rc) {
    rc = hopper::tensor_map_vec(tlse, static_cast<const float*>(a.lse),
                                rows, q_box);
  }
  if (!rc) {
    rc = hopper::tensor_map_vec(tdelta, static_cast<const float*>(a.delta),
                                rows, q_box);
  }
  return rc;
}

template <int D>
int launch_dq_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const cudaError_t rc = bwd_tensor_maps<D>(a, kDqRows, kDqKeys, &tq, &tk,
                                            &tv, &tdo, &tlse, &tdelta);
  if (rc) return static_cast<int>(rc);
  const dim3 grid(a.n, (a.sq + kDqRows - 1) / kDqRows);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  return static_cast<int>(hopper::launch(
      dq_wgmma_kernel<D>, grid, kWgThreads,
      static_cast<int>(sizeof(DqSmem<D>)) + 1024, stream, tq, tk, tv, tdo,
      tlse, tdelta, static_cast<__nv_bfloat16*>(a.dq), a.sq, a.sk,
      a.q_start, a.k_start, a.causal, scale, scale * kLog2e));
}

template <int D>
void launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int BK = Rows<D>::kPerBlock;
  const dim3 grid((a.sk + BK - 1) / BK, a.n);
  flash_dkv_kernel<D, float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.sq, a.sk,
      a.q_start, a.k_start, a.causal, 1.0f / sqrtf(static_cast<float>(D)));
}

template <int D>
int launch_dkv_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const cudaError_t rc = bwd_tensor_maps<D>(a, kBQ, kBK, &tq, &tk, &tv,
                                            &tdo, &tlse, &tdelta);
  if (rc) return static_cast<int>(rc);
  const dim3 grid(a.n, (a.sk + kBK - 1) / kBK);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  return static_cast<int>(hopper::launch(
      dkv_wgmma_kernel<D>, grid, kWgThreads,
      static_cast<int>(sizeof(DkvSmem<D>)) + 1024, stream, tq, tk, tv, tdo,
      tlse, tdelta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.sq, a.sk, a.q_start, a.k_start,
      a.causal, scale, scale * kLog2e));
}

// dQ: fp32 takes the FMA kernel, bf16 the tensor-core kernel
int dispatch_dq(int dtype, int head_dim, const Args& a, cudaStream_t st) {
  if (dtype == kFloat32) {
    switch (head_dim) {
      case 32: launch_dq<32>(a, st); break;
      case 64: launch_dq<64>(a, st); break;
      case 128: launch_dq<128>(a, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kBFloat16) {
    switch (head_dim) {
      case 32: return launch_dq_wgmma<32>(a, st);
      case 64: return launch_dq_wgmma<64>(a, st);
      case 128: return launch_dq_wgmma<128>(a, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dK/dV: fp32 takes the FMA kernel, bf16 the tensor-core kernel
int dispatch_dkv(int dtype, int head_dim, const Args& a, cudaStream_t st) {
  if (dtype == kFloat32) {
    switch (head_dim) {
      case 32: launch_dkv<32>(a, st); break;
      case 64: launch_dkv<64>(a, st); break;
      case 128: launch_dkv<128>(a, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kBFloat16) {
    switch (head_dim) {
      case 32: return launch_dkv_wgmma<32>(a, st);
      case 64: return launch_dkv_wgmma<64>(a, st);
      case 128: return launch_dkv_wgmma<128>(a, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
  return dispatch_dq(dtype, head_dim, a, static_cast<cudaStream_t>(stream));
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
  return dispatch_dkv(dtype, head_dim, a, static_cast<cudaStream_t>(stream));
}
