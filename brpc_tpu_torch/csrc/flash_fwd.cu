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
// as the TPU kernels write it. Products accumulate in fp32; P is rounded
// to the input dtype before P V, as the TPU kernel's p.astype(v.dtype)
// does.
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
// Three kernels behind one C interface, chosen by dtype, head dim and form:
//
// fp32 at head dim 16, plain form (the serving prefill, `_flash_kernel` of
// brpc_tpu/tpu/pallas_ops.py:174 behind `flash_attention`):
// `fwd_f32_mma_kernel`, on the tf32 tensor cores in 3xTF32 (hopper.cuh),
// so it keeps fp32 accuracy (one tf32 pass would keep three digits).
// Its bound at the largest prefill, (S, H, D) = (1024, 4, 16) causal: 134
// MFLOP of fp32 operations (4 D per live (q, k) pair), 0.00201 ms at 67
// TFLOP/s, against 1 MiB of q, k, v and o, 0.31 us at 3.35 TB/s. What
// held the FMA kernel below 5% of it was a serial chain and an empty
// card: 64 blocks of 4 warps on 132 SMs, each row walking every live key
// in order, a shuffle sum and an exp per key, and the heaviest block all
// 1024 keys. Here a block is one 16-row query tile (one m16 tile) of one
// head, and its 8 warps split the key range: warp w takes the 16-key
// tiles w, w + 8, ..., so the longest chain at S = 1024 is 128 keys, and
// the grid (N, Sq / 16) holds 256 blocks, the heaviest causal tiles
// launched first. Each warp brings its own k and v tiles into a
// two-stage ring in shared memory with cp.async (80-byte rows, so the
// fragment reads are free of bank conflicts), the next tile in flight
// while it computes on this one, with no block barrier in the loop.
// S = q k^T and O += P v are m16n8k8 tf32 products (12 + 12 a tile), q
// split into hi and lo once; the online softmax runs in base 2 on the
// score fragments (a row's max is two quad shuffles), masked only on
// tiles that cross the block's first row or the end, and P's fragments
// are the A operand of P v as they lie (v's rows read in the matching
// order). At the end the warps' (m, l, acc) merge through shared memory
// that the rings held (40 KB in all, under the default 48 KB). The
// split x = hi + lo is two integer operations and a subtraction
// (hopper.cuh): cvt.rna.tf32.f32 compiles to a guarded sequence that,
// done 96 times a tile, outweighed the products. The constants were
// chosen on the card among 2 / 4 / 8 warps, 16 / 32 / 64 keys and 2 / 3
// stages (bench/flash_serving_designs.py, PERF.md). lse is written when
// asked for, so every fp32 call of the plain form at D = 16 takes this
// kernel.
//
// fp32 otherwise (head dim 32, 64 and 128, the fp32 parity lanes, and the
// carry form at every head dim): `flash_fwd_kernel`, FMA on the CUDA
// cores. grid = (q-tiles, N). A block owns kThreads / (D / 8) query rows
// of one head, each row held by D / 8 lanes of a warp (common.cuh). It
// walks key tiles of 32 rows staged through shared memory as fp32 and
// stops at the block's last live key when causal; m, l and the output
// accumulator stay in registers. Every product is an fp32 FMA, so the fp32
// parity lanes compute in full fp32 (no TF32).
//
// bf16 at head dim 32, 64 and 128: `fwd_wgmma_kernel`, on the tensor
// cores (hopper.cuh). grid = (N, q-tiles), the q-tiles in reverse so that
// the heaviest causal tiles start first. A block owns kBM = 128 query rows
// of one head, 64 per warpgroup. TMA brings q once and the kBN = 128-key
// tiles of k and v into two stages on mbarriers (128-byte swizzle; 64-byte
// at D = 32): thread 0 issues tile t + 2 into the stage tile t has freed
// while both warpgroups compute on tile t + 1. Per tile, S = q k^T is one
// wgmma chain from shared memory into fp32 registers; the online softmax
// runs on those fragments in base-2 (a row's max is two quad shuffles);
// P is rounded to bf16 in registers (the JAX kernel's p.astype(v.dtype))
// and is the A operand of O += P v, with v read MN-major. The causal mask
// is applied only on tiles that straddle a warpgroup's diagonal or the
// ragged end; TMA zero-fills rows past the end of q, k and v. l is summed
// per thread and across the quad once, at the end. m stays in natural-log
// units: a tile in which a row's max does not move (no live key for it)
// rescales by exactly 1, so the carry form gives back the state of a row
// that saw no key bit for bit.
//
// What bounds the bf16 kernel: at the flagship training shape (N = 64,
// S = 1024, D = 128, causal, bf16) it does about 17.2 GFLOP (4 D per live
// (q, k) pair) and must move about 67 MB: 0.017 ms at 989 TFLOP/s of bf16
// tensor-core math against 0.020 ms at 3.35 TB/s, so its bound is bytes.
// A full ring hop of the carry form at (32, 512, 128) bf16 moves about
// 29.6 MB (q, k, v and the fp32 state in and out): 0.0088 ms at 3.35
// TB/s, against 0.0043 ms of bf16 operations.

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------
// fp32 at head dim 16, plain form (the serving prefill): tf32 tensor
// cores in 3xTF32, key stripes per warp
// ---------------------------------------------------------------------
constexpr int kSD = 16;           // head dim
constexpr int kSRows = 16;        // query rows per block: one m16 tile
constexpr int kSWarps = 8;        // key stripes per block, one per warp
constexpr int kSKeys = 16;        // keys per tile: kSKeys / 8 n8 tiles
constexpr int kSPitch = kSD + 4;  // floats per staged row: 80 bytes, so
                                  // fragment reads hit 32 distinct banks
constexpr int kSStages = 2;       // tiles of each warp in flight
constexpr int kSThreads = 32 * kSWarps;
constexpr int kSN = kSKeys / 8;   // n8 tiles of S, k8 steps of P v
constexpr int kSChains = kSN > 1 ? kSN / 2 : 1;  // P v accumulators
static_assert(kSKeys % 8 == 0 && kSN % kSChains == 0, "key tile");

union SmemF32 {  // dynamic shared memory of fwd_f32_mma_kernel
  float tiles[kSWarps][kSStages][2][kSKeys][kSPitch];  // each warp's ring
  struct {  // after the key loop: the warps' states, merged at the end
    float m[kSWarps][kSRows], l[kSWarps][kSRows];
    float acc[kSWarps][kSRows][kSD];
  } part;
};

__global__ void __launch_bounds__(kSThreads)
fwd_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int sq, int sk, Strides qs,
                   Strides kst, Strides vst, Strides ost, int causal,
                   float scale, float scale_log2) {
  using namespace hopper;
  extern __shared__ __align__(16) uint8_t smem_f32[];
  SmemF32& sm = *reinterpret_cast<SmemF32*>(smem_f32);

  const int n = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kSRows;  // heaviest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column group
  const float* kn = k + n * kst.n;
  const float* vn = v + n * vst.n;

  // causal: key c is live for some row of the block iff c < q0 + kSRows.
  // The warp takes key tiles warp, warp + kSWarps, ...
  const int k_end = causal ? min(sk, q0 + kSRows) : sk;
  const int n_tiles = (k_end + kSKeys - 1) / kSKeys;
  const int mine =
      n_tiles > warp ? (n_tiles - warp + kSWarps - 1) / kSWarps : 0;
  float (*ring)[2][kSKeys][kSPitch] = sm.tiles[warp];

  // the warp's j-th tile into stage j % kSStages; keys past sk are zeros
  auto load = [&](int j) {
    const int k0 = (warp + j * kSWarps) * kSKeys;
    float (*dk)[kSPitch] = ring[j % kSStages][0];
    float (*dv)[kSPitch] = ring[j % kSStages][1];
#pragma unroll
    for (int i = 0; i < kSKeys / 8; ++i) {  // 8 rows of 4 chunks a pass
      const int r = 8 * i + lane / 4;
      const int c = 4 * (lane % 4);
      const bool live = k0 + r < sk;
      const int64_t key = live ? k0 + r : 0;
      cp_async_16(&dk[r][c], kn + key * kst.row + c, live);
      cp_async_16(&dv[r][c], vn + key * vst.row + c, live);
    }
  };
#pragma unroll
  for (int j = 0; j < kSStages; ++j) {
    if (j < mine) load(j);
    cp_async_commit();
  }

  // q's A fragments for the two k8 steps over D, split once (their loads
  // overlap the tiles' in flight): register i holds row g + 8 (i % 2),
  // dim 8 kk + t + 4 (i / 2)
  uint32_t qh[2][4], ql[2][4];
  const float* qn = q + n * qs.n;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + 8 * (i & 1);
      const float x = row < sq ? qn[row * qs.row + 8 * kk + t + 4 * (i >> 1)]
                               : 0.f;
      split_tf32(x, qh[kk][i], ql[kk][i]);
    }
  }

  // running state of rows g and g + 8: m in natural-log units, l this
  // thread's share of the row sum, acc the unnormalised output as
  // kSChains chains (k8 steps of P v, dealt round-robin) of two n8 tiles
  // over D
  float acc[kSChains][2][4];
#pragma unroll
  for (int p = 0; p < kSChains; ++p) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][nt][i] = 0.f;
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<kSStages - 1>();  // this warp's tile j has landed
    __syncwarp();
    const int k0 = (warp + j * kSWarps) * kSKeys;
    const float (*ks)[kSPitch] = ring[j % kSStages][0];
    const float (*vs)[kSPitch] = ring[j % kSStages][1];

    // S = q k^T: n8 tile nt holds keys k0 + 8 nt + 2t + (i % 2) of rows
    // g + 8 (i / 2)
    float s[kSN][4];
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bh[2], bl[2];
        split_tf32(ks[8 * nt + g][8 * kk + t], bh[0], bl[0]);
        split_tf32(ks[8 * nt + g][8 * kk + t + 4], bh[1], bl[1]);
        mma_3xtf32(s[nt], qh[kk], ql[kk], bh, bl);
      }
    }

    // the mask, only on a tile past the end or past the block's first row
    if (k0 + kSKeys > sk || (causal && k0 + kSKeys - 1 > q0)) {
#pragma unroll
      for (int nt = 0; nt < kSN; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = k0 + 8 * nt + 2 * t + (i & 1);
          const int row = q0 + g + 8 * (i >> 1);
          if (kc >= sk || (causal && row < kc)) s[nt][i] = -INFINITY;
        }
      }
    }

    // online softmax in base 2, as fwd_wgmma_kernel: a row whose max does
    // not move rescales by exactly 1
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
    }
    float mb[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale);
      mb[h] = m_new == -INFINITY ? 0.f : m_new * kLog2e;
      alpha[h] = m_new == m[h] ? 1.f  // 0 below on the first live tile
                               : exp2_ftz(__fmul_rn(m[h], kLog2e) - mb[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int p = 0; p < kSChains; ++p) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][nt][i] *= alpha[i >> 1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // masked scores are -inf: exactly 0
        s[nt][i] = exp2_ftz(fmaf(s[nt][i], scale_log2, -mb[i >> 1]));
        l[i >> 1] += s[nt][i];
      }
    }

    // O += P v over the tile's k8 steps. Step kk is S's n8 tile kk: its
    // reduction index runs over keys in the order 2t, 2t + 1 (the
    // fragment's t, t + 4), so {c0, c2, c1, c3} is the A fragment and v's
    // rows are read in that order
#pragma unroll
    for (int kk = 0; kk < kSN; ++kk) {
      uint32_t ph[4], pl[4];
      split_tf32(s[kk][0], ph[0], pl[0]);
      split_tf32(s[kk][2], ph[1], pl[1]);
      split_tf32(s[kk][1], ph[2], pl[2]);
      split_tf32(s[kk][3], ph[3], pl[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(vs[8 * kk + 2 * t][8 * nt + g], bh[0], bl[0]);
        split_tf32(vs[8 * kk + 2 * t + 1][8 * nt + g], bh[1], bl[1]);
        mma_3xtf32(acc[kk % kSChains][nt], ph, pl, bh, bl);
      }
    }

    __syncwarp();  // every lane is done with this stage
    if (j + kSStages < mine) load(j + kSStages);
    cp_async_commit();
  }

  // merge the warps' states: m = max m_w, l = sum l_w e^(m_w - m), acc
  // likewise; a warp that saw no live key (m_w = -inf) weighs 0. The
  // states take the tiles' memory once every warp is done with its ring
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) {
      sm.part.m[warp][g + 8 * h] = m[h];
      sm.part.l[warp][g + 8 * h] = l[h];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float2 x = make_float2(0.f, 0.f);
#pragma unroll
      for (int p = 0; p < kSChains; ++p) {
        x.x += acc[p][nt][2 * h];
        x.y += acc[p][nt][2 * h + 1];
      }
      float* dst = &sm.part.acc[warp][g + 8 * h][8 * nt + 2 * t];
      *reinterpret_cast<float2*>(dst) = x;
    }
  }
  __syncthreads();

  // the block's 16 x 16 outputs, two columns a thread
  for (int idx = threadIdx.x; idx < kSRows * kSD / 2; idx += kSThreads) {
    const int r = idx / (kSD / 2);
    const int c = 2 * (idx % (kSD / 2));
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) mmax = fmaxf(mmax, sm.part.m[w][r]);
    float lsum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) {
      const float mw = sm.part.m[w][r];
      const float wt =
          mw == -INFINITY ? 0.f : exp2f(__fmul_rn(mw - mmax, kLog2e));
      const float2 a =
          *reinterpret_cast<const float2*>(&sm.part.acc[w][r][c]);
      lsum = fmaf(sm.part.l[w][r], wt, lsum);
      o0 = fmaf(a.x, wt, o0);
      o1 = fmaf(a.y, wt, o1);
    }
    const int row = q0 + r;
    if (row >= sq) continue;
    const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
    *reinterpret_cast<float2*>(o + n * ost.n + row * ost.row + c) =
        make_float2(o0 * inv, o1 * inv);
    if (lse != nullptr && c == 0) {
      lse[static_cast<int64_t>(n) * sq + row] =
          lsum == 0.f ? kNegInf : mmax + logf(lsum);
    }
  }
}

// ---------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------
using hopper::kLog2e;
using hopper::kWgThreads;
constexpr int kBM = 128;  // query rows per block, 64 per warpgroup
constexpr int kBN = 128;  // keys per tile

template <int D>
struct FwdSmem {  // each array a multiple of 1024 bytes: every tile aligned
  __nv_bfloat16 q[kBM * D];
  __nv_bfloat16 k[2][kBN * D];
  __nv_bfloat16 v[2][kBN * D];
  uint64_t q_full, full[2];
};

template <int D, bool kCarry>
__global__ void __launch_bounds__(kWgThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 Carry c, int sq, int sk, Strides ost, int causal,
                 int q_start, int k_start, float scale, float scale_log2) {
  using namespace hopper;
  using T = Tile<D>;
  constexpr int kAcc = D / 2;     // output registers per thread
  constexpr int kScores = kBN / 2;  // score registers per thread
  constexpr uint32_t kStageBytes = 2 * kBN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int n = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const Frag f(tid % 128);
  const int row_lo = q0 + 64 * wg + f.row0;  // this thread's rows: +0, +8
  // causal: key c is live for some row of the block iff
  // k_start + c <= q_start + q0 + kBM - 1; a bound <= 0 runs no tile
  const int k_end = causal
      ? max(0, min(sk, q_start + q0 + kBM - k_start)) : sk;
  const int tiles = (k_end + kBN - 1) / kBN;

  auto load_kv = [&](int t) {
    const int s = t & 1;
    mbar_expect_tx(&sm.full[s], kStageBytes);
#pragma unroll
    for (int b = 0; b < T::kBlocks; ++b) {
      tma_load_3d(sm.k[s] + b * kBN * T::kAtom, &tk, &sm.full[s],
                  b * T::kAtom, t * kBN, n);
      tma_load_3d(sm.v[s] + b * kBN * T::kAtom, &tv, &sm.full[s],
                  b * T::kAtom, t * kBN, n);
    }
  };
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && tiles > 0) {
    mbar_expect_tx(&sm.q_full, kBM * D * 2);
#pragma unroll
    for (int b = 0; b < T::kBlocks; ++b) {
      tma_load_3d(sm.q + b * kBM * T::kAtom, &tq, &sm.q_full, b * T::kAtom,
                  q0, n);
    }
    load_kv(0);
    if (tiles > 1) load_kv(1);
  }

  // running state of rows row_lo and row_lo + 8: m in natural-log units,
  // l this thread's share of the row sum (the quad's shares are added at
  // the end), acc the unnormalised output
  float acc[kAcc], m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + 8 * h;
    const int64_t srow = static_cast<int64_t>(n) * sq + row;
    if constexpr (kCarry) {
      m[h] = row < sq ? c.m_in[srow] : kNegInf;
      l[h] = row < sq && f.col0 == 0 ? c.l_in[srow] : 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float2 x = make_float2(0.f, 0.f);
        if (row < sq) {
          x = *reinterpret_cast<const float2*>(c.acc_in + srow * D + f.col0 +
                                               8 * j);
        }
        acc[4 * j + 2 * h] = x.x;
        acc[4 * j + 2 * h + 1] = x.y;
      }
    } else {
      m[h] = -INFINITY;
      l[h] = 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
      }
    }
  }

  if (tiles > 0) mbar_wait(&sm.q_full, 0);
  const int first_row = q_start + q0 + 64 * wg;  // this warpgroup's, absolute
  for (int t = 0; t < tiles; ++t) {
    const int s = t & 1;
    const int k0 = t * kBN;
    mbar_wait(&sm.full[s], (t >> 1) & 1);

    float sc[kScores];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBN>::ss(sc, desc_k_major<D>(sm.q, kBM, 64 * wg, kk),
                     desc_k_major<D>(sm.k[s], kBN, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // the mask, only where a key of the tile lies past the end or past
    // this warpgroup's first row
    if (k0 + kBN > sk || (causal && k_start + k0 + kBN - 1 > first_row)) {
#pragma unroll
      for (int i = 0; i < kScores; ++i) {
        const int kc = k0 + f.col(i);
        if (kc >= sk || (causal && first_row + f.row(i) < k_start + kc)) {
          sc[i] = -INFINITY;
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float mb[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // a row whose max did not move (no live key here, say) keeps its
      // state bit for bit: alpha is exactly 1, not exp2 of a difference
      // that contraction into an FMA would leave at the rounding error
      const float m_new = fmaxf(m[h], mx[h] * scale);
      mb[h] = m_new == -INFINITY ? 0.f : m_new * kLog2e;
      alpha[h] = m_new == m[h] ? 1.f  // 0 below on the first live tile
                               : exp2f(__fmul_rn(m[h], kLog2e) - mb[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      // masked scores are -inf: exactly 0
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -mb[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }

    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) a_fragment(sc, kk, pa[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      Wgmma<D>::rs(acc, pa[kk], desc_mn_major<D>(sm.v[s], kBN, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && t + 2 < tiles) load_kv(t + 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row_lo + 8 * h;
    if (row >= sq) continue;
    const int64_t srow = static_cast<int64_t>(n) * sq + row;
    if constexpr (kCarry) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(c.acc_out + srow * D + f.col0 + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
      if (f.col0 == 0) {
        c.m_out[srow] = m[h];
        c.l_out[srow] = l[h];
      }
    } else {
      const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
      __nv_bfloat16* orow = o + n * ost.n + row * ost.row + f.col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            hopper::pack_bf16(acc[4 * j + 2 * h] * inv,
                              acc[4 * j + 2 * h + 1] * inv);
      }
      if (lse != nullptr && f.col0 == 0) {
        lse[srow] = l[h] == 0.f ? kNegInf : m[h] + logf(l[h]);
      }
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

template <int D, bool kCarry>
void launch_fma(const Args& a) {
  constexpr int BQ = Rows<D>::kPerBlock;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.n);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<D, float, kCarry><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.c, a.sq, a.sk, a.qs, a.ks, a.vs, a.os,
      a.causal, a.q_start, a.k_start, scale);
}

int launch_f32_mma(const Args& a) {
  constexpr int kBytes = static_cast<int>(sizeof(SmemF32));
  if (kBytes > 48 * 1024) {  // opt in above the default 48 KB
    const cudaError_t rc = cudaFuncSetAttribute(
        fwd_f32_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid(a.n, (a.sq + kSRows - 1) / kSRows);
  const float scale = 1.0f / sqrtf(static_cast<float>(kSD));
  fwd_f32_mma_kernel<<<grid, kSThreads, kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.qs, a.ks, a.vs, a.os,
      a.causal, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCarry>
int launch_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv;
  cudaError_t rc = hopper::tensor_map_rows<D>(&tq, a.q, a.n, a.sq, a.qs.n,
                                              a.qs.row, kBM);
  if (rc == cudaSuccess) {
    rc = hopper::tensor_map_rows<D>(&tk, a.k, a.n, a.sk, a.ks.n, a.ks.row,
                                    kBN);
  }
  if (rc == cudaSuccess) {
    rc = hopper::tensor_map_rows<D>(&tv, a.v, a.n, a.sk, a.vs.n, a.vs.row,
                                    kBN);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(a.n, (a.sq + kBM - 1) / kBM);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  return static_cast<int>(hopper::launch(
      fwd_wgmma_kernel<D, kCarry>, grid, kWgThreads,
      static_cast<int>(sizeof(FwdSmem<D>)) + 1024, a.stream, tq, tk, tv,
      static_cast<__nv_bfloat16*>(a.o), static_cast<float*>(a.lse), a.c,
      a.sq, a.sk, a.os, a.causal, a.q_start, a.k_start, scale,
      scale * kLog2e));
}

// fp32 at head dim 16 takes the tf32 tensor-core kernel in its plain form
// (the serving prefill) and the FMA kernel in its carry form; fp32 at 32,
// 64 and 128 the FMA kernel; bf16 the wgmma kernel at 32, 64 and 128;
// anything else is refused without a launch
template <bool kCarry>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == kFloat32) {
    switch (head_dim) {
      case 16:
        if constexpr (!kCarry) return launch_f32_mma(a);
        launch_fma<16, true>(a);
        break;
      case 32: launch_fma<32, kCarry>(a); break;
      case 64: launch_fma<64, kCarry>(a); break;
      case 128: launch_fma<128, kCarry>(a); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kBFloat16) {
    switch (head_dim) {
      case 32: return launch_wgmma<32, kCarry>(a);
      case 64: return launch_wgmma<64, kCarry>(a);
      case 128: return launch_wgmma<128, kCarry>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
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
