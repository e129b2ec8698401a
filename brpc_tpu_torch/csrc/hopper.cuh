// Hopper (sm_90a) building blocks of the bf16 attention kernels
// (flash_fwd.cu, flash_bwd.cu) and the copy (copy.cu): mbarriers, TMA
// tensor maps and loads, bulk copies, wgmma shared-memory descriptors, the
// m64nNk16 bf16 products and the fragment layout of their accumulators;
// and for the fp32 serving forward, the m16n8k8 tf32 product in its 3xTF32
// form and cp.async.
//
// Shared-memory tiles. A TMA load with a 128-byte swizzle writes a box of
// kAtom = 64 bf16 columns (one 128-byte row each) into rows of 128 bytes,
// the 16-byte chunk c of row r at chunk c ^ (r % 8); a tile whose rows are
// D = 128 values wide is kept as two such column blocks, one after the
// other. D = 32 rows are 64 bytes, loaded with a 64-byte swizzle (chunk
// c ^ ((r / 2) % 4)). That is the layout wgmma reads through a descriptor
// of the same swizzle (Swizzle<3,4,3> and Swizzle<2,4,3> in CUTLASS's
// terms), for an operand whose reduction axis is the contiguous one
// (K-major: q and k in q k^T) and, with the transpose flag, for one whose
// output axis is (MN-major: v in P v, whose rows are the reduction axis).
//
// Fragments. A m64nN accumulator is spread over the 128 threads of a
// warpgroup: warp w of the group holds rows 16 w + lane / 4 and that + 8,
// thread lane % 4 of each quad the columns 8 j + 2 (lane % 4) + {0, 1} for
// j < N / 8. Register 4 j + h holds row (h / 2 ? +8 : +0), column
// 8 j + 2 (lane % 4) + h % 2. So a row's values lie in one quad (a row
// reduction is two shuffles), and the registers 8 kk .. 8 kk + 7 of an
// accumulator, rounded to bf16 in pairs, are exactly the A fragment of a
// register-sourced wgmma over the 16 columns 16 kk .. 16 kk + 15: a score
// tile becomes the left operand of the next product without leaving the
// registers.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace brpc {
namespace hopper {

constexpr int kWgThreads = 256;  // a block of two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// waits until the phase of parity `parity` has completed. A phase that
// never completes (a load that was never issued) traps after about ten
// seconds instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// ---------------------------------------------------------------------
// TMA: tiled loads into shared memory, completed on an mbarrier. `map`
// is a kernel parameter (__grid_constant__), so its address is valid for
// the copy engine.
// ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------
// Bulk copies (no tensor map): `bytes` a multiple of 16, both addresses
// 16-byte aligned. A load completes on an mbarrier; stores are committed
// in groups, and a group's wait_read frees its shared-memory source.
// ---------------------------------------------------------------------
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// waits until at most N committed store groups are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// orders this thread's view of shared memory before the async proxy's
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// Tile geometry of a [rows][D] bf16 tile in shared memory
// ---------------------------------------------------------------------
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  static constexpr int kSwizzle = D == 32 ? 64 : 128;  // bytes per row
  static constexpr int kAtom = kSwizzle / 2;           // bf16 per row
  static constexpr int kBlocks = D / kAtom;            // column blocks
  static constexpr int kGroup = 8 * kSwizzle;  // bytes of 8 rows
  // the descriptor's layout code: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
};

// ---------------------------------------------------------------------
// wgmma shared-memory descriptors: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle layout
// ---------------------------------------------------------------------
template <int D>
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         Tile<D>::kLayout << 62;
}

// K-major operand (reduction axis contiguous): rows [r0, r0 + M) of a
// tile of `rows` rows, reduction columns [16 kk, 16 kk + 16). Rows step by
// the row pitch inside a group of 8 and by kGroup between groups; a step
// of 16 columns inside a 128-byte row is 32 bytes added to the start,
// which the swizzle then permutes as TMA did.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(const __nv_bfloat16* tile,
                                                 int rows, int r0, int kk) {
  using T = Tile<D>;
  constexpr int kPerBlock = T::kAtom / 16;  // k16 steps per column block
  const __nv_bfloat16* p = tile + (kk / kPerBlock) * rows * T::kAtom +
                           r0 * T::kAtom + (kk % kPerBlock) * 16;
  return make_desc<D>(p, 16, T::kGroup);
}

// MN-major operand (output axis contiguous, with the transpose flag):
// reduction rows [16 kk, 16 kk + 16) of a tile of `rows` rows, all D
// output columns. The leading offset steps between column blocks, the
// stride offset between groups of 8 reduction rows.
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(const __nv_bfloat16* tile,
                                                  int rows, int kk) {
  using T = Tile<D>;
  return make_desc<D>(tile + 16 * kk * T::kAtom,
                      rows * T::kSwizzle, T::kGroup);
}

// ---------------------------------------------------------------------
// wgmma issue and completion; every thread of the warpgroup calls these
// ---------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// an asynchronous product that owns it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// two floats as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// where this thread's accumulator registers lie in the m64 x N tile: row
// row0 (registers 4 j, 4 j + 1) and row0 + 8 (4 j + 2, 4 j + 3), column
// col0 + 8 j + (i % 2); `t` is the thread's index in its warpgroup
struct Frag {
  int row0, col0;
  __device__ __forceinline__ explicit Frag(int t)
      : row0(16 * (t / 32) + (t % 32) / 4), col0(2 * (t % 4)) {}
  __device__ __forceinline__ int row(int i) const {
    return row0 + 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return col0 + 8 * (i >> 2) + (i & 1);
  }
};

// the A fragment of the k16 step kk, rounded to bf16, out of an fp32
// accumulator (kk a constant after unrolling: registers are never indexed
// at run time)
template <int R>
__device__ __forceinline__ void a_fragment(const float (&p)[R], int kk,
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
}

// m64nNk16, bf16 in, fp32 accumulate: ss() takes A and B from shared
// memory, both K-major (the score tiles, N = 64, 128); rs() takes A from
// registers and B MN-major, transposed (the products into D columns, N =
// 32, 64, 128). `accumulate` 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

// ---------------------------------------------------------------------
// fp32 on the tensor cores (the serving forward, flash_fwd.cu): the
// warp-level m16n8k8 tf32 product in its 3xTF32 form, and cp.async.
//
// A tf32 operand keeps 10 mantissa bits of an fp32 value, about three
// decimal digits: one pass would not hold fp32 parity. So each operand is
// split, x = hi + lo with hi = tf32(x) and lo = x - hi, and
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, each term an exact product
// summed in fp32. The product reads a tf32 operand's top 19 bits, so lo
// enters truncated to tf32; that and the dropped a_lo b_lo are ~2^-21 of
// |a b|.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row) a0 =
// A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; B (8 x
// 8, col) b0 = B[t][g], b1 = B[t + 4][g]; C (16 x 8) c0 = C[g][2t], c1 =
// C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]. A C fragment is
// not an A fragment (C holds columns 2t, 2t + 1; A holds t, t + 4), but the
// reduction index of a product may be permuted as long as both operands
// follow the same order: reading B's rows 2t and 2t + 1 where the fragment
// says t and t + 4 makes {c0, c2, c1, c3} the A fragment, with no shuffle.
// ---------------------------------------------------------------------
// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero): two integer operations, where the cvt compiles to
// a sequence guarded for infinities and NaN
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi = tf32(x), lo = x - hi (exact in fp32); x finite
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x, flushing results below 2^-126 to 0 (-inf gives 0): one MUFU.EX2,
// without exp2f's rescaling of subnormal results
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b, one m16n8k8 tf32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small terms first, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// 16 bytes from global to shared memory, asynchronously; `live` false
// reads nothing and writes zeros (src must still be a valid address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------
// Host side: TMA tensor maps. cuTensorMapEncodeTiled is a driver call; it
// is fetched through the runtime's entry-point query, so the libraries
// link against the runtime only.
// ---------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A [n, rows, D] bf16 tensor, rows `row_stride` and heads `n_stride`
// elements apart (the last dim contiguous; both strides multiples of 8
// elements, the base 16-byte aligned), loaded as boxes of box_rows rows
// and one column block (Tile<D>::kAtom columns) with the tile's swizzle;
// rows past the end read as zeros. Returns cudaSuccess or
// cudaErrorInvalidValue.
template <int D>
cudaError_t tensor_map_rows(CUtensorMap* map, const void* base, int n,
                            int rows, int64_t n_stride, int64_t row_stride,
                            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(n_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<D>::kAtom),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tile<D>::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A flat fp32 vector of `count` values (lse or delta of every row of
// every head), loaded as boxes of `box` values; past the end reads zeros.
inline cudaError_t tensor_map_vec(CUtensorMap* map, const float* base,
                                  int64_t count, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(count)};
  const cuuint64_t strides[1] = {16};  // rank 1: none is read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  const CUresult rc = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
      dims, strides, boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Opts a kernel into `bytes` of dynamic shared memory (above 48 KB a
// launch is refused without it) and launches it; returns the launch's
// error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace brpc
