// Byte copy for Hopper (sm_90a): the device data plane's one kernel.
//
// Replaces the TPU kernels whose body is `dst_ref[:] = src_ref[:]`:
//   #10 `_copy_kernel` behind `hbm_copy` (brpc_tpu/tpu/bench_kernels.py:22,
//       :27), a 1-D copy in blocks of 2^20 elements;
//   #11 the same body behind `hbm_copy2d` (:64), a [rows, lanes] copy in
//       blocks of 512 rows, which `echo_loop` and `echo_loop_probe` drive;
//   #12 the local `_copy_kernel` behind `copy_call`
//       (tools/kernel_bench.py:320), the (65536, 2048) bf16 copy that sets
//       RMSNorm's bandwidth ceiling.
// A copy does not care about shape or type, so both entry points copy
// bytes; the wrappers in tpu/bench_kernels.py give shapes and types. The
// TPU grids stop at a whole number of blocks and leave the tail unwritten
// (ROADMAP Queue 3); here every byte is copied.
//
// What bounds it on this card: bytes, 2 * nbytes through device memory
// (each byte read once and written once): 40 us for 64 MiB at 3.35 TB/s.
// Design, on Hopper's bulk asynchronous copies: a grid of kBlocksPerSM
// blocks per SM over the 16-byte-aligned body, cut into chunks of
// kStageBytes dealt round-robin (block b takes chunks b, b + B, ...), so
// the blocks sweep the copy together. One thread of each block moves its
// chunks through a ring of kStages shared-memory stages: a bulk load
// (cp.async.bulk, completed on the stage's mbarrier) brings a chunk in, a
// bulk store writes it out, and a stage is loaded again only once its
// store has read it (cp.async.bulk.wait_group.read). So kStages - 1 chunks
// per block are in flight without holding registers, in large contiguous
// transactions, and no thread ends on a latency-bound remainder loop.
// (On an H100, one contiguous span of chunks per block was 1-2% slower at
// 64 and 256 MiB: brpc_tpu_torch/bench/copy_designs.py, PERF.md.)
// When src and dst sit at the same offset modulo 16, the other threads
// copy the unaligned head and tail bytes; otherwise no bulk copy applies
// and the whole copy is a byte loop (right, and slow; no caller on the
// main path passes such pointers).
//
// brpc_copy_batched runs k <= 32 independent copies in one launch:
// blockIdx.y picks the copy, and the k (src, dst, nbytes) triples travel by
// value in the kernel's parameters (32 x 24 bytes), so a batch needs no
// host-to-device copy of its descriptors.

#include "common.cuh"
#include "hopper.cuh"

// one copy of the batched entry point, as the wrapper lays it out
// (bench_kernels._CopyItem). Outside the anonymous namespace: a type with
// internal linkage in its signature would keep brpc_copy_batched from
// being exported.
struct CopyItem {
  const void* src;
  void* dst;
  int64_t nbytes;
};

namespace {

using namespace brpc;

constexpr int kCopyThreads = 256;  // the head, tail and byte loops
constexpr int kBlocksPerSM = 2;
constexpr int kStages = 4;               // shared-memory stages per block
constexpr int kStageBytes = 16 << 10;    // bytes per stage and bulk copy
constexpr int kMaxBatch = 32;  // the store's dispatcher batches <= 32

struct CopyBatch {
  CopyItem item[kMaxBatch];
};

struct CopySmem {
  uint8_t stage[kStages][kStageBytes];
  uint64_t full[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(CopySmem)) + 128;

__device__ __forceinline__ CopySmem& copy_smem() {
  extern __shared__ uint8_t smem_raw[];
  return *reinterpret_cast<CopySmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
}

// chunks block, block + blocks, ... of the body (`bytes`, a multiple of
// 16, both ends 16-byte aligned) of src into dst through the stages; run
// by one thread
__device__ void copy_chunks(const uint8_t* src, uint8_t* dst, int64_t bytes,
                            int64_t block, int64_t blocks, CopySmem& sm) {
  using namespace hopper;
  const int64_t total = (bytes + kStageBytes - 1) / kStageBytes;
  const int64_t chunks =
      total > block ? (total - block + blocks - 1) / blocks : 0;
  for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
  mbar_fence_init();
  auto off = [&](int64_t j) { return (block + j * blocks) * kStageBytes; };
  auto size = [&](int64_t j) {
    const int64_t left = bytes - off(j);
    return static_cast<uint32_t>(left < kStageBytes ? left : kStageBytes);
  };
  auto load = [&](int64_t j) {
    const int s = static_cast<int>(j % kStages);
    mbar_expect_tx(&sm.full[s], size(j));
    bulk_load(sm.stage[s], src + off(j), size(j), &sm.full[s]);
  };
  for (int64_t c = 0; c < chunks && c < kStages; ++c) load(c);
  for (int64_t i = 0; i < chunks; ++i) {
    const int s = static_cast<int>(i % kStages);
    mbar_wait(&sm.full[s], static_cast<uint32_t>((i / kStages) & 1));
    fence_proxy_async();
    bulk_store(dst + off(i), sm.stage[s], size(i));
    bulk_commit();
    // chunk i - 1's stage takes chunk i - 1 + kStages once its store,
    // the one before this chunk's, has read it
    if (i >= 1 && i - 1 + kStages < chunks) {
      bulk_wait_read<1>();
      load(i - 1 + kStages);
    }
  }
  bulk_wait<0>();
}

// bytes [0, n) of src into dst: block `block` of `blocks` copies its
// chunks of the body; all their threads share the head, the tail or the
// byte loop
__device__ __forceinline__ void copy_range(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst,
                                           int64_t n, int64_t block,
                                           int64_t blocks) {
  const int64_t t = block * kCopyThreads + threadIdx.x;
  const int64_t stride = blocks * kCopyThreads;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  if (mis != (reinterpret_cast<uintptr_t>(dst) & 15)) {
    for (int64_t i = t; i < n; i += stride) dst[i] = src[i];
    return;
  }
  int64_t head = static_cast<int64_t>((16 - mis) & 15);
  head = head < n ? head : n;
  const int64_t words = (n - head) / 16;  // the body, in 16-byte words
  for (int64_t i = t; i < head; i += stride) dst[i] = src[i];
  for (int64_t i = head + 16 * words + t; i < n; i += stride) dst[i] = src[i];
  if (threadIdx.x == 0 && words > 0) {
    copy_chunks(src + head, dst + head, 16 * words, block, blocks,
                copy_smem());
  }
}

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            int64_t n) {
  copy_range(src, dst, n, blockIdx.x, gridDim.x);
}

// __grid_constant__: the batch is read in place from the parameter space,
// not copied to each thread's local memory by the dynamic index
__global__ void __launch_bounds__(kCopyThreads)
copy_batched_kernel(const __grid_constant__ CopyBatch batch) {
  const CopyItem& it = batch.item[blockIdx.y];
  copy_range(static_cast<const uint8_t*>(it.src),
             static_cast<uint8_t*>(it.dst), it.nbytes, blockIdx.x,
             gridDim.x);
}

// blocks for a copy of n bytes: one per stage's worth, at most `cap`
unsigned blocks_for(int64_t n, int64_t cap) {
  int64_t b = (n + kStageBytes - 1) / kStageBytes;
  b = b < cap ? b : cap;
  return static_cast<unsigned>(b > 0 ? b : 1);
}

// kBlocksPerSM blocks for each SM of the current device
cudaError_t grid_cap(int64_t* cap) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  *cap = static_cast<int64_t>(kBlocksPerSM) * (sms > 0 ? sms : 1);
  return rc;
}

}  // namespace

// nbytes of src into dst (not overlapping), any alignment. Launches on
// `stream` and returns cudaGetLastError(); nbytes <= 0 launches nothing.
extern "C" int brpc_copy(const void* src, void* dst, int64_t nbytes,
                         void* stream) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  int64_t cap = 0;
  const cudaError_t rc = grid_cap(&cap);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(brpc::hopper::launch(
      copy_kernel, dim3(blocks_for(nbytes, cap)), kCopyThreads, kSmemBytes,
      static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(src),
      static_cast<uint8_t*>(dst), nbytes));
}

// k (1 <= k <= 32) copies in one launch; `items` is a host array of k
// (src, dst, nbytes) triples, copied into the launch's parameters. Returns
// cudaGetLastError(), or cudaErrorInvalidValue without launching for a bad
// k or a negative length.
extern "C" int brpc_copy_batched(const CopyItem* items, int k, void* stream) {
  if (k < 1 || k > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  CopyBatch batch = {};
  int64_t longest = 0;
  for (int i = 0; i < k; ++i) {
    if (items[i].nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
    batch.item[i] = items[i];
    longest = items[i].nbytes > longest ? items[i].nbytes : longest;
  }
  int64_t cap = 0;
  const cudaError_t rc = grid_cap(&cap);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // the card's worth of blocks shared among the k copies
  const int64_t share = cap / k > 0 ? cap / k : 1;
  const dim3 grid(blocks_for(longest, share), k);
  return static_cast<int>(brpc::hopper::launch(
      copy_batched_kernel, grid, kCopyThreads, kSmemBytes,
      static_cast<cudaStream_t>(stream), batch));
}
