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
// Design: a grid-stride loop of 16-byte loads and stores, kUnroll loads in
// flight per thread before their stores, over kBlocksPerSM blocks per SM,
// so that enough bytes are in flight to cover the memory's latency. When
// src and dst sit at the same offset modulo 16, a scalar head brings both
// to 16 bytes and a scalar tail finishes the length; otherwise the whole
// copy is a byte loop (right, and slow; no caller on the main path passes
// such pointers).
//
// brpc_copy_batched runs k <= 32 independent copies in one launch:
// blockIdx.y picks the copy, and the k (src, dst, nbytes) triples travel by
// value in the kernel's parameters (32 x 24 bytes), so a batch needs no
// host-to-device copy of its descriptors.

#include "common.cuh"

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

constexpr int kCopyThreads = 256;
constexpr int kBlocksPerSM = 8;  // 2048 threads: a full SM
constexpr int kUnroll = 4;       // 16-byte loads in flight per thread
constexpr int kMaxBatch = 32;    // the store's dispatcher batches <= 32

struct CopyBatch {
  CopyItem item[kMaxBatch];
};

// bytes [0, n) of src into dst, by the threads t, t + stride, ...
__device__ __forceinline__ void copy_range(const uint8_t* __restrict__ src,
                                           uint8_t* __restrict__ dst,
                                           int64_t n, int64_t t,
                                           int64_t stride) {
  // bytes [head, head + 16 * body) move as 16-byte words
  int64_t head = 0, body = 0;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  if (mis == (reinterpret_cast<uintptr_t>(dst) & 15)) {
    head = static_cast<int64_t>((16 - mis) & 15);
    head = head < n ? head : n;
    body = (n - head) / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    int64_t i = t;
    for (; i + (kUnroll - 1) * stride < body; i += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = s4[i + u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d4[i + u * stride] = v[u];
    }
    for (; i < body; i += stride) d4[i] = s4[i];
  }
  for (int64_t i = t; i < head; i += stride) dst[i] = src[i];
  for (int64_t i = head + 16 * body + t; i < n; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            int64_t n) {
  copy_range(src, dst, n,
             static_cast<int64_t>(blockIdx.x) * kCopyThreads + threadIdx.x,
             static_cast<int64_t>(gridDim.x) * kCopyThreads);
}

// __grid_constant__: the batch is read in place from the parameter space,
// not copied to each thread's local memory by the dynamic index
__global__ void __launch_bounds__(kCopyThreads)
copy_batched_kernel(const __grid_constant__ CopyBatch batch) {
  const CopyItem& it = batch.item[blockIdx.y];
  copy_range(static_cast<const uint8_t*>(it.src),
             static_cast<uint8_t*>(it.dst), it.nbytes,
             static_cast<int64_t>(blockIdx.x) * kCopyThreads + threadIdx.x,
             static_cast<int64_t>(gridDim.x) * kCopyThreads);
}

// blocks for a copy of n bytes: enough for one pass of kUnroll words per
// thread, at most `cap`
unsigned blocks_for(int64_t n, int64_t cap) {
  const int64_t per_block = static_cast<int64_t>(kCopyThreads) * kUnroll;
  int64_t b = ((n + 15) / 16 + per_block - 1) / per_block;
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
  copy_kernel<<<blocks_for(nbytes, cap), kCopyThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes);
  return static_cast<int>(cudaGetLastError());
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
  copy_batched_kernel<<<grid, kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(batch);
  return static_cast<int>(cudaGetLastError());
}
