// Thread-block clusters for the recurrences whose weights outgrow one SM
// (rnn_scan.cu, gru_bwd.cu, lstm_bwd.cu): C blocks on neighbouring SMs
// split the hidden units, each holds the weight rows of its own units in
// its shared memory, and each step every block writes its slice of the
// step's operand into every block's shared memory (distributed shared
// memory), then the cluster meets at one barrier (the scan) or each block
// waits for its bytes on an mbarrier (the dh loops, dh_cluster.cuh).
#pragma once

#include <map>
#include <tuple>

#include "hopper.cuh"

namespace sse {

constexpr int kMaxCluster = 8;  // the portable cluster size

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The cluster barrier, split in two: every thread of every block arrives
// (release: its earlier shared-memory writes, local and remote, are
// visible to the cluster once the barrier completes), then waits
// (acquire). It orders a block's own threads too, as __syncthreads does.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// 16 bytes `v` to the offset of this block's shared memory at `p` in the
// shared memory of block `rank` of the cluster (every block has the same
// layout), as st.async: the store completes on the mbarrier at `bar`'s
// offset in block `rank` (its transaction count drops by 16), which gives
// the store release semantics at cluster scope; the sender does not wait.
__device__ __forceinline__ void put_async_to_rank(const void* p, const uint4& v,
                                                  const uint64_t* bar, int rank) {
  uint32_t remote, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}
// Wait for the completion of the phase of parity `parity` of this block's
// mbarrier `bar`, acquiring at cluster scope what other blocks' st.async
// released on it (mbar_wait's trap after 2^24 polls: a broken protocol
// fails the launch instead of hanging the card).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// 16 bytes from this block's shared memory at `p` to the same offset in
// the shared memory of block `rank` of the cluster (every block has the
// same layout).
__device__ __forceinline__ void copy_to_rank(const void* p, int rank) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The cluster launch of `kernel` as clusters of C blocks of `threads`
// threads and `smem` bytes of dynamic shared memory, the kernel's dynamic
// shared memory allowed up to the opt-in most (once per kernel and card:
// the bytes vary with the shapes).
template <typename... Params>
cudaError_t cluster_config(void (*kernel)(Params...), int blocks, int threads, int smem, int C,
                           cudaStream_t st, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (const cudaError_t err = allow_smem((const void*)kernel, 232448); err != cudaSuccess)
    return err;
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of C blocks of `kernel` (`threads` threads, `smem`
// bytes) the current card holds at once, from the occupancy calculator
// (cudaOccupancyMaxActiveClusters), asked once per (kernel, card, C,
// threads, bytes) and kept: the first launch of a shape asks it, in the
// eager warm-up, and a capture that follows finds it kept.
template <typename... Params>
cudaError_t max_active_clusters(void (*kernel)(Params...), int threads, int smem, int C, int* n) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, int> known;
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess) return err;
  const auto key = std::make_tuple((const void*)kernel, dev, C, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  if (const auto it = known.find(key); it != known.end()) {
    *n = it->second;
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (const cudaError_t err = cluster_config(kernel, C, threads, smem, C, 0, &cfg, attr);
      err != cudaSuccess)
    return err;
  if (const cudaError_t err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg); err != cudaSuccess)
    return err;
  known[key] = *n;
  return cudaSuccess;
}

// Launch `kernel` as clusters of C blocks along x (C <= kMaxCluster;
// `blocks` a multiple of C) on `st`. Returns cudaErrorInvalidConfiguration,
// before anything runs, where not one such cluster fits the card
// (max_active_clusters). A cluster launch on a stream is captured into a
// CUDA graph like any other.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int blocks, int threads, int smem, int C,
                           cudaStream_t st, Args... args) {
  int n = 0;
  if (const cudaError_t err = max_active_clusters(kernel, threads, smem, C, &n);
      err != cudaSuccess)
    return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (const cudaError_t err = cluster_config(kernel, blocks, threads, smem, C, st, &cfg, attr);
      err != cudaSuccess)
    return err;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace sse
