// The table gradient of an embedding lookup (embed_grad="take"), for
// Hopper (sm_90a): dt[v] = the float32 sum of dy's rows at every position
// whose token is v, zero for an id no token names.
//
// What it replaces: no TPU kernel. The JAX package leaves jnp.take's
// backward to XLA's scatter-add (sse_tpu/models/towers.py:597-600). On
// the card PyTorch's indexing backward gives one warp to each distinct id,
// which walks the id's rows one after another, so its time follows the
// longest run of one id: the pad id's thousands of rows a tower in QnA
// training.
//
// What bounds it on the H100: bytes. Every cotangent row is read once and
// every table row written once (at N = 115,200 tokens of 128 floats, 59 MB
// and 4 MB: ~0.02 ms at 3.35 TB/s); there are no products.
//
// Design: the work is cut by position in the sorted ids, not by id, so a
// run of any length is spread over as many warps as it fills.
//   * The wrapper (ops/embed.py) sorts the ids stably: `ids` sorted,
//     `order` the position of each in the token list. The order is a pure
//     function of the ids.
//   * embed_grad_chunk_kernel: one warp a chunk of kChunk sorted positions
//     (one a lane: the chunk's ids and row numbers come in one coalesced
//     load each and go round by shuffles), and a slice of 32·VEC columns
//     (a vector of VEC floats a lane). It loads kAhead rows before it adds
//     them, in order, into float32 registers. A run wholly inside the chunk
//     is written to its row of dt; a run that crosses the chunk's left or
//     right edge goes to the chunk's partial slot: slot 0 for the chunk's
//     first run, slot 1 for its last.
//   * embed_grad_merge_kernel: one block a chunk. The chunk in which a
//     crossing run starts sums its partials: its own, then slot 0 of each
//     chunk the run fills after it, in chunk order, cut into kMergeWarps
//     contiguous groups (a warp's sum each), the groups' sums added in
//     group order. Every other block returns at once.
//   * Ids no token names: the memset before the kernels.
// No atomics: the order of every sum is fixed by the ids alone, so the
// result has the same bits on every run, eager or in a replayed graph.
// ops/embed.py table_grad_reference repeats this order in plain PyTorch.
// Every buffer is sized from N, E and the vocab alone (capture-safe).
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace sse {
namespace {

constexpr int kChunk = 32;       // sorted positions a warp sums: one a lane
constexpr int kChunkWarps = 4;   // chunks a block of the chunk kernel
constexpr int kMergeWarps = 8;   // warps that sum one crossing run's partials
constexpr int kAhead = 8;        // rows a warp loads before it adds them

static_assert(kChunk == 32 && kChunk % kAhead == 0, "a lane holds one position of a chunk");

// VEC consecutive floats of a row, one lane's share of a slice.
template <int VEC>
struct Lanes {
  float v[VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.f;
  }
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (VEC == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
    }
  }
  __device__ __forceinline__ void load_shared(const float* p) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
  __device__ __forceinline__ void add(const Lanes& o) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __fadd_rn(v[i], o.v[i]);
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) p[i] = v[i];
    }
  }
};

// ids [N] int32 sorted, order [N] int64 (the row of dy each sorted
// position reads), dy [N, E] fp32 → dt rows of the runs inside a chunk,
// part [C, 2, E] fp32 the crossing runs' partial sums.
template <int VEC>
__global__ void __launch_bounds__(kChunkWarps * 32)
    embed_grad_chunk_kernel(const int* __restrict__ ids, const int64_t* __restrict__ order,
                            const float* __restrict__ dy, float* __restrict__ dt,
                            float* __restrict__ part, int N, int E) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kChunkWarps + (threadIdx.x >> 5);
  const int lo = c * kChunk;
  if (lo >= N) return;
  const int n = min(kChunk, N - lo);
  const int col = blockIdx.y * 32 * VEC + lane * VEC;
  const bool on = col < E;
  const int my_id = lane < n ? ids[lo + lane] : -1;
  const int64_t my_row = lane < n ? order[lo + lane] : 0;
  const int before = lo > 0 ? ids[lo - 1] : -1;
  const int after = lo + n < N ? ids[lo + n] : -1;
  const bool open_left = before == __shfl_sync(kFull, my_id, 0);
  float* const slot0 = part + static_cast<int64_t>(2 * c) * E + col;
  float* const slot1 = slot0 + E;

  Lanes<VEC> acc;
  acc.zero();
  int start = 0;  // the chunk position where the run being summed begins
  for (int j0 = 0; j0 < n; j0 += kAhead) {
    Lanes<VEC> r[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t row = __shfl_sync(kFull, my_row, j0 + u);
      if (on && j0 + u < n)
        r[u].load(dy + row * E + col);
      else
        r[u].zero();
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u;
      const int id = __shfl_sync(kFull, my_id, j);
      const int next_lane = __shfl_sync(kFull, my_id, (j + 1) & 31);
      if (j >= n) break;  // n is the warp's: no lane diverges
      const int next = j + 1 < n ? next_lane : after;
      acc.add(r[u]);
      if (next != id) {  // the run ends at j
        if (on) acc.store(start == 0 && open_left ? slot0 : dt + static_cast<int64_t>(id) * E + col);
        acc.zero();
        start = j + 1;
      }
    }
  }
  if (start < n && on) acc.store(start == 0 ? slot0 : slot1);  // it goes on past the chunk
}

// One block a chunk: the run that crosses the chunk's right edge and
// starts in it, if there is one, summed from the partials.
template <int VEC>
__global__ void __launch_bounds__(kMergeWarps * 32)
    embed_grad_merge_kernel(const int* __restrict__ ids, const float* __restrict__ part,
                            float* __restrict__ dt, int N, int E) {
  __shared__ __align__(16) float sums[kMergeWarps][32 * VEC];
  const int c = blockIdx.x, C = gridDim.x;
  const int lo = c * kChunk, hi = lo + kChunk;
  if (hi >= N) return;  // nothing crosses the last chunk's right edge
  const int x = ids[hi - 1];
  if (ids[hi] != x) return;                                  // its last run ends in it
  const bool whole = ids[lo] == x;                           // the run fills the chunk
  if (whole && lo > 0 && ids[lo - 1] == x) return;           // it began in an earlier chunk
  // m: the chunks after c whose first position holds x, c+1 .. c+m
  int m = 0;
  for (int base = c + 1;; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int got = __syncthreads_count(k < C && ids[static_cast<int64_t>(k) * kChunk] == x);
    m += got;
    if (got < static_cast<int>(blockDim.x)) break;
  }
  // partials 0..m: chunk c's slot (0 if the run fills it, else 1), then
  // slot 0 of chunks c+1 .. c+m
  const int n = m + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.y * 32 * VEC + lane * VEC;
  const bool on = col < E;
  const int a = static_cast<int>(static_cast<int64_t>(n) * warp / kMergeWarps);
  const int b = static_cast<int>(static_cast<int64_t>(n) * (warp + 1) / kMergeWarps);
  Lanes<VEC> s;
  s.zero();
  for (int i0 = a; i0 < b; i0 += kAhead) {
    Lanes<VEC> r[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + u;
      const int slot = i == 0 && !whole ? 1 : 0;
      if (on && i < b)
        r[u].load(part + (static_cast<int64_t>(2) * (c + i) + slot) * E + col);
      else
        r[u].zero();
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (i0 + u < b) s.add(r[u]);
  }
  if (on) s.store(&sums[warp][lane * VEC]);
  __syncthreads();
  if (warp == 0 && on) {
    Lanes<VEC> t;
    t.zero();
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) {
      Lanes<VEC> g;
      g.load_shared(&sums[w][lane * VEC]);
      t.add(g);
    }
    t.store(dt + static_cast<int64_t>(x) * E + col);
  }
}

template <int VEC>
cudaError_t launch(const int* ids, const int64_t* order, const float* dy, float* dt,
                   float* part, int N, int E, cudaStream_t st) {
  const int C = (N + kChunk - 1) / kChunk;
  const int slices = (E + 32 * VEC - 1) / (32 * VEC);
  embed_grad_chunk_kernel<VEC><<<dim3((C + kChunkWarps - 1) / kChunkWarps, slices),
                                 kChunkWarps * 32, 0, st>>>(ids, order, dy, dt, part, N, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  embed_grad_merge_kernel<VEC><<<dim3(C, slices), kMergeWarps * 32, 0, st>>>(ids, part, dt, N,
                                                                               E);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sse

// The table gradient [V, E] fp32 into dt: zeroed, then every id's rows of
// dy summed. ids [N] int32 sorted stably (each in [0, V)), order [N]
// int64 (their positions in the token list), dy [N, E] fp32, part
// [ceil(N / 32), 2, E] fp32 scratch; N >= 0, E >= 1; the fp32 pointers
// 16-byte aligned.
extern "C" int sse_embed_grad(const void* ids, const void* order, const void* dy, void* dt,
                              void* part, int N, int E, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dt, 0, static_cast<size_t>(V) * E * sizeof(float), st);
  if (err != cudaSuccess || N == 0) return err;
  const int* i = static_cast<const int*>(ids);
  const int64_t* o = static_cast<const int64_t*>(order);
  const float* g = static_cast<const float*>(dy);
  float* d = static_cast<float*>(dt);
  float* p = static_cast<float*>(part);
  return E % 4 == 0 ? sse::launch<4>(i, o, g, d, p, N, E, st)
                    : sse::launch<1>(i, o, g, d, p, N, E, st);
}
