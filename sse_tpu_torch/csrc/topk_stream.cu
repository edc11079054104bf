// Streaming exact top-k of q·embᵀ for Hopper (sm_90a), and the warp
// top-k select that merges partial lists.
//
// Replaces sse_tpu/ops/fused_topk.py:fused_score_topk(variant="packed")
// → _packed_kernel (with _packed_group_body, _consolidate_group and
// _packed_extract). Same contract: packed keys (11-bit float keys, exact
// int8 keys), ties to the lower global row, rows >= num_real never chosen,
// slots past the last real row hold finite sinks with row 0.
//
// Design. The grid is (query tiles of QB = 16 or 64 rows) x (splits
// of the index rows); each block keeps a running top-k of its queries over
// its split (range_topk in topk_common.cuh) and writes it to
// partial [B, splits, k]. sse_topk_select then merges the splits·k
// candidates of each query with one warp. Blocks run in no order, so
// this second pass is the cross-block reduction the TPU's sequential grid
// did not need. Nothing of size [B, T] is ever written to HBM.
//
// What bounds it on the H100 (index 1,249,280 x 128 bf16 = 320 MB):
//   * B = 8: 2.6 GFLOP against 320 MB read, ~8 flop/B — far below the
//     ~295 flop/B ridge, so bandwidth-bound: the splits put ~4 blocks per
//     SM in flight, each warp issues its tile's loads before its mma.sync;
//   * B = 256: 82 GFLOP, ~256 flop/B — near the ridge; query tiles of 64
//     rows keep the A fragments in registers for the whole split;
//   * B = 4096 would be 1.31 TFLOP against 320 MB (compute-bound); the
//     engine sends such batches to the two-phase kernels instead.
#include "topk_common.cuh"

namespace {

using namespace sse;

template <int DT, int KS, int MT>
__global__ void __launch_bounds__(128)
    topk_stream_kernel(const void* q, const void* emb, int B, int T, int D, int num_real, int k,
                       int splits, int rows_per_split, long long* partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qbase = blockIdx.x * 16 * MT, split = blockIdx.y;
  const int lo = split * rows_per_split;
  range_topk<DT, KS, MT>(q, nullptr, qbase, B, emb, D, T, num_real, lo, lo + rows_per_split, k,
                         partial + ((size_t)qbase * splits + split) * k, (long long)splits * k,
                         smem);
}

constexpr int kNegSink = (int)0x809E4000;  // sortable key of -3e38, low 12 bits cleared
constexpr float kNeg = -3.0e38f;
constexpr float kInt8Inv = 0x1.040c2p-14f;  // float32(1 / 127²)

__device__ __forceinline__ float from_sortable(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7FFFFFFF));
}

// One warp per row of `in` [R, n]: the k largest composites, best first.
// mode 0 writes composites; mode 1 (float keys) / 2 (int8 keys) decodes
// them into (value, row) as sse_tpu's _dec_val does, sinks for empties.
__global__ void __launch_bounds__(128)
    topk_select_kernel(const long long* __restrict__ in, int R, int n, int k, int mode,
                       long long* out_comp, float* vals, int* rows) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= R) return;
  const long long* src = in + (size_t)r * n;
  long long prev = kFull64;
  for (int j = 0; j < k; ++j) {
    long long m = kEmpty;
    for (int i = lane; i < n; i += 32) {
      const long long x = src[i];
      if (x < prev && x > m) m = x;
    }
    m = warp_max_i64(m);
    prev = m;
    if (lane != 0) continue;
    const size_t o = (size_t)r * k + j;
    if (mode == 0) {
      out_comp[o] = m;
      continue;
    }
    const int key = (int)(m >> 32);
    const bool empty = m == kEmpty;
    rows[o] = empty ? 0 : (int)(0xFFFFFFFFu - (unsigned)(m & 0xFFFFFFFFLL));
    if (mode == 1)
      vals[o] = from_sortable(empty ? kNegSink : key);
    else
      vals[o] = empty ? kNeg : (float)(key >> 12) * kInt8Inv;
  }
}

template <int DT, int KS>
const void* stream_fn(int MT) {
  return MT == 1 ? (const void*)topk_stream_kernel<DT, KS, 1>
                 : (const void*)topk_stream_kernel<DT, KS, 4>;
}

const void* stream_pick(int dt, int ks, int MT) {
  if (dt == kF32) return stream_fn<kF32, 1>(MT);
  if (dt == kBF16) return ks == 4 ? stream_fn<kBF16, 4>(MT) : stream_fn<kBF16, 8>(MT);
  return ks == 4 ? stream_fn<kI8, 4>(MT) : stream_fn<kI8, 8>(MT);
}

}  // namespace

// partial: int64 [B, splits, k]. qb: queries per block (16 or 64).
// dt: 0 float32, 1 bfloat16, 2 int8; bf16/int8 rows must be 128 or 256 B.
extern "C" int sse_topk_stream(const void* q, const void* emb, int dt, int B, int T, int D,
                               int num_real, int k, int qb, int splits, int rows_per_split,
                               void* partial, void* stream) {
  const int MT = qb / 16;
  const int ks = dt == kF32 ? 1 : D * (dt == kBF16 ? 2 : 1) / 32;
  if ((MT != 1 && MT != 4) || (dt != kF32 && ks != 4 && ks != 8) || k < 1 || k > 128)
    return (int)cudaErrorInvalidValue;
  const void* fn = stream_pick(dt, ks, MT);
  const int smem = range_topk_smem(qb, k);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q, &emb, &B, &T, &D, &num_real, &k, &splits, &rows_per_split, &partial};
  err = cudaLaunchKernel(fn, dim3((B + qb - 1) / qb, splits), dim3(32 * kWarps), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// in: int64 [R, n] composites → the k best per row. mode as above.
extern "C" int sse_topk_select(const void* in, int R, int n, int k, int mode, void* out_comp,
                               void* vals, void* rows, void* stream) {
  if (R == 0) return 0;
  topk_select_kernel<<<(R + kWarps - 1) / kWarps, 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(in), R, n, k, mode, static_cast<long long*>(out_comp),
      static_cast<float*>(vals), static_cast<int*>(rows));
  return (int)cudaGetLastError();
}
