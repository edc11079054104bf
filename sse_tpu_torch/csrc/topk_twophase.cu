// Two-phase exact top-k for large query batches, for Hopper (sm_90a).
//
// Replaces sse_tpu/ops/fused_topk.py:fused_score_topk_twophase's two
// Pallas kernels:
//   phase 1 → _blockmax_kernel: per query, the top-k index BLOCKS ranked by
//     (packed key of the block's max score desc, block asc). Here one
//     kernel writes every block's composite [B, nblocks] (the max is taken
//     on raw scores and encoded once; the key map is monotone) and
//     sse_topk_select (topk_stream.cu) keeps the k best per query — the
//     second pass that stands in for the TPU's running in-kernel buffer.
//   phase 2 → _pair_topk_kernel: re-scores only the chosen (query, block)
//     pairs and returns each pair's block-local top-k composites, empty
//     past num_real. The pairs arrive grouped by block in tiles of 64
//     queries (the plain-torch mid-pass), so each tile is one 64 x block_t
//     tensor-core product run through range_topk (topk_common.cuh).
// The exactness proof at fused_topk.py:573-584 needs only that ties in
// the block ranking go to the earlier block: the composite's low word is
// 0xFFFFFFFF - block.
//
// What bounds it on the H100 (B = 4096, 1,249,280 x 128 bf16 rows):
// phase 1 is 1.31 TFLOP against 320 MB — compute-bound, on mma.sync; its
// only per-score work beyond the product is one max. Phase 2 re-scores
// B·k·block_t rows (~1/60 of phase 1 at block_t = 2048).
#include "topk_common.cuh"

namespace {

using namespace sse;

template <int DT, int KS, int MT>
__global__ void __launch_bounds__(128)
    blockmax_kernel(const void* q, const void* emb, int B, int T, int D, int num_real,
                    int block_t, int nblocks, int blocks_per_cta, long long* out) {
  constexpr int QB = 16 * MT, NT = 2 * MT, NW = 8 * NT;
  constexpr int esz = DT == kF32 ? 4 : (DT == kBF16 ? 2 : 1);
  using AccT = typename Acc<DT>::type;
  __shared__ int smax[QB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mi = warp % MT, cg = warp / MT;
  const int qbase = blockIdx.x * QB;
  const int b_lo = blockIdx.y * blocks_per_cta, b_hi = min(nblocks, b_lo + blocks_per_cta);
  const int row_bytes = D * esz;
  const int ql0 = mi * 16 + g, ql1 = ql0 + 8;
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  const unsigned char* p0 = qbase + ql0 < B ? qb + (size_t)(qbase + ql0) * row_bytes : nullptr;
  const unsigned char* p1 = qbase + ql1 < B ? qb + (size_t)(qbase + ql1) * row_bytes : nullptr;
  uint32_t a[KS][4];
  if constexpr (DT != kF32) load_a<KS>(a, p0, p1, tig);
  for (int i = tid; i < QB; i += blockDim.x) smax[i] = INT_MIN;
  __syncthreads();
  const int lim = min(T, num_real);

  for (int blk = b_lo; blk < b_hi; ++blk) {
    const int rs = blk * block_t, re = min(rs + block_t, lim);
    AccT m0 = 0, m1 = 0;
    bool v0 = false, v1 = false;
    for (int row0 = rs; row0 < re; row0 += kTileRows) {
      const int rbase = row0 + cg * NW;
      AccT acc[NT][4];
      if constexpr (DT == kF32)
        score_f32<NT>(reinterpret_cast<const float*>(p0), reinterpret_cast<const float*>(p1),
                      static_cast<const float*>(emb), D, T, rbase, tig, acc);
      else
        score_mma<DT, KS, NT>(a, static_cast<const unsigned char*>(emb), row_bytes, T, rbase, g,
                              tig, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = rbase + 8 * j + 2 * tig + (c & 1);
          if (row >= re) continue;
          if (c >> 1) {
            m1 = v1 ? max(m1, acc[j][c]) : acc[j][c];
            v1 = true;
          } else {
            m0 = v0 ? max(m0, acc[j][c]) : acc[j][c];
            v0 = true;
          }
        }
    }
    int k0 = v0 ? enc_key(m0) : INT_MIN, k1 = v1 ? enc_key(m1) : INT_MIN;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      k0 = max(k0, __shfl_xor_sync(kFull, k0, off));
      k1 = max(k1, __shfl_xor_sync(kFull, k1, off));
    }
    if (tig == 0) {
      atomicMax(&smax[ql0], k0);
      atomicMax(&smax[ql1], k1);
    }
    __syncthreads();
    for (int i = tid; i < QB; i += blockDim.x) {
      const int v = smax[i];
      if (qbase + i < B)
        out[(size_t)(qbase + i) * nblocks + blk] = v == INT_MIN ? kEmpty : make_comp(v, blk);
      smax[i] = INT_MIN;
    }
    __syncthreads();
  }
}

template <int DT, int KS>
__global__ void __launch_bounds__(128)
    pairs_kernel(const void* q, const void* emb, int B, int T, int D, int num_real, int block_t,
                 const int* tile_query, const int* tile_block, int k, long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, blk = tile_block[tile];
  long long* o = out + (size_t)tile * 64 * k;
  if (blk < 0) {
    for (int i = threadIdx.x; i < 64 * k; i += blockDim.x) o[i] = kEmpty;
    return;
  }
  range_topk<DT, KS, 4>(q, tile_query + (size_t)tile * 64, 0, B, emb, D, T, num_real,
                        blk * block_t, blk * block_t + block_t, k, o, k, smem);
}

template <int DT, int KS>
const void* blockmax_fn(int MT) {
  return MT == 1 ? (const void*)blockmax_kernel<DT, KS, 1>
                 : (const void*)blockmax_kernel<DT, KS, 4>;
}

const void* blockmax_pick(int dt, int ks, int MT) {
  if (dt == kF32) return blockmax_fn<kF32, 1>(MT);
  if (dt == kBF16) return ks == 4 ? blockmax_fn<kBF16, 4>(MT) : blockmax_fn<kBF16, 8>(MT);
  return ks == 4 ? blockmax_fn<kI8, 4>(MT) : blockmax_fn<kI8, 8>(MT);
}

const void* pairs_pick(int dt, int ks) {
  if (dt == kF32) return (const void*)pairs_kernel<kF32, 1>;
  if (dt == kBF16)
    return ks == 4 ? (const void*)pairs_kernel<kBF16, 4> : (const void*)pairs_kernel<kBF16, 8>;
  return ks == 4 ? (const void*)pairs_kernel<kI8, 4> : (const void*)pairs_kernel<kI8, 8>;
}

int row_slices(int dt, int D) { return dt == kF32 ? 1 : D * (dt == kBF16 ? 2 : 1) / 32; }

}  // namespace

// Phase 1: out int64 [B, nblocks], one composite (block-max key, block)
// per query and block; kEmpty for a block with no row below num_real.
extern "C" int sse_twophase_blockmax(const void* q, const void* emb, int dt, int B, int T, int D,
                                     int num_real, int block_t, int nblocks, int qb,
                                     int blocks_per_cta, void* out, void* stream) {
  const int MT = qb / 16, ks = row_slices(dt, D);
  if ((MT != 1 && MT != 4) || (dt != kF32 && ks != 4 && ks != 8) ||
      block_t % kTileRows)
    return (int)cudaErrorInvalidValue;
  const void* fn = blockmax_pick(dt, ks, MT);
  void* args[] = {&q, &emb, &B, &T, &D, &num_real, &block_t, &nblocks, &blocks_per_cta, &out};
  const dim3 grid((B + qb - 1) / qb, (nblocks + blocks_per_cta - 1) / blocks_per_cta);
  cudaError_t err = cudaLaunchKernel(fn, grid, dim3(32 * kWarps), args, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Phase 2: tile t scores queries tile_query[64t .. 64t+63] (negative =
// none) against index block tile_block[t] (negative = skip); out int64
// [ntile·64, k], each pair's block-local top-k composites.
extern "C" int sse_twophase_pairs(const void* q, const void* emb, int dt, int B, int T, int D,
                                  int num_real, int block_t, int ntile, const void* tile_query,
                                  const void* tile_block, int k, void* out, void* stream) {
  const int ks = row_slices(dt, D);
  if ((dt != kF32 && ks != 4 && ks != 8) || k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  if (ntile == 0) return 0;
  const void* fn = pairs_pick(dt, ks);
  const int smem = range_topk_smem(64, k);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q, &emb, &B, &T, &D, &num_real, &block_t, &tile_query, &tile_block, &k, &out};
  err = cudaLaunchKernel(fn, dim3(ntile), dim3(32 * kWarps), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
