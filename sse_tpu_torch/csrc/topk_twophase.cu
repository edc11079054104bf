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
//     product.
// The exactness proof at fused_topk.py:573-584 needs ties in the block
// ranking to go to the earlier block (the composite's low word is
// 0xFFFFFFFF - block) and phase 1's block maxima to be the very numbers
// phase 2 keys on: for bf16 and int8 indexes both phases score through
// score_tile (topk_tile.cuh), one wgmma product, summed in one order.
//
// What bounds it on the H100 (B = 4096, 1,249,280 x 128 bf16 rows):
// phase 1 is 1.31 TFLOP against 320 MB — compute-bound; its only
// per-score work beyond the product is one max. The design:
//   * index tiles of 128 rows come by TMA into a 4-stage ring (full and
//     empty mbarriers, one producer warp);
//   * four consumer warpgroups, 64 queries each, share every tile: 256
//     queries per load of the index, so L2 → SM traffic is B / 256 x
//     320 MB (5 GB at B = 4096; the mma.sync kernel it replaces loaded
//     each index byte 4 times per 64 queries, 82 GB);
//   * the grid is (B / 256 query groups) x (splits of the blocks), with
//     CTA (g, s) walking blocks s, s + splits, ...: the CTAs that run
//     together read the same blocks, once from HBM, the rest from L2;
//   * the queries stay in shared memory for the whole walk, and the
//     block max is the epilogue: a running max in registers over a
//     block's tiles, one reduction over the 4 lanes of a row, one key.
// Phase 2 re-scores B·k·block_t rows (~1/60 of phase 1 at block_t = 2048)
// and is bound by the selection: a CTA takes one tile of 64 (query,
// block) pairs, streams the block through the same ring and the same
// score tile, and each warp selects for its own 16 queries with no
// block-wide barrier: 32-bit candidates (key | 4095 - local row; the
// packed keys' low 12 bits are free) above the query's threshold go to a
// per-query list in shared memory, merged (warp-wide top-k) only when the
// list could overflow or to seed the threshold after the first tile.
// A float32 index keeps the mma-free FMA kernels (no tensor-core product
// keeps fp32 operands): blockmax_kernel and range_topk.
#include "topk_tile.cuh"

namespace {

using namespace sse;

// ------------------------------------------------------------ float32 path
template <int MT>
__global__ void __launch_bounds__(128)
    blockmax_kernel(const void* q, const void* emb, int B, int T, int D,
                    const int* __restrict__ num_real, int block_t, int nblocks, int blocks_per_cta,
                    long long* out) {
  constexpr int QB = 16 * MT, NT = 2 * MT, NW = 8 * NT;
  __shared__ int smax[QB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3, g = lane >> 2;
  const int mi = warp % MT, cg = warp / MT;
  const int qbase = blockIdx.x * QB;
  const int b_lo = blockIdx.y * blocks_per_cta, b_hi = min(nblocks, b_lo + blocks_per_cta);
  const int ql0 = mi * 16 + g, ql1 = ql0 + 8;
  const float* qf = static_cast<const float*>(q);
  const float* p0 = qbase + ql0 < B ? qf + (size_t)(qbase + ql0) * D : nullptr;
  const float* p1 = qbase + ql1 < B ? qf + (size_t)(qbase + ql1) * D : nullptr;
  for (int i = tid; i < QB; i += blockDim.x) smax[i] = INT_MIN;
  __syncthreads();
  const int lim = max(0, min(T, *num_real));

  for (int blk = b_lo; blk < b_hi; ++blk) {
    const int rs = blk * block_t, re = min(rs + block_t, lim);
    float m0 = 0, m1 = 0;
    bool v0 = false, v1 = false;
    for (int row0 = rs; row0 < re; row0 += kTileRows) {
      const int rbase = row0 + cg * NW;
      float acc[NT][4];
      score_f32<NT>(p0, p1, static_cast<const float*>(emb), D, T, rbase, tig, acc);
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

__global__ void __launch_bounds__(128)
    pairs_kernel(const void* q, const void* emb, int B, int T, int D,
                 const int* __restrict__ num_real, int block_t, const int* tile_query,
                 const int* tile_block, int k, long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, blk = tile_block[tile];
  long long* o = out + (size_t)tile * 64 * k;
  if (blk < 0) {
    for (int i = threadIdx.x; i < 64 * k; i += blockDim.x) o[i] = kEmpty;
    return;
  }
  range_topk<4>(static_cast<const float*>(q), tile_query + (size_t)tile * 64, 0, B,
                static_cast<const float*>(emb), D, T, max(0, *num_real), blk * block_t,
                blk * block_t + block_t, k, o, k, smem);
}

// ------------------------------------------------- bf16 / int8: wgmma path
constexpr int kP1Groups = 4;                    // consumer warpgroups of phase 1
constexpr int kP1Queries = 64 * kP1Groups;      // queries sharing each index tile
constexpr int kP1Threads = 128 * kP1Groups + 32;
constexpr int kP1Stages = 4;
constexpr int kP2Threads = 128 + 32;
constexpr int kP2Stages = 3;
constexpr int kCap = 256;                       // candidate list of a query (phase 2)
constexpr int kNoCand = INT_MIN;                // below every 32-bit candidate
constexpr int kMaxBlockT = kIdxMask + 1;        // local rows fit the candidate's 12 bits

// 128-row tiles of block blk that hold a row below lim.
__device__ __forceinline__ int block_tiles(int blk, int block_t, int lim) {
  const int rs = blk * block_t;
  return rs >= lim ? 0 : (min(block_t, lim - rs) + kTileN - 1) / kTileN;
}

// Phase 1. CTA (blockIdx.x % nqg, blockIdx.x / nqg) = (query group of
// 256, split): writes out[q, blk] for its queries and the blocks blk =
// split, split + splits, ... over the rows below lim = clamp(*num_real, 0,
// T), read from device memory. Warps 0-15: four consumer warpgroups;
// warp 16: the TMA producer.
template <int DT, int RB>
__global__ void __launch_bounds__(kP1Threads, 1)
    wg_blockmax_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap emap, int B, int T,
                       const int* __restrict__ num_real, int block_t, int nblocks, int nqg,
                       int splits, long long* out) {
  constexpr int KS = RB / 32, CB = chunk_bytes(RB), CH = RB / CB;
  constexpr int kAChunk = kP1Queries * CB;  // one chunk of the queries
  constexpr int kStage = kTileN * RB;
  using AccT = typename Acc<DT>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = align1024(smem_raw);
  unsigned char* ring = sa + CH * kAChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kP1Stages * kStage);
  uint64_t* empty = full + kP1Stages;
  uint64_t* abar = empty + kP1Stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = blockIdx.x % nqg, split = blockIdx.x / nqg;
  const int lim = max(0, min(T, *num_real));
  if (tid == 0) {
    for (int s = 0; s < kP1Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kP1Groups);
    }
    mbar_init(abar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kP1Groups) {  // producer
    if (lane == 0) {
      mbar_expect_tx(abar, CH * kAChunk);
      for (int c = 0; c < CH; ++c)
        tma_load(sa + c * kAChunk, &qmap, abar, c * CB, qg * kP1Queries);
      int it = 0;
      for (int blk = split; blk < nblocks; blk += splits) {
        const int nt = block_tiles(blk, block_t, lim);
        for (int i = 0; i < nt; ++i, ++it) {
          const int s = it % kP1Stages;
          mbar_wait(&empty[s], ((it / kP1Stages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStage);
          for (int c = 0; c < CH; ++c)
            tma_load(ring + s * kStage + c * kTileN * CB, &emap, &full[s], c * CB,
                     blk * block_t + i * kTileN);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  const uint32_t a_addr = smem_addr(sa) + wg * 64 * CB, r_addr = smem_addr(ring);
  const int q0 = qg * kP1Queries + 16 * warp + g, q1 = q0 + 8;
  mbar_wait(abar, 0);
  AccT acc[64];
  int it = 0;
  for (int blk = split; blk < nblocks; blk += splits) {
    const int nt = block_tiles(blk, block_t, lim);
    AccT m0 = lowest<AccT>(), m1 = lowest<AccT>();
    for (int i = 0; i < nt; ++i, ++it) {
      const int s = it % kP1Stages;
      mbar_wait(&full[s], (it / kP1Stages) & 1);
      score_tile<DT, KS, CB>(acc, a_addr, kAChunk, r_addr + s * kStage, kTileN * CB);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      const int nvalid = lim - (blk * block_t + i * kTileN);  // rows of the tile below lim
      if (nvalid >= kTileN) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          m0 = vmax(m0, vmax(acc[4 * j], acc[4 * j + 1]));
          m1 = vmax(m1, vmax(acc[4 * j + 2], acc[4 * j + 3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (8 * j + 2 * tig + (c & 1) >= nvalid) continue;
            if (c >> 1)
              m1 = vmax(m1, acc[4 * j + c]);
            else
              m0 = vmax(m0, acc[4 * j + c]);
          }
      }
    }
    // every row of a block with a tile has a lane that saw a real row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = vmax(m0, __shfl_xor_sync(kFull, m0, off));
      m1 = vmax(m1, __shfl_xor_sync(kFull, m1, off));
    }
    if (tig == 0) {
      if (q0 < B) out[(size_t)q0 * nblocks + blk] = nt ? make_comp(enc_key(m0), blk) : kEmpty;
      if (q1 < B) out[(size_t)q1 * nblocks + blk] = nt ? make_comp(enc_key(m1), blk) : kEmpty;
    }
  }
}

// One warp: the k best of the query's n candidates (unique 32-bit
// values) to the front of its list, best first; count and threshold
// updated (the threshold stays kNoCand while fewer than k are known).
__device__ __forceinline__ void warp_merge(int* list, int* cnt, int* thr, int k, int lane) {
  const int n = *cnt;
  int v[kCap / 32];
#pragma unroll
  for (int i = 0; i < kCap / 32; ++i) v[i] = lane + 32 * i < n ? list[lane + 32 * i] : kNoCand;
  __syncwarp();
  const int kk = min(n, k);
  int prev = INT_MAX;
  for (int r = 0; r < kk; ++r) {
    int m = kNoCand;
#pragma unroll
    for (int i = 0; i < kCap / 32; ++i)
      if (v[i] < prev && v[i] > m) m = v[i];
    prev = __reduce_max_sync(kFull, m);
    if (lane == 0) list[r] = prev;
  }
  if (lane == 0) {
    *cnt = kk;
    *thr = n >= k ? prev : kNoCand;
  }
  __syncwarp();
}

// Phase 2. CTA t: the queries tile_query[64t ..] (negative = none, its
// slots end empty) against index block tile_block[t] (negative: the
// whole tile empty); writes each query's block-local top-k composites
// over the rows below lim = clamp(*num_real, 0, T).
// Warps 0-3: the consumer warpgroup (warp w owns queries 16w .. 16w+15,
// the rows its lanes hold in the accumulator); warp 4: the producer.
template <int DT, int RB>
__global__ void __launch_bounds__(kP2Threads, 1)
    wg_pairs_kernel(const unsigned char* __restrict__ q, const __grid_constant__ CUtensorMap emap,
                    int B, int T, const int* __restrict__ num_real, int block_t,
                    const int* __restrict__ tile_query, const int* __restrict__ tile_block, int k,
                    long long* __restrict__ out) {
  constexpr int KS = RB / 32, CB = chunk_bytes(RB), CH = RB / CB;
  constexpr int kAChunk = 64 * CB;  // one chunk of the queries
  constexpr int kStage = kTileN * RB;
  using AccT = typename Acc<DT>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sa = align1024(smem_raw);
  unsigned char* ring = sa + CH * kAChunk;
  int* buf = reinterpret_cast<int*>(ring + kP2Stages * kStage);  // [64][kCap]
  int* cnt = buf + 64 * kCap;
  int* thr = cnt + 64;
  int* qid = thr + 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(qid + 64);
  uint64_t* empty = full + kP2Stages;

  const int tile = blockIdx.x, blk = tile_block[tile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long long* o = out + (size_t)tile * 64 * k;
  const int lim = max(0, min(T, *num_real));
  const int nt = blk < 0 ? 0 : block_tiles(blk, block_t, lim);
  if (nt == 0) {
    for (int i = tid; i < 64 * k; i += blockDim.x) o[i] = kEmpty;
    return;
  }
  const int rs = blk * block_t;
  if (tid == 0) {
    for (int s = 0; s < kP2Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  if (tid < 64) {
    const int id = tile_query[(size_t)tile * 64 + tid];
    qid[tid] = id >= 0 && id < B ? id : -1;
    cnt[tid] = 0;
    thr[tid] = kNoCand;
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0)
      for (int i = 0; i < nt; ++i) {
        const int s = i % kP2Stages;
        mbar_wait(&empty[s], ((i / kP2Stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStage);
        for (int c = 0; c < CH; ++c)
          tma_load(ring + s * kStage + c * kTileN * CB, &emap, &full[s], c * CB,
                   rs + i * kTileN);
      }
    return;
  }

  // the 64 query rows, gathered into the swizzled layout (a zero row for
  // a missing query), while the producer's first tiles are in flight
  for (int x = tid; x < 64 * (RB / 16); x += 128) {
    const int r = x / (RB / 16), j = x % (RB / 16), id = qid[r];
    cp_async16(sa + j / (CB / 16) * kAChunk + swz<CB>(r, j % (CB / 16)),
               q + (size_t)max(id, 0) * RB + 16 * j, id >= 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  const int g = lane >> 2, tig = lane & 3;
  const int ql0 = 16 * warp + g, ql1 = ql0 + 8;
  const bool v0 = qid[ql0] >= 0, v1 = qid[ql1] >= 0;
  int* l0 = buf + ql0 * kCap;
  int* l1 = buf + ql1 * kCap;
  int t0 = kNoCand, t1 = kNoCand;  // register copies of thr[ql0], thr[ql1]
  const uint32_t a_addr = smem_addr(sa), r_addr = smem_addr(ring);
  AccT acc[64];
  for (int i = 0; i < nt; ++i) {
    const int s = i % kP2Stages;
    mbar_wait(&full[s], (i / kP2Stages) & 1);
    score_tile<DT, KS, CB>(acc, a_addr, kAChunk, r_addr + s * kStage, kTileN * CB);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    const int lr0 = i * kTileN, nvalid = lim - rs - lr0;
    // candidate of slot (j, c): key | (4095 - local row); kNoCand past lim
    auto cand = [&](int j, int c) {
      const int col = 8 * j + 2 * tig + (c & 1);
      return col < nvalid ? (enc_key(acc[4 * j + c]) | (kIdxMask - (lr0 + col))) : kNoCand;
    };
    int n0 = 0, n1 = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int x = cand(j, c);
        if (c >> 1)
          n1 += x > t1;
        else
          n0 += x > t0;
      }
    n0 = v0 ? n0 : 0;
    n1 = v1 ? n1 : 0;
    if (n0 | n1) {
      int p0 = n0 ? atomicAdd(&cnt[ql0], n0) : 0, p1 = n1 ? atomicAdd(&cnt[ql1], n1) : 0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int x = cand(j, c);
          if (c >> 1) {
            if (n1 && x > t1) l1[p1++] = x;
          } else if (n0 && x > t0) {
            l0[p0++] = x;
          }
        }
    }
    __syncwarp();
    // a list that could overflow on the next tile, or the first k
    // candidates of a query (its threshold): merge, warp-wide
    auto needs = [&](int ql) {
      const int n = cnt[ql];
      return n > kCap - kTileN || (thr[ql] == kNoCand && n >= k);
    };
    const unsigned m0 = __ballot_sync(kFull, tig == 0 && needs(ql0));
    const unsigned m1 = __ballot_sync(kFull, tig == 0 && needs(ql1));
    if (m0 | m1) {
      for (unsigned m = m0; m; m &= m - 1) {
        const int ql = 16 * warp + ((__ffs(m) - 1) >> 2);
        warp_merge(buf + ql * kCap, &cnt[ql], &thr[ql], k, lane);
      }
      for (unsigned m = m1; m; m &= m - 1) {
        const int ql = 16 * warp + 8 + ((__ffs(m) - 1) >> 2);
        warp_merge(buf + ql * kCap, &cnt[ql], &thr[ql], k, lane);
      }
      t0 = thr[ql0];
      t1 = thr[ql1];
    }
  }
  for (int j = 0; j < 16; ++j) {
    const int ql = 16 * warp + j;
    warp_merge(buf + ql * kCap, &cnt[ql], &thr[ql], k, lane);
    const int n = cnt[ql];
    for (int r = lane; r < k; r += 32) {
      const int x = r < n ? buf[ql * kCap + r] : kNoCand;
      o[(size_t)ql * k + r] =
          x == kNoCand ? kEmpty : make_comp(x & ~kIdxMask, rs + kIdxMask - (x & kIdxMask));
    }
  }
}

// ------------------------------------------------------------- host side
constexpr int p1_smem(int rb) {
  return 1024 + kP1Queries * rb + kP1Stages * kTileN * rb + (2 * kP1Stages + 1) * 8;
}
constexpr int p2_smem(int rb) {
  return 1024 + 64 * rb + kP2Stages * kTileN * rb + 64 * kCap * 4 + 3 * 64 * 4 +
         2 * kP2Stages * 8;
}

template <int DT, int RB>
int blockmax_wg(const void* q, const void* emb, int B, int T, const int* num_real, int block_t,
                int nblocks, long long* out, cudaStream_t st) {
  CUtensorMap qmap, emap;
  int err = row_map(&qmap, q, B, RB, kP1Queries, chunk_bytes(RB));
  if (!err) err = row_map(&emap, emb, T, RB, kTileN, chunk_bytes(RB));
  if (err) return err;
  auto fn = wg_blockmax_kernel<DT, RB>;
  if (const cudaError_t e = allow_smem(reinterpret_cast<const void*>(fn), p1_smem(RB));
      e != cudaSuccess)
    return (int)e;
  const int nqg = (B + kP1Queries - 1) / kP1Queries;
  const int splits = max(1, min(nblocks, num_sms() / nqg));
  fn<<<nqg * splits, kP1Threads, p1_smem(RB), st>>>(qmap, emap, B, T, num_real, block_t, nblocks,
                                                     nqg, splits, out);
  return (int)cudaGetLastError();
}

template <int DT, int RB>
int pairs_wg(const void* q, const void* emb, int B, int T, const int* num_real, int block_t,
             int ntile, const int* tile_query, const int* tile_block, int k, long long* out,
             cudaStream_t st) {
  CUtensorMap emap;
  if (int err = row_map(&emap, emb, T, RB, kTileN, chunk_bytes(RB))) return err;
  auto fn = wg_pairs_kernel<DT, RB>;
  if (const cudaError_t e = allow_smem(reinterpret_cast<const void*>(fn), p2_smem(RB));
      e != cudaSuccess)
    return (int)e;
  fn<<<ntile, kP2Threads, p2_smem(RB), st>>>(static_cast<const unsigned char*>(q), emap, B, T,
                                             num_real, block_t, tile_query, tile_block, k, out);
  return (int)cudaGetLastError();
}

using BlockmaxFn = int (*)(const void*, const void*, int, int, const int*, int, int, long long*,
                           cudaStream_t);
using PairsFn = int (*)(const void*, const void*, int, int, const int*, int, int, const int*,
                        const int*, int, long long*, cudaStream_t);

// The instances for a bf16 / int8 index (dt) with rows of rb bytes;
// nullptr for another width.
template <int DT>
BlockmaxFn blockmax_for(int rb) {
  return rb == 64 ? blockmax_wg<DT, 64>
                  : rb == 128 ? blockmax_wg<DT, 128> : rb == 256 ? blockmax_wg<DT, 256> : nullptr;
}
template <int DT>
PairsFn pairs_for(int rb) {
  return rb == 64 ? pairs_wg<DT, 64>
                  : rb == 128 ? pairs_wg<DT, 128> : rb == 256 ? pairs_wg<DT, 256> : nullptr;
}

int row_bytes(int dt, int D) { return D * (dt == kBF16 ? 2 : 1); }

}  // namespace

// Phase 1: out int64 [B, nblocks], one composite (block-max key, block)
// per query and block; kEmpty for a block with no row below num_real
// (one int32 in device memory, clamped to [0, T] by the kernels).
// bf16 / int8 need rows of 64, 128 or 256 bytes and block_t % 128 == 0;
// qb and blocks_per_cta shape the float32 kernel's grid only.
extern "C" int sse_twophase_blockmax(const void* q, const void* emb, int dt, int B, int T, int D,
                                     const void* num_real, int block_t, int nblocks, int qb,
                                     int blocks_per_cta, void* out, void* stream) {
  const int* nr = static_cast<const int*>(num_real);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  if (B == 0 || nblocks == 0) return 0;
  if (dt != kF32) {
    const BlockmaxFn fn =
        dt == kBF16 ? blockmax_for<kBF16>(row_bytes(dt, D)) : blockmax_for<kI8>(row_bytes(dt, D));
    if (fn == nullptr || block_t % kTileN || (long long)nblocks * block_t > T)
      return (int)cudaErrorInvalidValue;
    return fn(q, emb, B, T, nr, block_t, nblocks, o, st);
  }
  const int MT = qb / 16;
  if ((MT != 1 && MT != 4) || block_t % kTileRows) return (int)cudaErrorInvalidValue;
  const void* fn = MT == 1 ? (const void*)blockmax_kernel<1> : (const void*)blockmax_kernel<4>;
  void* args[] = {&q, &emb, &B, &T, &D, &num_real, &block_t, &nblocks, &blocks_per_cta, &out};
  const dim3 grid((B + qb - 1) / qb, (nblocks + blocks_per_cta - 1) / blocks_per_cta);
  cudaError_t err = cudaLaunchKernel(fn, grid, dim3(32 * kWarps), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Phase 2: tile t scores queries tile_query[64t .. 64t+63] (negative =
// none) against index block tile_block[t] (negative = skip); out int64
// [ntile·64, k], each pair's block-local top-k composites; num_real as in
// phase 1. bf16 / int8 need rows of 64, 128 or 256 bytes, block_t % 128 ==
// 0 and block_t <= 4096.
extern "C" int sse_twophase_pairs(const void* q, const void* emb, int dt, int B, int T, int D,
                                  const void* num_real, int block_t, int ntile,
                                  const void* tile_query, const void* tile_block, int k, void* out,
                                  void* stream) {
  const int* nr = static_cast<const int*>(num_real);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  const int* tq = static_cast<const int*>(tile_query);
  const int* tb = static_cast<const int*>(tile_block);
  long long* o = static_cast<long long*>(out);
  if (dt != kF32) {
    const PairsFn fn =
        dt == kBF16 ? pairs_for<kBF16>(row_bytes(dt, D)) : pairs_for<kI8>(row_bytes(dt, D));
    if (fn == nullptr || block_t % kTileN || block_t > kMaxBlockT) return (int)cudaErrorInvalidValue;
    return ntile == 0 ? 0 : fn(q, emb, B, T, nr, block_t, ntile, tq, tb, k, o, st);
  }
  if (ntile == 0) return 0;
  const void* fn = (const void*)pairs_kernel;
  const int smem = range_topk_smem(64, k);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q, &emb, &B, &T, &D, &num_real, &block_t, &tile_query, &tile_block, &k, &out};
  err = cudaLaunchKernel(fn, dim3(ntile), dim3(32 * kWarps), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
