// Streaming top-k of q·embᵀ for Hopper (sm_90a), both variants, and the
// warp top-k select that merges partial lists.
//
// Replaces sse_tpu/ops/fused_topk.py:fused_score_topk:
//   variant="packed" → _packed_kernel (with _packed_group_body,
//     _consolidate_group and _packed_extract): packed keys (11-bit float
//     keys, exact int8 keys), slots past the last real row hold finite
//     sinks with row 0;
//   variant="exact" → _kernel + _topk_passes: full-precision float32
//     scores (int8: float(int32 sum) / 127²), empty slots hold exactly
//     float32(-3e38) with row 0.
// Both: ties to the lower global row, rows >= num_real never chosen.
// The exact variant is the same kernel with another key (EX, see
// topk_common.cuh): the JAX kernel's k (max, index-min, mask) passes over
// a [B, block_t] VMEM tile are how a sequential TPU grid selects; the
// int64 composite (key << 32 | ~row) already orders (key desc, row asc),
// and with all 32 key bits it is exact.
//
// Design (bf16 and int8 indexes, wg_stream_kernel). The grid is (query
// groups of 64·G queries) x (splits of the index's 128-row tiles); CTA
// (group, split) walks tiles split, split + splits, ..., so the CTAs of
// all query groups that run together read the same tiles (once from HBM,
// the rest from L2), and writes its queries' k best over those tiles to
// partial [B, splits, k]; sse_topk_select then merges the splits·k
// candidates of each query (the cross-block reduction that the TPU's
// sequential grid did not need). Nothing of size [B, T] is ever written.
//   * Scores: index tiles come by TMA into a ring of `stages` stages (full
//     and empty mbarriers, one producer warp); G consumer warpgroups, 64
//     queries each, held in shared memory for the whole walk, score every
//     tile through score_tile (topk_tile.cuh) — the two-phase kernels'
//     product, so both routes select on the same float32 scores. Row j of
//     warp w holds the group's query j·W + w (W warps), so a small batch's
//     queries, and its selection work, spread over every warp.
//   * Selection is warp-local, with no block-wide barrier: each warp
//     selects for the 16 query rows its lanes hold in the accumulator. A
//     row keeps a threshold key t in registers, as the raw accumulator
//     value it maps to (raw_thr), so the common tile costs one compare a
//     score and one warp vote. A score above it goes, as its raw bits and
//     its row, to the row's list of `cap` (>= k + 64) entries in shared
//     memory (the key is made only when the list merges); a warp merge
//     (warp_merge: bisection, whatever k) keeps the k best when the list
//     could not take the next tile (or half tile), or once the row has k
//     candidates (its first threshold). A CTA's rows only grow along its
//     walk, so a later score whose key equals t loses every tie: `key > t`
//     is the exact test.
//   * G, the stages and cap are the host's (ops/topk.py _stream_plan): the
//     ring, the queries and the lists share 227 KB.
// What bounds it on the H100 (index 1,249,280 x 128 bf16 = 320 MB): B = 8
// is 2.6 GFLOP against 320 MB (~8 flop/B, far below the ~295 flop/B
// ridge): bandwidth, so the ring keeps 3-4 tiles (up to 128 KB) in flight
// on every SM. B = 4096 is 1.31 TFLOP (compute): each tile feeds 64·G
// queries, and the tiles the query groups share come from L2. Measured,
// the selection (16 rows a warp) bounds it from B = 256 up.
//
// A float32 index keeps range_topk (topk_common.cuh; no tensor-core
// product keeps fp32 operands): topk_stream_kernel.
#include "topk_tile.cuh"

namespace {

using namespace sse;

// ------------------------------------------------------------ float32 path
template <int MT, bool EX>
__global__ void __launch_bounds__(128)
    topk_stream_kernel(const void* q, const void* emb, int B, int T, int D,
                       const int* __restrict__ num_real, int k, int splits, int rows_per_split,
                       long long* partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qbase = blockIdx.x * 16 * MT, split = blockIdx.y;
  const int lo = split * rows_per_split;
  range_topk<MT, EX>(static_cast<const float*>(q), nullptr, qbase, B, static_cast<const float*>(emb),
                     D, T, max(0, *num_real), lo, lo + rows_per_split, k,
                     partial + ((size_t)qbase * splits + split) * k, (long long)splits * k, smem);
}

// ------------------------------------------------------ streaming kernel
constexpr int kMaxGroups = 2;   // consumer warpgroups a CTA
constexpr int kMaxCap = 256;    // list entries a query
constexpr int kNoThr = INT_MIN; // no threshold yet (below every key)
constexpr int kSmemMax = 232448;

// Dynamic shared memory of wg_stream_kernel, in the order of its layout:
// alignment slack, the queries, the ring, the lists of `rows` queries
// (min(64·groups, B)), the mbarriers.
constexpr int stream_smem(int rb, int groups, int stages, int cap, int rows) {
  return 1024 + 64 * groups * rb + stages * kTileN * rb + rows * cap * 8 + 2 * stages * 8;
}

template <bool EX, typename AccT>
__device__ __forceinline__ int stream_key(AccT s) {
  return EX ? exact_key(s) : enc_key(s);
}

// The accumulator value above which a score's key beats the threshold key
// t: key(s) > t exactly when s > raw_thr(t), for every score a tile gives
// (never -0.0, as the sums start at +0). kNoThr gives the lowest value.
template <int DT, bool EX>
__device__ __forceinline__ typename Acc<DT>::type raw_thr(int t) {
  if (t == kNoThr) return lowest<typename Acc<DT>::type>();
  if constexpr (DT == kI8) {
    if constexpr (EX) {
      // the largest sum whose key is at most t (the key grows with the sum)
      int r = __double2int_rd((double)from_sortable(t) * 16129.0);
      while (exact_key(r + 1) <= t) ++r;
      while (exact_key(r) > t) --r;
      return r;
    } else {
      const int r = t >> 12;  // t = clip(sum) << 12
      return r >= kIntClip ? INT_MAX : r;
    }
  } else if constexpr (EX) {
    return from_sortable(t);
  } else {
    // key(s) > t <=> to_sortable(s) > (t | 0xFFF); that bound's float is
    // -0.0 only for t = -4096, where the next key below (-denorm_min)
    // splits the scores the same way
    const int u = t | kIdxMask;
    return from_sortable(u == -1 ? -2 : u);
  }
}

// A list entry: the score's 32 raw bits over the row field 0xFFFFFFFF -
// row, written without computing the key; the selection key, and with it
// the composite, is made only when the list merges.
template <typename AccT>
__device__ __forceinline__ long long make_entry(AccT s, int row) {
  unsigned bits;
  if constexpr (std::is_same<AccT, float>::value)
    bits = __float_as_uint(s);
  else
    bits = (unsigned)s;
  return (long long)(((unsigned long long)bits << 32) | (0xFFFFFFFFu - (unsigned)row));
}
template <bool EX, typename AccT>
__device__ __forceinline__ int entry_key(long long e) {
  const int bits = (int)(e >> 32);
  if constexpr (std::is_same<AccT, float>::value)
    return stream_key<EX>(__int_as_float(bits));
  else
    return stream_key<EX>(bits);
}
template <bool EX, typename AccT>
__device__ __forceinline__ long long entry_comp(long long e) {
  return (long long)(((unsigned long long)(unsigned)entry_key<EX, AccT>(e) << 32) | (unsigned)e);
}

// One warp: keep the k best of a query's n >= k entries (unique
// composites) at the front of its list, in no order, and return the k-th
// best key tau. tau is found by bisection over the keys, from the row's
// threshold t (no candidate lies below it; the smallest key if t is
// kNoThr) to the largest, in steps of 2^SH (packed keys have 12 clear low
// bits); when tau is tied, a second bisection over the row fields keeps
// the lowest rows. The cost does not grow with k. Inlined, as every
// function of the kernel: a call would make ptxas wait for each wgmma in
// turn and spill the accumulators around it.
template <bool EX, typename AccT>
__device__ __forceinline__ int warp_merge(long long* list, int n, int k, int t, int lane) {
  constexpr int SH = EX ? 0 : 12;
  long long e[kMaxCap / 32];
  int key[kMaxCap / 32];  // INT_MIN, below every key, past n
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < kMaxCap / 32; ++i) {
    const bool in = lane + 32 * i < n;
    e[i] = in ? list[lane + 32 * i] : 0;
    key[i] = in ? entry_key<EX, AccT>(e[i]) : INT_MIN;
    if (in) {
      lo = min(lo, key[i]);
      hi = max(hi, key[i]);
    }
  }
  __syncwarp();
  auto count = [&](auto pass) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < kMaxCap / 32; ++i) c += pass(key[i], (unsigned)e[i]);
    return (int)__reduce_add_sync(kFull, (unsigned)c);
  };
  // tau: the largest key with at least k candidates at or above it
  long long a = (t == kNoThr ? __reduce_min_sync(kFull, lo) : t) >> SH;
  long long b = ((long long)__reduce_max_sync(kFull, hi) >> SH) + 1;
  while (b - a > 1) {
    const int mid = (int)((a + b) >> 1);
    if (count([&](int x, unsigned) { return (x >> SH) >= mid; }) >= k)
      a = mid;
    else
      b = mid;
  }
  const int tau = (int)(a << SH);
  const int need = k - count([&](int x, unsigned) { return x > tau; });
  // lam: keep the `need` candidates of key tau with the largest row fields
  unsigned lam = 0;
  if (count([&](int x, unsigned) { return x == tau; }) > need) {
    long long a2 = 0, b2 = 1ll << 32;
    while (b2 - a2 > 1) {
      const unsigned mid = (unsigned)((a2 + b2) >> 1);
      if (count([&](int x, unsigned low) { return x == tau && low >= mid; }) >= need)
        a2 = mid;
      else
        b2 = mid;
    }
    lam = (unsigned)a2;
  }
  int base = 0;
#pragma unroll
  for (int i = 0; i < kMaxCap / 32; ++i) {
    const bool keep = key[i] > tau || (key[i] == tau && (unsigned)e[i] >= lam);
    const unsigned bal = __ballot_sync(kFull, keep);
    if (keep) list[base + __popc(bal & ((1u << lane) - 1))] = e[i];
    base += __popc(bal);
  }
  __syncwarp();
  return tau;
}

// A lane's share of one query row of its warp (row g of the warp's 16,
// accumulator slots c < 2, or row g + 8, slots c >= 2). n and t are the
// same in the row's four lanes.
template <typename AccT>
struct Row {
  long long* list;  // the row's entries, shared memory
  AccT f;           // raw_thr(t); the highest value for a row past B
  int t;            // threshold key, kNoThr until the row has k candidates
  int n;            // entries in the list
};

// Inclusive sum of m over the four lanes of a row, up to this lane.
__device__ __forceinline__ int quad_scan(int m, int tig) {
  int x = __shfl_up_sync(kFull, m, 1, 4);
  if (tig >= 1) m += x;
  x = __shfl_up_sync(kFull, m, 2, 4);
  if (tig >= 2) m += x;
  return m;
}

// Bit 2(j - J0) + (c & 1) set: this lane's score of half H in column
// 8j + 2tig + (c & 1), j in [J0, J1), beats f (four chains of bits, ORed).
template <int H, int J0, int J1, typename AccT>
__device__ __forceinline__ unsigned above(const AccT (&acc)[64], AccT f) {
  unsigned m[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = J0; j < J1; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      m[j & 3] |= (unsigned)(acc[4 * j + 2 * H + c] > f) << (2 * (j - J0) + c);
  return (m[0] | m[1]) | (m[2] | m[3]);
}

// Append the scores of `mask` (above's bits for columns [8·J0, 8·J1)) of
// half H from the row's n + incl - popc(mask) on (incl: the inclusive
// count over the row's four lanes, total: the row's), each at its rank
// among this lane's bits: no branch, no key.
template <int H, int J0, int J1, typename AccT>
__device__ __forceinline__ void put(const AccT (&acc)[64], Row<AccT>& r, unsigned mask, int incl,
                                    int total, int row0, int tig) {
  if (mask) {
    long long* p = r.list + r.n + incl - __popc(mask);
#pragma unroll
    for (int j = J0; j < J1; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int b = 2 * (j - J0) + c;
        const long long e = make_entry(acc[4 * j + 2 * H + c], row0 + 8 * j + 2 * tig + c);
        if ((mask >> b) & 1) p[__popc(mask & ((1u << b) - 1))] = e;
      }
  }
  r.n += total;
  __syncwarp();
}

// Merge (warp-wide, one row at a time) the rows of half H whose lanes
// flag `want`: each keeps its k best and gets its threshold.
template <int H, int DT, bool EX>
__device__ __forceinline__ void merge_rows(bool want, Row<typename Acc<DT>::type>& r,
                                           long long* lists, int W, int k, int cap, int lane) {
  using AccT = typename Acc<DT>::type;
  const int g = lane >> 2, warp = threadIdx.x >> 5;
  for (unsigned mm = __ballot_sync(kFull, (lane & 3) == 0 && want); mm; mm &= mm - 1) {
    const int gs = (__ffs(mm) - 1) >> 2;
    const int tau = warp_merge<EX, AccT>(lists + (size_t)((gs + 8 * H) * W + warp) * cap,
                                         __shfl_sync(kFull, r.n, 4 * gs), k,
                                         __shfl_sync(kFull, r.t, 4 * gs), lane);
    if (g == gs) {
      r.n = k;
      r.t = tau;
      r.f = raw_thr<DT, EX>(tau);
    }
  }
}

// Append columns [8·J0, 8·J1) of half H (cols: the tile's valid columns,
// bit 2j + (c & 1)), merging first the rows whose list could not take them
// (cap >= k + 64 makes room for 64 columns).
template <int H, int J0, int J1, int DT, bool EX>
__device__ __forceinline__ void put_merged(const typename Acc<DT>::type (&acc)[64],
                                           Row<typename Acc<DT>::type>& r, unsigned cols,
                                           long long* lists, int W, int row0, int k, int cap,
                                           int lane) {
  const int tig = lane & 3;
  cols = (cols >> (2 * J0)) & ((1u << (2 * (J1 - J0))) - 1);
  unsigned mask = above<H, J0, J1>(acc, r.f) & cols;
  int incl = quad_scan(__popc(mask), tig), total = __shfl_sync(kFull, incl, 3, 4);
  if (__any_sync(kFull, r.n + total > cap)) {
    merge_rows<H, DT, EX>(r.n + total > cap, r, lists, W, k, cap, lane);
    mask = above<H, J0, J1>(acc, r.f) & cols;
    incl = quad_scan(__popc(mask), tig);
    total = __shfl_sync(kFull, incl, 3, 4);
  }
  put<H, J0, J1>(acc, r, mask, incl, total, row0, tig);
}

// A tile's selection for half H of the warp's rows, once a score of the
// warp beat its row's threshold (mask: this lane's, above's bits; cols:
// the tile's valid columns). First the rows whose list could not take the
// tile, or that hold k candidates but no threshold yet, merge; then, with
// the scores taken again against the new thresholds, one pass appends the
// tile. Only when a list still could not take it (more than cap - k of
// its scores beat the new threshold: the first tile, or rising data) does
// the tile go in two halves, merging between them.
template <int H, int DT, bool EX>
__device__ __forceinline__ void select_half(const typename Acc<DT>::type (&acc)[64],
                                            Row<typename Acc<DT>::type>& r, unsigned mask,
                                            unsigned cols, long long* lists, int W, int row0,
                                            int k, int cap, int lane) {
  const int tig = lane & 3;
  int incl = quad_scan(__popc(mask), tig), total = __shfl_sync(kFull, incl, 3, 4);
  const bool want = r.n >= k && (r.n + total > cap || r.t == kNoThr);
  if (__any_sync(kFull, want)) {
    merge_rows<H, DT, EX>(want, r, lists, W, k, cap, lane);
    mask = above<H, 0, 16>(acc, r.f) & cols;
    incl = quad_scan(__popc(mask), tig);
    total = __shfl_sync(kFull, incl, 3, 4);
  }
  if (!__any_sync(kFull, r.n + total > cap)) {
    put<H, 0, 16>(acc, r, mask, incl, total, row0, tig);
  } else {
    put_merged<H, 0, 8, DT, EX>(acc, r, cols, lists, W, row0, k, cap, lane);
    put_merged<H, 8, 16, DT, EX>(acc, r, cols, lists, W, row0, k, cap, lane);
  }
}

// CTA (blockIdx.x % nqg, blockIdx.x / nqg) = (query group, split): the
// queries 64·groups·group .. and the tiles split, split + splits, ... below
// lim = clamp(*num_real, 0, T), read from device memory so that a captured
// launch serves a growing index; writes partial[q, split, 0..k) for each of
// its queries q < B (all empty where the split holds no tile below lim).
// Warps 0 .. W-1 (W = 4·groups): the consumer warpgroups; warp W: the
// producer. Row j of warp w's 16 holds the group's query j·W + w, so the
// queries of a small batch spread over every warp.
template <int DT, int RB, bool EX>
__global__ void __launch_bounds__(128 * kMaxGroups + 32, 1)
    wg_stream_kernel(const unsigned char* __restrict__ q, const __grid_constant__ CUtensorMap emap,
                     int B, int T, const int* __restrict__ num_real, int k, int groups,
                     int stages, int cap, int nqg, int splits, long long* __restrict__ partial) {
  constexpr int KS = RB / 32, CB = chunk_bytes(RB), CH = RB / CB;
  constexpr int kTile = kTileN * RB;  // bytes of an index tile, one ring stage
  using AccT = typename Acc<DT>::type;
  extern __shared__ unsigned char smem_raw[];
  const int nq = 64 * groups, W = 4 * groups, a_chunk = nq * CB;
  unsigned char* sa = align1024(smem_raw);
  unsigned char* ring = sa + nq * RB;
  long long* lists = reinterpret_cast<long long*>(ring + stages * kTile);  // [min(nq, B)][cap]
  uint64_t* full = reinterpret_cast<uint64_t*>(lists + min(nq, B) * cap);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = blockIdx.x % nqg, split = blockIdx.x / nqg, q0 = qg * nq;
  const int lim = max(0, min(T, *num_real));
  const int ntiles = (lim + kTileN - 1) / kTileN;
  const int nt = split < ntiles ? (ntiles - 1 - split) / splits + 1 : 0;
  if (nt == 0) {  // no real row in the split: every slot empty
    for (int i = tid; i < nq * k; i += blockDim.x)
      if (q0 + i / k < B) partial[((size_t)(q0 + i / k) * splits + split) * k + i % k] = kEmpty;
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == W) {  // producer
    if (lane == 0)
      for (int i = 0, s = 0, par = 0; i < nt; ++i) {
        mbar_wait(&empty[s], par ^ 1);
        mbar_expect_tx(&full[s], kTile);
        for (int c = 0; c < CH; ++c)
          tma_load(ring + s * kTile + c * kTileN * CB, &emap, &full[s], c * CB,
                   (split + i * splits) * kTileN);
        if (++s == stages) s = 0, par ^= 1;
      }
    return;
  }

  // the group's queries, gathered into the swizzled layout (a zero row past
  // B) while the producer's first tiles are in flight
  for (int x = tid; x < nq * (RB / 16); x += 32 * W) {
    const int r = x / (RB / 16), p = x % (RB / 16), qi = q0 + (r & 15) * W + (r >> 4);
    cp_async16(sa + p / (CB / 16) * a_chunk + swz<CB>(r, p % (CB / 16)),
               q + (size_t)min(qi, B - 1) * RB + 16 * p, qi < B);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * W) : "memory");

  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  const uint32_t a_addr = smem_addr(sa) + wg * 64 * CB, r_addr = smem_addr(ring);
  const int i0 = g * W + warp, i1 = i0 + 8 * W;  // the group's queries of rows g, g + 8
  const bool v0 = q0 + i0 < B, v1 = q0 + i1 < B;
  const bool h0 = __any_sync(kFull, v0), h1 = __any_sync(kFull, v1);
  Row<AccT> r0{lists + (size_t)i0 * cap, v0 ? lowest<AccT>() : highest<AccT>(), kNoThr, 0};
  Row<AccT> r1{lists + (size_t)i1 * cap, v1 ? lowest<AccT>() : highest<AccT>(), kNoThr, 0};
  AccT acc[64];
  for (int it = 0, s = 0, par = 0; it < nt; ++it) {
    mbar_wait(&full[s], par);
    score_tile<DT, KS, CB>(acc, a_addr, a_chunk, r_addr + s * kTile, kTileN * CB);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) s = 0, par ^= 1;
    if (!(h0 || h1)) continue;
    const int row0 = (split + it * splits) * kTileN, nvalid = lim - row0;
    unsigned cols = kFull;  // bit 2j + (c & 1): column 8j + 2tig + (c & 1) is below lim
    if (nvalid < kTileN) {
      cols = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) cols |= (unsigned)(8 * j + 2 * tig + c < nvalid) << (2 * j + c);
    }
    const unsigned m0 = h0 ? above<0, 0, 16>(acc, r0.f) & cols : 0;
    const unsigned m1 = h1 ? above<1, 0, 16>(acc, r1.f) & cols : 0;
    if (!__any_sync(kFull, m0 | m1)) continue;
    if (h0) select_half<0, DT, EX>(acc, r0, m0, cols, lists, W, row0, k, cap, lane);
    if (h1) select_half<1, DT, EX>(acc, r1, m1, cols, lists, W, row0, k, cap, lane);
  }
  __syncwarp();
  // the split's k best of each query, unordered
  for (int j = 0; j < 16; ++j) {
    const int i = j * W + warp;
    if (q0 + i >= B) break;
    long long* list = lists + (size_t)i * cap;
    int n = __shfl_sync(kFull, j < 8 ? r0.n : r1.n, 4 * (j & 7));
    if (n > k) {
      warp_merge<EX, AccT>(list, n, k, __shfl_sync(kFull, j < 8 ? r0.t : r1.t, 4 * (j & 7)),
                           lane);
      n = k;
    }
    long long* o = partial + ((size_t)(q0 + i) * splits + split) * k;
    for (int c = lane; c < k; c += 32) o[c] = c < n ? entry_comp<EX, AccT>(list[c]) : kEmpty;
  }
}

struct StreamArgs {
  const void* q;
  const void* emb;
  const int* num_real;
  int B, T, k, groups, stages, cap, splits;
  long long* partial;
  cudaStream_t st;
};

template <int DT, int RB, bool EX>
int stream_wg(const StreamArgs& a) {
  CUtensorMap emap;
  if (int err = row_map(&emap, a.emb, a.T, RB, kTileN, chunk_bytes(RB)))
    return err;
  auto fn = wg_stream_kernel<DT, RB, EX>;
  if (const cudaError_t err = allow_smem(reinterpret_cast<const void*>(fn), kSmemMax);
      err != cudaSuccess)
    return (int)err;
  const int nqg = (a.B + 64 * a.groups - 1) / (64 * a.groups);
  const int smem = stream_smem(RB, a.groups, a.stages, a.cap, min(64 * a.groups, a.B));
  fn<<<nqg * a.splits, 128 * a.groups + 32, smem, a.st>>>(
      static_cast<const unsigned char*>(a.q), emap, a.B, a.T, a.num_real, a.k, a.groups, a.stages,
      a.cap, nqg, a.splits, a.partial);
  return (int)cudaGetLastError();
}

template <int DT, bool EX>
int stream_rb(int rb, const StreamArgs& a) {
  if (rb == 64) return stream_wg<DT, 64, EX>(a);
  return rb == 128 ? stream_wg<DT, 128, EX>(a) : stream_wg<DT, 256, EX>(a);
}

constexpr int kNegSink = (int)0x809E4000;  // sortable key of -3e38, low 12 bits cleared
constexpr float kNeg = -3.0e38f;

// One warp per row of `in` [R, n]: the k largest composites, best first.
// mode 0 writes composites; mode 1 (float keys) / 2 (int8 keys) decodes
// them into (value, row) as sse_tpu's _dec_val does, sinks for empties;
// mode 3 (exact keys) decodes the full key, and an empty slot is -3e38.
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
    else if (mode == 3)
      vals[o] = empty ? kNeg : from_sortable(key);
    else
      vals[o] = empty ? kNeg : (float)(key >> 12) * kInt8Inv;
  }
}

}  // namespace

// bf16 / int8 index (dt 1 / 2), rows of 64, 128 or 256 bytes: partial
// int64 [B, splits, k], each query's k best composites of each split
// (unordered; empty slots kEmpty). num_real: one int32 in device memory,
// clamped to [0, T] by the kernel. exact: 0 packed keys, 1 the exact
// variant's full keys. groups, stages, cap and splits come from the
// host's plan (ops/topk.py _stream_plan), sized on T: the CTAs of splits
// past num_real write empty slots and exit.
extern "C" int sse_topk_stream(const void* q, const void* emb, int dt, int B, int T, int D,
                               const void* num_real, int k, int exact, int groups, int stages,
                               int cap, int splits, void* partial, void* stream) {
  const int rb = D * (dt == kBF16 ? 2 : 1);
  if ((dt != kBF16 && dt != kI8) || (rb != 64 && rb != 128 && rb != 256) || k < 1 || k > 128 ||
      groups < 1 || groups > kMaxGroups || stages < 2 || splits < 1 || cap % 32 ||
      cap > kMaxCap || cap < k + kTileN / 2 ||
      stream_smem(rb, groups, stages, cap, min(64 * groups, B)) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const StreamArgs a{q, emb, static_cast<const int*>(num_real), B, T, k, groups, stages, cap,
                     splits, static_cast<long long*>(partial), static_cast<cudaStream_t>(stream)};
  if (dt == kBF16) return exact ? stream_rb<kBF16, true>(rb, a) : stream_rb<kBF16, false>(rb, a);
  return exact ? stream_rb<kI8, true>(rb, a) : stream_rb<kI8, false>(rb, a);
}

// float32 index: partial int64 [B, splits, k] from range_topk. qb: queries
// per block (16 or 64); splits x rows_per_split cover the rows; num_real
// as above.
extern "C" int sse_topk_stream_f32(const void* q, const void* emb, int B, int T, int D,
                                   const void* num_real, int k, int exact, int qb, int splits,
                                   int rows_per_split, void* partial, void* stream) {
  const int MT = qb / 16;
  if ((MT != 1 && MT != 4) || k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  const void* fn = MT == 1 ? (exact ? (const void*)topk_stream_kernel<1, true>
                                    : (const void*)topk_stream_kernel<1, false>)
                           : (exact ? (const void*)topk_stream_kernel<4, true>
                                    : (const void*)topk_stream_kernel<4, false>);
  const int smem = range_topk_smem(qb, k);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
