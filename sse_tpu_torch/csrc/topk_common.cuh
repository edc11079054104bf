// Shared pieces of the port's top-k kernels (topk_stream.cu,
// topk_twophase.cu): the selection keys, and the float32 index's scores and
// per-block running top-k over a range of index rows.
//
// Selection contract (sse_tpu/ops/fused_topk.py, the packed variant):
//   float index: key = to_sortable(score) & ~0xFFF  (11 mantissa bits)
//   int8 index:  key = clip(score_i32, ±(2^18-1)) << 12  (exact)
//   order: key descending, then global row ascending.
// The exact variant (EX = true) keys on the full float32 score instead:
//   key = to_sortable(score + 0.0f), all 32 bits; for int8 the score is
//   float(score_i32) * float32(1/127²), the value the JAX kernel selects on.
// One signed 64-bit composite carries both orders:
//   comp = (int64)key << 32 | (0xFFFFFFFF - row)
// so a plain max picks (key desc, row asc), and every composite of one
// query is unique. INT64_MIN marks an empty slot.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sse {

constexpr int kTileRows = 64;  // index rows scored per block step
constexpr int kWarps = 4;      // warps per block
constexpr int kIdxMask = 0xFFF;
constexpr int kIntClip = (1 << 18) - 1;
constexpr long long kEmpty = (long long)0x8000000000000000ULL;
constexpr long long kFull64 = 0x7FFFFFFFFFFFFFFFLL;
constexpr float kInt8Inv = 0x1.040c2p-14f;  // float32(1 / 127²)

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int DT>
struct Acc {
  using type = float;
};
template <>
struct Acc<kI8> {
  using type = int;
};

__device__ __forceinline__ int to_sortable(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// The lowest and the highest value of an accumulator type.
template <typename T>
__device__ __forceinline__ T lowest() {
  if constexpr (std::is_same<T, float>::value)
    return -__int_as_float(0x7f800000);
  else
    return INT_MIN;
}
template <typename T>
__device__ __forceinline__ T highest() {
  if constexpr (std::is_same<T, float>::value)
    return __int_as_float(0x7f800000);
  else
    return INT_MAX;
}

__device__ __forceinline__ float from_sortable(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ int enc_key(float s) { return to_sortable(s) & ~kIdxMask; }
__device__ __forceinline__ int enc_key(int s) {
  return (s < -kIntClip ? -kIntClip : (s > kIntClip ? kIntClip : s)) * (1 << 12);
}

// Exact-variant keys. __fadd_rn(s, 0) turns -0.0 into +0.0 (and is never
// folded away), so a tie between the two goes to the lower row, as the
// JAX kernel's (scores == max) pass treats it.
__device__ __forceinline__ int exact_key(float s) { return to_sortable(__fadd_rn(s, 0.0f)); }
__device__ __forceinline__ int exact_key(int s) { return to_sortable(__fmul_rn((float)s, kInt8Inv)); }

__device__ __forceinline__ long long make_comp(int key, int row) {
  return (long long)(((unsigned long long)(unsigned)key << 32) |
                     (unsigned long long)(0xFFFFFFFFu - (unsigned)row));
}

__device__ __forceinline__ long long warp_max_i64(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Scores of the warp's 16 queries (rows q0, q1 of its lanes) against NT·8
// float32 index rows starting at `rbase`, in the mma C layout: acc[j][c]
// is query row g + 8·(c>>1) against index row rbase + 8j + 2·tig + (c&1),
// computed with fp32 FMAs (no tensor-core product keeps fp32 operands).
// Rows >= T read 0.
template <int NT>
__device__ __forceinline__ void score_f32(const float* q0, const float* q1, const float* emb,
                                          int D, int T, int rbase, int tig, float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int r0 = rbase + 8 * j + 2 * tig;
    const float* e0 = r0 < T ? emb + (size_t)r0 * D : nullptr;
    const float* e1 = r0 + 1 < T ? emb + (size_t)(r0 + 1) * D : nullptr;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x0 = q0 ? __ldg(q0 + d) : 0.f, x1 = q1 ? __ldg(q1 + d) : 0.f;
      const float y0 = e0 ? __ldg(e0 + d) : 0.f, y1 = e1 ? __ldg(e1 + d) : 0.f;
      s00 = fmaf(x0, y0, s00);
      s01 = fmaf(x0, y1, s01);
      s10 = fmaf(x1, y0, s10);
      s11 = fmaf(x1, y1, s11);
    }
    acc[j][0] = s00;
    acc[j][1] = s01;
    acc[j][2] = s10;
    acc[j][3] = s11;
  }
}

// Dynamic shared memory of range_topk for QB queries and top-k width k.
__host__ __device__ inline int range_topk_smem(int QB, int k) {
  return QB * (k * 8 + kTileRows * 8 + 8 + 4 + 4);
}

// Top-k of the block's QB = 16·MT queries over index rows
// [row_lo, row_hi) ∩ [0, min(T, num_real)). qid[i] is the global query
// row of local query i (negative = none). Writes each local query's k
// composites, best first, to out + i·out_stride (empty slots kEmpty).
//
// The float32 index's kernels (the bf16 and int8 ones score through the
// wgmma tile, topk_tile.cuh). Per step the block scores a 64-row tile; a
// score is a candidate only if its composite beats the query's current
// k-th best (a register copy of the threshold). Candidates go to a
// per-query buffer in shared memory (at most 64 per step, so it never
// overflows); a step that produced any is followed by one warp-per-query
// merge of buffer and list. EX picks the exact variant's key (exact_key)
// over the packed one (enc_key).
template <int MT, bool EX = false>
__device__ void range_topk(const float* qv, const int* qid_in, int qbase, int B,
                           const float* emb, int D, int T, int num_real, int row_lo,
                           int row_hi, int k, long long* out, long long out_stride,
                           unsigned char* smem) {
  constexpr int QB = 16 * MT;
  constexpr int NT = 2 * MT;          // n8 tiles per warp
  constexpr int NW = 8 * NT;          // index rows per warp per step

  long long* list = reinterpret_cast<long long*>(smem);   // [QB][k]
  long long* buf = list + QB * k;                          // [QB][64]
  long long* thr = buf + QB * kTileRows;                   // [QB]
  int* cnt = reinterpret_cast<int*>(thr + QB);             // [QB]
  int* qid = cnt + QB;                                     // [QB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mi = warp % MT, cg = warp / MT;

  for (int i = tid; i < QB * k; i += blockDim.x) list[i] = kEmpty;
  for (int i = tid; i < QB; i += blockDim.x) {
    thr[i] = kEmpty;
    cnt[i] = 0;
    const int q = qid_in ? qid_in[i] : qbase + i;
    qid[i] = (q >= 0 && q < B) ? q : -1;
  }
  __syncthreads();

  const int ql0 = mi * 16 + g, ql1 = ql0 + 8;
  const int q0 = qid[ql0], q1 = qid[ql1];
  const float* p0 = q0 >= 0 ? qv + (size_t)q0 * D : nullptr;
  const float* p1 = q1 >= 0 ? qv + (size_t)q1 * D : nullptr;

  const int lim = min(row_hi, min(T, num_real));
  long long t0 = kEmpty, t1 = kEmpty;  // thresholds of query rows ql0, ql1

  for (int row0 = row_lo; row0 < lim; row0 += kTileRows) {
    const int rbase = row0 + cg * NW;
    float acc[NT][4];
    score_f32<NT>(p0, p1, emb, D, T, rbase, tig, acc);
    int added = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = rbase + 8 * j + 2 * tig + (c & 1);
        const bool hi = c >> 1;
        if ((hi ? q1 : q0) < 0 || row >= lim) continue;
        const int key = EX ? exact_key(acc[j][c]) : enc_key(acc[j][c]);
        const long long comp = make_comp(key, row);
        if (comp > (hi ? t1 : t0)) {
          const int ql = hi ? ql1 : ql0;
          buf[ql * kTileRows + atomicAdd(&cnt[ql], 1)] = comp;
          added = 1;
        }
      }
    if (!__syncthreads_or(added)) continue;
    for (int ql = warp; ql < QB; ql += kWarps) {
      const int n = cnt[ql];
      if (n == 0) continue;
      long long it[6];
#pragma unroll
      for (int i = 0; i < 4; ++i) it[i] = lane + 32 * i < k ? list[ql * k + lane + 32 * i] : kEmpty;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        it[4 + i] = lane + 32 * i < n ? buf[ql * kTileRows + lane + 32 * i] : kEmpty;
      long long prev = kFull64;
      for (int r = 0; r < k; ++r) {
        long long m = kEmpty;
#pragma unroll
        for (int i = 0; i < 6; ++i)
          if (it[i] < prev && it[i] > m) m = it[i];
        m = warp_max_i64(m);
        prev = m;
        if (lane == 0) list[ql * k + r] = m;
      }
      if (lane == 0) {
        thr[ql] = prev;
        cnt[ql] = 0;
      }
    }
    __syncthreads();
    t0 = thr[ql0];
    t1 = thr[ql1];
  }
  __syncthreads();
  for (int i = tid; i < QB * k; i += blockDim.x) {
    const int ql = i / k;
    if (qid[ql] >= 0 || qid_in) out[ql * out_stride + (i - ql * k)] = list[i];
  }
}

}  // namespace sse
