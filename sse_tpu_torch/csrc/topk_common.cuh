// Shared pieces of the port's top-k kernels (topk_stream.cu,
// topk_twophase.cu): the selection keys, a warp's score tile on the tensor
// cores, and the per-block running top-k over a range of index rows.
//
// Selection contract (sse_tpu/ops/fused_topk.py, the packed variant):
//   float index: key = to_sortable(score) & ~0xFFF  (11 mantissa bits)
//   int8 index:  key = clip(score_i32, ±(2^18-1)) << 12  (exact)
//   order: key descending, then global row ascending.
// One signed 64-bit composite carries both orders:
//   comp = (int64)key << 32 | (0xFFFFFFFF - row)
// so a plain max picks (key desc, row asc), and every composite of one
// query is unique. INT64_MIN marks an empty slot.
#pragma once

#include "common.cuh"

namespace sse {

constexpr int kTileRows = 64;  // index rows scored per block step
constexpr int kWarps = 4;      // warps per block
constexpr int kIdxMask = 0xFFF;
constexpr int kIntClip = (1 << 18) - 1;
constexpr long long kEmpty = (long long)0x8000000000000000ULL;
constexpr long long kFull64 = 0x7FFFFFFFFFFFFFFFLL;

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

__device__ __forceinline__ int enc_key(float s) { return to_sortable(s) & ~kIdxMask; }
__device__ __forceinline__ int enc_key(int s) {
  return (s < -kIntClip ? -kIntClip : (s > kIntClip ? kIntClip : s)) * (1 << 12);
}

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

// A fragments of one m16 tile of queries: rows g and g+8 of the tile,
// KS k-slices of 32 bytes (16 bf16 or 32 int8 values). The byte offsets
// of the m16n8k16 bf16 and m16n8k32 s8 layouts coincide.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const unsigned char* q0,
                                       const unsigned char* q1, int tig) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int o = 32 * s + 4 * tig;
    a[s][0] = q0 ? __ldg(reinterpret_cast<const unsigned*>(q0 + o)) : 0u;
    a[s][1] = q1 ? __ldg(reinterpret_cast<const unsigned*>(q1 + o)) : 0u;
    a[s][2] = q0 ? __ldg(reinterpret_cast<const unsigned*>(q0 + o + 16)) : 0u;
    a[s][3] = q1 ? __ldg(reinterpret_cast<const unsigned*>(q1 + o + 16)) : 0u;
  }
}

// Scores of the warp's 16 queries against NT·8 index rows starting at
// `rbase`, in the mma C layout: acc[j][c] is query row g + 8·(c>>1) of the
// m-tile against index row rbase + 8j + 2·tig + (c&1). Rows >= T read 0.
template <int DT, int KS, int NT>
__device__ __forceinline__ void score_mma(const uint32_t (&a)[KS][4], const unsigned char* emb,
                                          int row_bytes, int T, int rbase, int g, int tig,
                                          typename Acc<DT>::type (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;
    const int row = rbase + 8 * j + g;
    const bool ok = row < T;
    const unsigned char* p = emb + (size_t)(ok ? row : 0) * row_bytes + 4 * tig;
    uint32_t b[KS][2];
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      b[s][0] = ok ? __ldg(reinterpret_cast<const unsigned*>(p + 32 * s)) : 0u;
      b[s][1] = ok ? __ldg(reinterpret_cast<const unsigned*>(p + 32 * s + 16)) : 0u;
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if constexpr (DT == kI8)
        mma_s8(acc[j], a[s], b[s][0], b[s][1]);
      else
        mma_bf16(acc[j], a[s], b[s][0], b[s][1]);
    }
  }
}

// float32 index: the same C layout, computed with fp32 FMAs (no tensor
// core product keeps full fp32 operands).
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

// Exact top-k of the block's QB = 16·MT queries over index rows
// [row_lo, row_hi) ∩ [0, min(T, num_real)). qid[i] is the global query
// row of local query i (negative = none). Writes each local query's k
// composites, best first, to out + i·out_stride (empty slots kEmpty).
//
// Per step the block scores a 64-row tile on the tensor cores; a score
// is a candidate only if its composite beats the query's current k-th
// best (a register copy of the threshold). Candidates go to a per-query
// buffer in shared memory (at most 64 per step, so it never overflows);
// a step that produced any is followed by one warp-per-query merge of
// buffer and list. On random data the threshold rises fast and almost
// every step is scores + one compare + one __syncthreads_or.
template <int DT, int KS, int MT>
__device__ void range_topk(const void* qv, const int* qid_in, int qbase, int B,
                           const void* embv, int D, int T, int num_real, int row_lo,
                           int row_hi, int k, long long* out, long long out_stride,
                           unsigned char* smem) {
  constexpr int QB = 16 * MT;
  constexpr int NT = 2 * MT;          // n8 tiles per warp
  constexpr int NW = 8 * NT;          // index rows per warp per step
  using AccT = typename Acc<DT>::type;
  constexpr int esz = DT == kF32 ? 4 : (DT == kBF16 ? 2 : 1);

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

  const int row_bytes = D * esz;
  const int ql0 = mi * 16 + g, ql1 = ql0 + 8;
  const int q0 = qid[ql0], q1 = qid[ql1];
  const unsigned char* qb = static_cast<const unsigned char*>(qv);
  const unsigned char* p0 = q0 >= 0 ? qb + (size_t)q0 * row_bytes : nullptr;
  const unsigned char* p1 = q1 >= 0 ? qb + (size_t)q1 * row_bytes : nullptr;
  uint32_t a[KS][4];
  if constexpr (DT != kF32) load_a<KS>(a, p0, p1, tig);

  const int lim = min(row_hi, min(T, num_real));
  long long t0 = kEmpty, t1 = kEmpty;  // thresholds of query rows ql0, ql1

  for (int row0 = row_lo; row0 < lim; row0 += kTileRows) {
    const int rbase = row0 + cg * NW;
    AccT acc[NT][4];
    if constexpr (DT == kF32)
      score_f32<NT>(reinterpret_cast<const float*>(p0), reinterpret_cast<const float*>(p1),
                    static_cast<const float*>(embv), D, T, rbase, tig, acc);
    else
      score_mma<DT, KS, NT>(a, static_cast<const unsigned char*>(embv), row_bytes, T, rbase, g,
                            tig, acc);
    int added = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = rbase + 8 * j + 2 * tig + (c & 1);
        const bool hi = c >> 1;
        if ((hi ? q1 : q0) < 0 || row >= lim) continue;
        const long long comp = make_comp(enc_key(acc[j][c]), row);
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
