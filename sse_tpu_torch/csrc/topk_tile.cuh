// The score tile of the top-k kernels (topk_stream.cu, topk_twophase.cu),
// for Hopper (sm_90a): index rows arrive in shared memory by TMA, and one
// warpgroup scores 64 queries against 128 of them with wgmma.
//
// Layout. A row of the index (or of the queries) is 64, 128 or 256 bytes
// (bf16 D = 32 / 64 / 128, int8 D = 64 / 128 / 256). Shared memory holds
// a tile as row_bytes / CB "chunks" of CB = min(row_bytes, 128) bytes a
// row: chunk c is rows x bytes [CB·c, CB·c + CB), in the CB-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B (64B) writes and wgmma's B128
// (B64) descriptor reads (128B: the 16-byte piece j of row r sits at
// piece j ^ (r % 8)). Every chunk starts on a 1024-byte boundary. The
// streaming and the two-phase kernels take all three widths.
//
// Numbers. score_tile sums the k-slices (32 bytes: 16 bf16 or 32 int8
// values) in increasing order into an accumulator that starts at +0, so
// a zero score is +0.0, never -0.0 (to_sortable puts the two in different
// key buckets). Both phases of the two-phase route and the streaming
// kernel score through this one function: the two-phase exactness proof
// (sse_tpu/ops/fused_topk.py:573-584) needs phase 1's block maxima and
// phase 2's element keys to be the same numbers, and the two routes then
// select on the same scores.
//
// Accumulator layout (wgmma m64n128, per thread of the warpgroup): warp w,
// lane = 4g + tig; d[4j + c] is query row 16w + g + 8(c >> 1) against
// tile row 8j + 2tig + (c & 1), j = 0..15 — the mma.sync C layout, one
// n8 tile per j.
#pragma once

#include "hopper.cuh"
#include "topk_common.cuh"

namespace sse {

constexpr int kTileN = 128;              // index rows a score tile
constexpr int kChunkBytes = 128;         // row bytes per swizzled chunk
// Bytes of a row in one swizzled chunk: the whole row, up to 128.
__host__ __device__ constexpr int chunk_bytes(int rb) {
  return rb < kChunkBytes ? rb : kChunkBytes;
}

// The same for int8 operands (k32), exact int32 accumulation.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Scores of the warpgroup's 64 queries against one tile of 128 index rows:
// KS k-slices of 32 bytes (KS = row_bytes / 32), in chunks of CB bytes a
// row: A's chunks `a_stride` bytes apart from a_addr, B's `b_stride`
// bytes apart from b_addr (shared addresses). acc is zeroed first and
// summed slice by slice; returns when the products are complete and the
// tile may be overwritten.
template <int DT, int KS, int CB>
__device__ __forceinline__ void score_tile(typename Acc<DT>::type (&acc)[64], uint32_t a_addr,
                                           int a_stride, uint32_t b_addr, int b_stride) {
  __syncwarp();  // wgmma is .sync.aligned: the warp converged after its barrier wait
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s / (CB / 32), o = 32 * (s % (CB / 32));
    const uint64_t da = sw_desc<CB>(a_addr + c * a_stride + o);
    const uint64_t db = sw_desc<CB>(b_addr + c * b_stride + o);
    if constexpr (DT == kI8)
      wgmma_s8(acc, da, db);
    else
      wgmma_bf16(acc, da, db);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(acc);
}

// A map over `rows` rows of `row_bytes` bytes at `base`, in boxes of
// `chunk` (128 or 64) bytes x box_rows rows, written into shared memory in
// the chunk's swizzle; rows past the end read 0.
inline int row_map(CUtensorMap* map, const void* base, int rows, int row_bytes, int box_rows,
                   int chunk) {
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)chunk, (cuuint32_t)box_rows};
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                  chunk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace sse
