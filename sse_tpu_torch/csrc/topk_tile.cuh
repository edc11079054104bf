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

#include <cuda.h>

#include <mutex>
#include <set>
#include <utility>

#include "topk_common.cuh"

namespace sse {

constexpr int kTileN = 128;              // index rows a score tile
constexpr int kChunkBytes = 128;         // row bytes per swizzled chunk
// Bytes of a row in one swizzled chunk: the whole row, up to 128.
__host__ __device__ constexpr int chunk_bytes(int rb) {
  return rb < kChunkBytes ? rb : kChunkBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Make the barriers' initialization visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`. A
// wait that never ends (a fault in a kernel's arrive/expect protocol)
// traps after 2^24 polls (far longer than any wait of a working
// kernel), so it fails the launch and does not
// hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA
// Copy the box at (x bytes, y rows) of `map` into shared memory at dst;
// completion is counted on `bar` (rows past the tensor's end read 0).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// Make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of the 16-byte piece j of row r inside a chunk of CB-byte
// rows, in the swizzle TMA writes and wgmma reads (128 bytes: piece
// j ^ (r % 8); 64 bytes: piece j ^ (r / 2 % 4)).
template <int CB>
__device__ __forceinline__ int swz(int r, int j) {
  return r * CB + ((j ^ (CB == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: K-major, CB-byte swizzle (layout 1:
// 128 bytes, 2: 64 bytes), 8-row groups 8·CB bytes apart (start address
// and offsets in 16-byte units).
template <int CB>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  static_assert(CB == 128 || CB == 64, "swizzle of 64 or 128 bytes");
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(CB / 2) << 32) |
         ((CB == 128 ? 1ull : 2ull) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across the fences.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] += A[64 x 16] · B[128 x 16]ᵀ on one warpgroup: bf16
// operands in shared memory (K-major, swizzled; da, db from sw_desc),
// fp32 accumulation (scale-d = 1: the product is added to D).
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
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

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A map over `rows` rows of `row_bytes` bytes at `base`, in boxes of
// `chunk` (128 or 64) bytes x box_rows rows, written into shared memory in
// the chunk's swizzle; rows past the end read 0.
inline int row_map(CUtensorMap* map, const void* base, int rows, int row_bytes, int box_rows,
                   int chunk) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)chunk, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         chunk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allow the kernel `fn` `bytes` of dynamic shared memory on the current
// device. The attribute belongs to a (kernel, device) pair, so it is set
// the first time a process launches fn on each device (a process may
// drive several cards: the shards of a grid).
inline cudaError_t allow_smem(const void* fn, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({fn, dev})) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert({fn, dev});
  return err;
}

inline int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

}  // namespace sse
