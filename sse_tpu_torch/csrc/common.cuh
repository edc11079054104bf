// Shared device helpers for the port's Hopper kernels: warp-level
// tensor-core products (mma.sync), asynchronous copies into shared memory
// (cp.async), a 32-bit load and the logistic function.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace sse {

constexpr unsigned kFull = 0xFFFFFFFFu;

// D += A·B on one 16x8x16 tile: bf16 operands, fp32 accumulation.
// Fragments follow the PTX layout: lane = 4·group + tig; A rows group and
// group+8, k pairs at 2·tig (+8); B column group, k pairs at 2·tig (+8);
// D rows group (d0, d1) and group+8 (d2, d3), columns 2·tig and 2·tig+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A·B on one 16x8x32 tile: int8 operands, exact int32 accumulation.
// As above with k quads at 4·tig (+16).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copy of 16 (or 4) bytes from global to shared memory; when
// `valid` is false nothing is read and the destination is zero-filled.
// Both addresses are aligned to the copy's size.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}
// Close the group of this thread's copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
// Other threads see the copies only after a barrier (__syncthreads, or
// __syncwarp among the lanes of one warp).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The logistic function, and the same from e = expf(-x): sigmoid(x) ==
// sigmoid_exp(expf(-x)) bit for bit. The IEEE division is a branch the
// compiler schedules on its own, so a kernel with many cells computes all
// the exponentials first, then the divisions back to back.
__device__ __forceinline__ float sigmoid_exp(float e) { return 1.f / (1.f + e); }
__device__ __forceinline__ float sigmoid(float x) { return sigmoid_exp(expf(-x)); }

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (m16 x k16) of mma_bf16: rows m and m+8 of a row-major bf16
// matrix with leading dimension ld, k pairs at 2·tig (+8); p points at
// row m, column k + 2·tig.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* p, int ld) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

}  // namespace sse
