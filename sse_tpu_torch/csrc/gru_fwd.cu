// Fused GRU layer forward for Hopper (sm_90a).
//
// Replaces sse_tpu/ops/pallas_rnn.py:_layer_fwd_pallas → _fwd_gru_kernel
// (_fwd_core). One launch runs a whole recurrent layer:
//   gates_t = xs_t·Wx + b + bf16(h_{t-1})·Wh     (bf16 operands, fp32 sums)
//   h_new   = (1-z)·tanh(r·n_pre) + z·h_{t-1}     (fused-reset GRU cell)
//   h_t     = m_t·h_new + (1-m_t)·h_{t-1}         (carry frozen past length)
// emitting ys [T,B,H] bf16 and fin [B,H] fp32. As on the TPU, the
// x-projection is computed inside the kernel, step by step.
//
// What bounds it on the H100: the recurrence is serial over T, so the only
// parallelism is the batch. Each block owns BM=32 rows for all T steps and
// keeps Wx and Wh (bf16, transposed, 2·128·384·2 = 196,608 B at E=H=128)
// resident in shared memory (opt-in dynamic smem, one block per SM), so
// weights are read from HBM once per block and each step touches HBM only
// for xs_t (read) and ys_t (write). At small B (8 rows: one block on one
// SM) the kernel is latency-bound on the T-step chain of two dependent
// mma.sync sweeps plus a __syncthreads per step; at B=4096 it is 128 blocks,
// one wave. The h-carry lives in registers (fp32) and, rounded to bf16,
// in a double-buffered smem tile that is the next step's A operand.
//
// Warp w owns hidden units [16w, 16w+16) of all three gates (z, r, n), so
// the cell update needs no cross-warp exchange: its accumulators hold
// z, r and n_pre for the same (row, unit) positions.
#include "common.cuh"

namespace {

constexpr int BM = 32;    // batch rows per block: two m16 tiles
constexpr int WH = 16;    // hidden units per warp (two n8 tiles per gate)
constexpr int KPAD = 8;   // bf16 row padding: spreads fragment loads over banks

__global__ void gru_fwd_kernel(const __nv_bfloat16* __restrict__ xs,
                               const float* __restrict__ mask,
                               const __nv_bfloat16* __restrict__ wx,
                               const __nv_bfloat16* __restrict__ wh,
                               const float* __restrict__ bias,
                               __nv_bfloat16* __restrict__ ys,
                               float* __restrict__ fin, int T, int B, int E,
                               int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = E + H, N = 3 * H;
  const int ldw = K + KPAD, ldh = H + KPAD;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [N][ldw]
  __nv_bfloat16* hs = wt + N * ldw;                              // [2][BM][ldh]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int col0 = warp * WH;

  // stage [Wx; Wh]ᵀ: wt[n][k] so a B fragment is one 32-bit load
  for (int i = tid; i < K * N; i += blockDim.x) {
    const int k = i / N, n = i - k * N;
    wt[n * ldw + k] = k < E ? wx[k * N + n] : wh[(k - E) * N + n];
  }
  for (int i = tid; i < 2 * BM * ldh; i += blockDim.x) hs[i] = __float2bfloat16(0.f);
  __syncthreads();

  float h[2][2][4];  // fp32 carry: [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) h[mi][nj][c] = 0.f;

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    float acc[2][3][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][g][nj][c] = 0.f;

    // x-part: A fragments straight from global xs_t
    const __nv_bfloat16* xt = xs + (size_t)t * B * E;
    for (int kk = 0; kk < E; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = row0 + mi * 16 + grp;
        const __nv_bfloat16* p0 = xt + (size_t)r * E + kk + 2 * tig;
        const __nv_bfloat16* p1 = p0 + 8 * (size_t)E;
        const bool v0 = r < B, v1 = r + 8 < B;
        a[mi][0] = v0 ? sse::ld32(p0) : 0u;
        a[mi][1] = v1 ? sse::ld32(p1) : 0u;
        a[mi][2] = v0 ? sse::ld32(p0 + 8) : 0u;
        a[mi][3] = v1 ? sse::ld32(p1 + 8) : 0u;
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const __nv_bfloat16* wb = wt + (g * H + col0 + nj * 8 + grp) * ldw + kk + 2 * tig;
          const uint32_t b0 = sse::ld32(wb), b1 = sse::ld32(wb + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) sse::mma_bf16(acc[mi][g][nj], a[mi], b0, b1);
        }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int col = col0 + nj * 8 + 2 * tig;
        const float b0 = bias[g * H + col], b1 = bias[g * H + col + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][g][nj][0] += b0;
          acc[mi][g][nj][1] += b1;
          acc[mi][g][nj][2] += b0;
          acc[mi][g][nj][3] += b1;
        }
      }

    // h-part: A fragments from the bf16 carry tile
    const __nv_bfloat16* hc = hs + cur * BM * ldh;
    for (int kk = 0; kk < H; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p0 = hc + (mi * 16 + grp) * ldh + kk + 2 * tig;
        a[mi][0] = sse::ld32(p0);
        a[mi][1] = sse::ld32(p0 + 8 * ldh);
        a[mi][2] = sse::ld32(p0 + 8);
        a[mi][3] = sse::ld32(p0 + 8 * ldh + 8);
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const __nv_bfloat16* wb = wt + (g * H + col0 + nj * 8 + grp) * ldw + E + kk + 2 * tig;
          const uint32_t b0 = sse::ld32(wb), b1 = sse::ld32(wb + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) sse::mma_bf16(acc[mi][g][nj], a[mi], b0, b1);
        }
    }

    // cell + masked carry, then publish bf16(h) for the next step and ys
    __nv_bfloat16* hn = hs + (cur ^ 1) * BM * ldh;
    const float* mt = mask + (size_t)t * B;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = mi * 16 + grp + half * 8;
        const int r = row0 + rl;
        const float m = r < B ? mt[r] : 0.f;
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = half * 2 + e;
            const float z = sse::sigmoid(acc[mi][0][nj][c]);
            const float rg = sse::sigmoid(acc[mi][1][nj][c]);
            const float n = tanhf(acc[mi][2][nj][c] * rg);
            const float hnew = (1.f - z) * n + z * h[mi][nj][c];
            h[mi][nj][c] = m * hnew + (1.f - m) * h[mi][nj][c];
          }
          const int col = col0 + nj * 8 + 2 * tig;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(h[mi][nj][half * 2], h[mi][nj][half * 2 + 1]);
          *reinterpret_cast<__nv_bfloat162*>(hn + rl * ldh + col) = v;
          if (r < B)
            *reinterpret_cast<__nv_bfloat162*>(ys + ((size_t)t * B + r) * H + col) = v;
        }
      }
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + mi * 16 + grp + half * 8;
      if (r >= B) continue;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int col = col0 + nj * 8 + 2 * tig;
        fin[(size_t)r * H + col] = h[mi][nj][half * 2];
        fin[(size_t)r * H + col + 1] = h[mi][nj][half * 2 + 1];
      }
    }
}

}  // namespace

// Shared memory one block needs; the wrapper rejects shapes above the
// 232,448-byte opt-in limit before launching.
extern "C" int sse_gru_fwd_smem_bytes(int E, int H) {
  return (3 * H * (E + H + KPAD) + 2 * BM * (H + KPAD)) * (int)sizeof(__nv_bfloat16);
}

extern "C" int sse_gru_fwd(const void* xs, const void* mask, const void* wx,
                           const void* wh, const void* bias, void* ys, void* fin,
                           int T, int B, int E, int H, void* stream) {
  const int smem = sse_gru_fwd_smem_bytes(E, H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BM - 1) / BM), block(32 * (H / WH));
  gru_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(wx), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(ys),
      static_cast<float*>(fin), T, B, E, H);
  return (int)cudaGetLastError();
}
