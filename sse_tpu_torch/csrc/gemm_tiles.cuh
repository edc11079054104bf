// The tiled tensor-core product and the fixed-order reduce that the
// recurrent layers' kernels share (gru_bwd.cu, lstm_bwd.cu, rnn_scan.cu):
// the products over all T·B rows of a layer (the gate pre-activations,
// dxs, the split-K weight gradients) and the in-order sum of the dW and
// db partials. No float atomics: every sum runs in an order fixed by the
// shapes, so results are the same from run to run.
//
// Each including file gets its own copy (anonymous namespace); the
// kernels are 64 x 64 output tiles of depth 32, 2 x 2 warps of mma.sync,
// both operands staged (transposed where needed) in static shared memory.
#pragma once

#include "common.cuh"

namespace {

constexpr int TM = 64;  // product tiles: 64 x 64 outputs, depth 32
constexpr int TK = 32;
constexpr int LDT = TK + 8;
constexpr int GEMM_THREADS = 128;  // 2 x 2 warps, 32 x 32 outputs each

enum { EPI_GATES = 0, EPI_BF16 = 1, EPI_PARTIAL = 2 };

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A logical bf16 matrix X[rows][cols], row-major. Columns [0, acols) are
// read from `a` (leading dimension lda); columns [acols, cols) from `b`,
// shifted down by b_shift rows, with zeros above. With a = xs, b = ys and
// b_shift = B this is [xs_t ; h_{t-1}] over the T·B rows (h_{-1} = 0).
struct Mat {
  const __nv_bfloat16* a;
  int lda, acols;
  const __nv_bfloat16* b;
  int ldb, b_shift;
  int rows, cols;
};

// X[r][c..c+7] (c a multiple of 8) as one 16-byte word; zero outside X.
__device__ __forceinline__ uint4 fetch8(const Mat& x, int r, int c) {
  if (r >= x.rows || c >= x.cols) return make_uint4(0u, 0u, 0u, 0u);
  if (c < x.acols)
    return *reinterpret_cast<const uint4*>(x.a + (size_t)r * x.lda + c);
  if (r < x.b_shift) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(x.b + (size_t)(r - x.b_shift) * x.ldb +
                                         (c - x.acols));
}

// s[i][j] = X[r0 + i][c0 + j] for i < TM, j < TK (16-byte copies)
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s, const Mat& x, int r0, int c0) {
  for (int q = threadIdx.x; q < TM * TK / 8; q += blockDim.x) {
    const int i = q / (TK / 8), j = (q % (TK / 8)) * 8;
    *reinterpret_cast<uint4*>(s + i * LDT + j) = fetch8(x, r0 + i, c0 + j);
  }
}

// s[i][j] = X[r0 + j][c0 + i] for i < TM, j < TK (transposed while staged)
__device__ __forceinline__ void stage_cols(__nv_bfloat16* s, const Mat& x, int r0, int c0) {
  unsigned short* d = reinterpret_cast<unsigned short*>(s);
  for (int q = threadIdx.x; q < TM * TK / 8; q += blockDim.x) {
    const int j = q / (TM / 8), i = (q % (TM / 8)) * 8;
    const uint4 v = fetch8(x, r0 + j, c0 + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      d[(i + 2 * u) * LDT + j] = (unsigned short)(w[u] & 0xFFFFu);
      d[(i + 2 * u + 1) * LDT + j] = (unsigned short)(w[u] >> 16);
    }
  }
}

// C[m][n] = Σ_k A[m][k]·B[k][n] over this block's slice of k, with
//   A[m][k] = AT ? xa[k][m] : xa[m][k],   B[k][n] = BT ? xb[k][n] : xb[n][k].
// blockIdx.z picks the slice [z·k_split, (z+1)·k_split); k_split is a
// multiple of TK, so no tile straddles two slices. Epilogues: EPI_GATES
// writes C + bias (fp32), EPI_BF16 bf16(C), EPI_PARTIAL C into slice z of
// a [splits][M][N] fp32 buffer.
template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(Mat xa, Mat xb, int M, int N, int K, int k_split,
            const float* __restrict__ bias, void* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 as[TM * LDT];
  __shared__ __align__(16) __nv_bfloat16 bs[TM * LDT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TM;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    if (AT) stage_cols(as, xa, k0, m0); else stage_rows(as, xa, m0, k0);
    if (BT) stage_cols(bs, xb, k0, n0); else stage_rows(bs, xb, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = as + (wm + mi * 16 + grp) * LDT + kk + 2 * tig;
        a[mi][0] = sse::ld32(p);
        a[mi][1] = sse::ld32(p + 8 * LDT);
        a[mi][2] = sse::ld32(p + 8);
        a[mi][3] = sse::ld32(p + 8 * LDT + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const __nv_bfloat16* q = bs + (wn + nj * 8 + grp) * LDT + kk + 2 * tig;
        const uint32_t b0 = sse::ld32(q), b1 = sse::ld32(q + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) sse::mma_bf16(acc[mi][nj], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm + mi * 16 + grp + half * 8;
      if (r >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn + nj * 8 + 2 * tig;  // N is even: col < N ⇒ col+1 < N
        if (col >= N) continue;
        float v0 = acc[mi][nj][half * 2], v1 = acc[mi][nj][half * 2 + 1];
        const size_t o = (size_t)r * N + col;
        if (EPI == EPI_GATES) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0 + bias[col], v1 + bias[col + 1]);
        } else if (EPI == EPI_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                     (size_t)blockIdx.z * M * N + o) = make_float2(v0, v1);
        }
      }
    }
}

// dw[i] = Σ_z w_part[z][i] and db[n] = Σ_blk db_part[blk][n], in order.
__global__ void bwd_reduce_kernel(const float* __restrict__ w_part, int splits,
                                  int wsize, const float* __restrict__ db_part,
                                  int nblk, int N, float* __restrict__ dw,
                                  float* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < wsize) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += w_part[(size_t)z * wsize + i];
    dw[i] = s;
  } else if (i < wsize + N) {
    const int n = i - wsize;
    float s = 0.f;
    for (int k = 0; k < nblk; ++k) s += db_part[(size_t)k * N + n];
    db[n] = s;
  }
}

// out [M, N] fp32 = X·Wᵀ + bias, with X [M, K] and wt = Wᵀ [N, K] bf16
// in rows ldw apart (the rows of wt are the B fragments as stored; the
// LSTM forward passes the Wx columns of [Wx;Wh]ᵀ).
inline cudaError_t launch_gates(const Mat& x, const __nv_bfloat16* wt, int ldw, int M, int N,
                                int K, const float* bias, float* out, cudaStream_t st) {
  const Mat w = {wt, ldw, K, nullptr, 0, 0, N, K};
  gemm_kernel<false, false, EPI_GATES><<<dim3(cdiv(N, TM), cdiv(M, TM), 1), GEMM_THREADS, 0, st>>>(
      x, w, M, N, K, cdiv(K, TK) * TK, bias, out);
  return cudaGetLastError();
}

// The products of a layer backward after its serial loop, over all
// M = T·B rows, and the fixed-order reduce:
//   dxs [M, E] = bf16(dgb·Wxᵀ)   (dgb [M, N] bf16, wx [E, N] as stored)
//   dw  [E+H, N] = Σ_z [xs ; h_prev]ᵀ·dgb over split z of the rows
//   db  [N] = Σ_blk db_part[blk]  (the serial loop's per-block partials)
inline cudaError_t launch_bwd_products(const Mat& xh, const __nv_bfloat16* dgb,
                                       const __nv_bfloat16* wx, int M, int N, int E,
                                       int splits, float* w_part, const float* db_part,
                                       int nblk, void* dxs, float* dw, float* db,
                                       cudaStream_t st) {
  const int K = xh.cols;
  cudaError_t err;
  const Mat dg_m = {dgb, N, N, nullptr, 0, 0, M, N};
  const Mat wx_m = {wx, N, N, nullptr, 0, 0, E, N};
  gemm_kernel<false, false, EPI_BF16><<<dim3(cdiv(E, TM), cdiv(M, TM), 1), GEMM_THREADS, 0, st>>>(
      dg_m, wx_m, M, E, N, cdiv(N, TK) * TK, nullptr, dxs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int k_split = cdiv(cdiv(M, splits), TK) * TK;
  gemm_kernel<true, true, EPI_PARTIAL><<<dim3(cdiv(N, TM), cdiv(K, TM), splits), GEMM_THREADS, 0, st>>>(
      xh, dg_m, K, N, M, k_split, nullptr, w_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int wsize = K * N;
  bwd_reduce_kernel<<<cdiv(wsize + N, 256), 256, 0, st>>>(w_part, splits, wsize, db_part,
                                                          nblk, N, dw, db);
  return cudaGetLastError();
}

}  // namespace
