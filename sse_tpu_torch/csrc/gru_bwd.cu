// GRU layer backward for Hopper (sm_90a).
//
// Replaces sse_tpu/ops/pallas_rnn.py:_layer_bwd_pallas → _bwd_kernel, GRU
// branch (:217-265, 290-314), with the same rounding points:
//   gates_t  = xs_t·Wx + b + h_{t-1}·Wh    recomputed, h_{t-1} = bf16 ys[t-1], h_{-1} = 0
//   dh_t     = dh + dys_t ;  g = m_t·dh_t
//   dgates   = (dz_pre, dr_pre, dn_pre)    fp32, from the fused-reset cell
//   dgates_b = bf16(dgates)                operand of every product below
//   dh       = (1-m)·dh_t + g·z + dgates_b·Whᵀ
//   dxs_t    = bf16(dgates_b·Wxᵀ)
//   dWx = Σ xsᵀ·dgates_b,  dWh = Σ h_{t-1}ᵀ·dgates_b,  db = Σ dgates (unrounded)
//
// Design. The TPU kernel runs one reverse grid over T and keeps all of it
// in VMEM. On the H100 only the dh chain is serial; everything else is a
// product over all T·B rows at once. So one backward is five launches:
//
//   1. gates   [T·B, 3H] fp32 = [xs ; h_prev]·[Wx ; Wh] + b   (tiled mma.sync)
//   2. dh      the reverse loop: one block owns 32 batch rows for all T
//              steps and holds only Wh (bf16, 100,352 B at H=128) and a
//              double-buffered dgates_b tile in shared memory; it reads
//              the step's gates, writes dgates_b [T·B, 3H] bf16 and a
//              per-block fp32 db partial.
//   3. dxs     [T·B, E] = dgates_b·Wxᵀ                       (tiled mma.sync)
//   4. dW      [E+H, 3H] = [xs ; h_prev]ᵀ·dgates_b, split over T·B into
//              fixed fp32 partial buffers                    (tiled mma.sync)
//   5. reduce  sums the dW and db partials in a fixed order.
//
// Taking the gate recompute off the serial chain is what the TPU kernel's
// own comment asks for (pallas_rnn.py:145-149); it also keeps the serial
// kernel's shared memory to Wh alone: [Wx;Wh] for the recompute plus Whᵀ
// would need ~301 KB, above the 232,448-byte opt-in limit. No float
// atomics anywhere: every sum runs in an order fixed by the shapes, so the
// gradients are the same from run to run.
//
// What bounds it on the H100: the dh loop is latency-bound (T steps of a
// [32, 3H]·[3H, H] product per block and one barrier a step, only
// ceil(B/32) SMs busy: 8 at B=256, 12 at B=384). The three products are
// ~3.8 GFLOP each at T=50, B=384 and run single-buffered mma.sync tiles
// from shared memory, far below the tensor-core peak; the gates buffer
// costs 2·T·B·3H·4 bytes of traffic (59 MB at T=50, B=384).
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 32;    // dh kernel: batch rows per block (two m16 tiles)
constexpr int WH = 16;    // dh kernel: hidden units per warp
constexpr int KPAD = 8;   // bf16 row padding: spreads fragment loads over banks

// The serial reverse loop. Warp w owns hidden units [16w, 16w+16) of all
// three gates, so the cell backward for a (row, unit) needs z, r, n_pre
// from the same warp's loads, and its dh accumulator fragment is the same
// position as the forward kernel's h carry.
__global__ void gru_bwd_dh_kernel(const float* __restrict__ gates,
                                  const __nv_bfloat16* __restrict__ ys,
                                  const float* __restrict__ mask,
                                  const __nv_bfloat16* __restrict__ wh,
                                  const __nv_bfloat16* __restrict__ dys,
                                  const float* __restrict__ dfin,
                                  __nv_bfloat16* __restrict__ dgb,
                                  float* __restrict__ db_part, int T, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = 3 * H, ldw = N + KPAD;
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem);  // [H][ldw], Wh as stored
  __nv_bfloat16* dgs = whs + H * ldw;                            // [2][BM][ldw]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int col0 = warp * WH;

  // C[r][j] = Σ_k dg[r][k]·Wh[j][k]: a B fragment is Wh's row j, k-contiguous
  for (int i = tid; i < H * (N / 8); i += blockDim.x) {
    const int j = i / (N / 8), c = (i % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(whs + j * ldw + c) =
        *reinterpret_cast<const uint4*>(wh + (size_t)j * N + c);
  }

  float dh[2][2][4];     // fp32 dh carry: [m16 tile][n8 tile][fragment]
  float dbs[3][2][2];    // db over this thread's rows: [gate][n8 tile][column]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + mi * 16 + grp + half * 8;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int col = col0 + nj * 8 + 2 * tig;
        dh[mi][nj][half * 2] = r < B ? dfin[(size_t)r * H + col] : 0.f;
        dh[mi][nj][half * 2 + 1] = r < B ? dfin[(size_t)r * H + col + 1] : 0.f;
      }
    }
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) dbs[g][nj][0] = dbs[g][nj][1] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    __nv_bfloat16* dg = dgs + cur * BM * ldw;
    const float* mt = mask + (size_t)t * B;
    float base[2][2][4];  // (1-m)·dh_t + g·z

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = mi * 16 + grp + half * 8;
        const int r = row0 + rl;
        const bool valid = r < B;
        const float m = valid ? mt[r] : 0.f;
        const size_t tb = (size_t)t * B + r;
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int col = col0 + nj * 8 + 2 * tig;
          float2 zp = make_float2(0.f, 0.f), rp = zp, np = zp, dy = zp, hp = zp;
          if (valid) {
            const float* gr = gates + tb * N + col;
            zp = *reinterpret_cast<const float2*>(gr);
            rp = *reinterpret_cast<const float2*>(gr + H);
            np = *reinterpret_cast<const float2*>(gr + 2 * H);
            dy = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(dys + tb * H + col));
            if (t > 0)
              hp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  ys + (tb - B) * H + col));
          }
          const float zpre[2] = {zp.x, zp.y}, rpre[2] = {rp.x, rp.y}, npre[2] = {np.x, np.y};
          const float dyv[2] = {dy.x, dy.y}, hprev[2] = {hp.x, hp.y};
          float dz[2], dr[2], dn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = half * 2 + e;
            const float dh_t = dh[mi][nj][c] + dyv[e];
            const float g = m * dh_t;  // d h_new
            const float z = sse::sigmoid(zpre[e]);
            const float rg = sse::sigmoid(rpre[e]);
            const float n = tanhf(npre[e] * rg);
            // h_new = (1-z)·n + z·h_prev
            const float dnn = g * (1.f - z);
            dz[e] = g * (hprev[e] - n) * z * (1.f - z);
            const float dtanh = dnn * (1.f - n * n);
            dn[e] = dtanh * rg;
            dr[e] = dtanh * npre[e] * rg * (1.f - rg);
            base[mi][nj][c] = (1.f - m) * dh_t + g * z;
            dbs[0][nj][e] += dz[e];
            dbs[1][nj][e] += dr[e];
            dbs[2][nj][e] += dn[e];
          }
          const __nv_bfloat162 vz = __floats2bfloat162_rn(dz[0], dz[1]);
          const __nv_bfloat162 vr = __floats2bfloat162_rn(dr[0], dr[1]);
          const __nv_bfloat162 vn = __floats2bfloat162_rn(dn[0], dn[1]);
          __nv_bfloat16* ds = dg + rl * ldw + col;
          *reinterpret_cast<__nv_bfloat162*>(ds) = vz;
          *reinterpret_cast<__nv_bfloat162*>(ds + H) = vr;
          *reinterpret_cast<__nv_bfloat162*>(ds + 2 * H) = vn;
          if (valid) {
            __nv_bfloat16* dgl = dgb + tb * N + col;
            *reinterpret_cast<__nv_bfloat162*>(dgl) = vz;
            *reinterpret_cast<__nv_bfloat162*>(dgl + H) = vr;
            *reinterpret_cast<__nv_bfloat162*>(dgl + 2 * H) = vn;
          }
        }
      }
    __syncthreads();

    // dh = base + dgates_b·Whᵀ over K = 3H
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p0 = dg + (mi * 16 + grp) * ldw + kk + 2 * tig;
        a[mi][0] = sse::ld32(p0);
        a[mi][1] = sse::ld32(p0 + 8 * ldw);
        a[mi][2] = sse::ld32(p0 + 8);
        a[mi][3] = sse::ld32(p0 + 8 * ldw + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const __nv_bfloat16* wb = whs + (col0 + nj * 8 + grp) * ldw + kk + 2 * tig;
        const uint32_t b0 = sse::ld32(wb), b1 = sse::ld32(wb + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) sse::mma_bf16(acc[mi][nj], a[mi], b0, b1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) dh[mi][nj][c] = base[mi][nj][c] + acc[mi][nj][c];
    cur ^= 1;
  }

  // db partial of this block: sum the 8 row groups with a fixed shuffle tree
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dbs[g][nj][e];
        v += __shfl_xor_sync(sse::kFull, v, 4);
        v += __shfl_xor_sync(sse::kFull, v, 8);
        v += __shfl_xor_sync(sse::kFull, v, 16);
        if (grp == 0)
          db_part[(size_t)blockIdx.x * N + g * H + col0 + nj * 8 + 2 * tig + e] = v;
      }
}

}  // namespace

// Shared memory of the dh kernel; the wrapper rejects shapes above the
// 232,448-byte opt-in limit before launching.
extern "C" int sse_gru_bwd_smem_bytes(int H) {
  return (H * (3 * H + KPAD) + 2 * BM * (3 * H + KPAD)) * (int)sizeof(__nv_bfloat16);
}

// Rows of the batch one dh block owns (the db partials come one per block).
extern "C" int sse_gru_bwd_block_rows() { return BM; }

// One GRU layer backward. xs [T,B,E], ys [T,B,H], dys [T,B,H] bf16; mask
// [T,1,B], dfin [B,H], bias [3H] fp32; wx [E,3H], wh [H,3H] and
// wt = [Wx;Wh]ᵀ [3H,E+H] bf16. Scratch from the wrapper: gates [T·B,3H]
// fp32, dgb [T·B,3H] bf16, db_part [ceil(B/32),3H] and w_part
// [splits,E+H,3H] fp32. Out: dxs [T,B,E] bf16, dw [E+H,3H] (dWx over
// dWh) and db [3H] fp32. T, B >= 1; E, H multiples of 16.
extern "C" int sse_gru_bwd(const void* xs, const void* ys, const void* mask,
                           const void* wt, const void* wx, const void* wh,
                           const void* bias, const void* dys, const void* dfin,
                           void* gates, void* dgb, void* db_part, void* w_part,
                           void* dxs, void* dw, void* db, int T, int B, int E, int H,
                           int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = T * B, N = 3 * H, K = E + H;
  const auto* xs_b = static_cast<const __nv_bfloat16*>(xs);
  const auto* ys_b = static_cast<const __nv_bfloat16*>(ys);
  const Mat xh = {xs_b, E, E, ys_b, H, B, M, K};  // [xs ; h_prev] over T·B rows
  cudaError_t err;

  // 1. gates = [xs ; h_prev]·[Wx ; Wh] + b
  err = launch_gates(xh, static_cast<const __nv_bfloat16*>(wt), M, N, K,
                     static_cast<const float*>(bias), static_cast<float*>(gates), st);
  if (err != cudaSuccess) return (int)err;

  // 2. the serial dh loop
  const int smem = sse_gru_bwd_smem_bytes(H);
  err = cudaFuncSetAttribute(gru_bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cdiv(B, BM);
  gru_bwd_dh_kernel<<<nblk, 32 * (H / WH), smem, st>>>(
      static_cast<const float*>(gates), ys_b, static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(wh), static_cast<const __nv_bfloat16*>(dys),
      static_cast<const float*>(dfin), static_cast<__nv_bfloat16*>(dgb),
      static_cast<float*>(db_part), T, B, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 3-5. dxs = bf16(dgates_b·Wxᵀ), the split-K dW partials, their in-order sums
  return (int)launch_bwd_products(
      xh, static_cast<const __nv_bfloat16*>(dgb), static_cast<const __nv_bfloat16*>(wx), M, N, E,
      splits, static_cast<float*>(w_part), static_cast<const float*>(db_part), nblk, dxs,
      static_cast<float*>(dw), static_cast<float*>(db), st);
}
