// LSTM layer backward for Hopper (sm_90a).
//
// Replaces sse_tpu/ops/pallas_rnn.py:_layer_bwd_pallas → _bwd_kernel, LSTM
// branch (:239-248, 266-289, 290-314), with the same rounding points:
//   gates_t  = xs_t·Wx + b + h_{t-1}·Wh   recomputed; h_{t-1} = bf16 ys[t-1],
//              c_{t-1} = bf16 cs[t-1], both 0 at t = 0
//   dh_t     = dh + dys_t ;  g = m_t·dh_t        (dh starts at dfin, dc at 0)
//   c_new    = σ(f+1)·c_{t-1} + σ(i)·tanh(g̃),  from the bf16 c_{t-1}
//   dc_new   = m·dc + g·σ(o)·(1 - tanh²(c_new))
//   dgates   = (di, df, dg̃, do) fp32;  dgates_b = bf16(dgates)
//   dh       = (1-m)·dh_t + dgates_b·Whᵀ        (no direct term)
//   dc       = (1-m)·dc + dc_new·σ(f+1)
//   dxs_t    = bf16(dgates_b·Wxᵀ)
//   dWx = Σ xsᵀ·dgates_b,  dWh = Σ h_{t-1}ᵀ·dgates_b,  db = Σ dgates (unrounded)
//
// Design: gru_bwd.cu's five launches with N = 4H. (1) one tiled product
// recomputes the gates of all T·B rows off the serial chain; (2) the
// serial loop carries dh and dc, one block per 32 batch rows for all T
// steps, holding Wh as stored (its rows are the B fragments of
// dgates_b·Whᵀ) and a double-buffered dgates_b tile in shared memory:
// (128·520 + 2·32·520)·2 = 199,680 B at H=128; (3) dxs, (4) the split-K
// dW product into fixed partials, (5) their in-order sum with the loop's
// per-block db partials (gemm_tiles.cuh). No float atomics.
//
// What bounds it on the H100: the serial loop, latency-bound (T steps of
// a [32, 4H]·[4H, H] product per block and one
// barrier a step, on ceil(B/32) SMs: 8 at B=256); the products are ~4/3
// of the GRU's FLOPs on the same untuned mma.sync tiles; the gates buffer
// costs 2·T·B·4H·4 bytes of traffic (52 MB at T=50, B=256).
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 32;    // batch rows per block (two m16 tiles)
constexpr int WH = 16;    // hidden units per warp
constexpr int KPAD = 8;   // bf16 row padding: spreads fragment loads over banks

// The serial reverse loop. Warp w owns hidden units [16w, 16w+16) of all
// four gates, so the cell backward for a (row, unit) needs only the same
// warp's loads, and its dh and dc carries sit at the positions of the
// forward's h and c.
__global__ void lstm_bwd_dh_kernel(const float* __restrict__ gates,
                                   const __nv_bfloat16* __restrict__ cs,
                                   const float* __restrict__ mask,
                                   const __nv_bfloat16* __restrict__ wh,
                                   const __nv_bfloat16* __restrict__ dys,
                                   const float* __restrict__ dfin,
                                   __nv_bfloat16* __restrict__ dgb,
                                   float* __restrict__ db_part, int T, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = 4 * H, ldw = N + KPAD;
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem);  // [H][ldw], Wh as stored
  __nv_bfloat16* dgs = whs + H * ldw;                            // [2][BM][ldw]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int col0 = warp * WH;

  for (int i = tid; i < H * (N / 8); i += blockDim.x) {
    const int j = i / (N / 8), c = (i % (N / 8)) * 8;
    *reinterpret_cast<uint4*>(whs + j * ldw + c) =
        *reinterpret_cast<const uint4*>(wh + (size_t)j * N + c);
  }

  float dh[2][2][4], dc[2][2][4];  // fp32 carries: [m16 tile][n8 tile][fragment]
  float dbs[4][2][2];              // db over this thread's rows: [gate][n8 tile][column]
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
        dc[mi][nj][half * 2] = dc[mi][nj][half * 2 + 1] = 0.f;
      }
    }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) dbs[g][nj][0] = dbs[g][nj][1] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = T - 1; t >= 0; --t) {
    __nv_bfloat16* dg = dgs + cur * BM * ldw;
    const float* mt = mask + (size_t)t * B;
    float base[2][2][4];  // (1-m)·dh_t

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
          float2 gp[4], dy = make_float2(0.f, 0.f), cp = dy;
#pragma unroll
          for (int g = 0; g < 4; ++g) gp[g] = dy;
          if (valid) {
            const float* gr = gates + tb * N + col;
#pragma unroll
            for (int g = 0; g < 4; ++g) gp[g] = *reinterpret_cast<const float2*>(gr + g * H);
            dy = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(dys + tb * H + col));
            if (t > 0)
              cp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  cs + (tb - B) * H + col));
          }
          const float cprev[2] = {cp.x, cp.y}, dyv[2] = {dy.x, dy.y};
          float dgt[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = half * 2 + e;
            const float ip = e ? gp[0].y : gp[0].x, fp = e ? gp[1].y : gp[1].x;
            const float gg = e ? gp[2].y : gp[2].x, op = e ? gp[3].y : gp[3].x;
            const float dh_t = dh[mi][nj][q] + dyv[e];
            const float g = m * dh_t;  // d h_new
            const float si = sse::sigmoid(ip);
            const float sf = sse::sigmoid(fp + 1.f);
            const float tg = tanhf(gg);
            const float so = sse::sigmoid(op);
            const float cnew = sf * cprev[e] + si * tg;
            const float tc = tanhf(cnew);
            const float dc_t = dc[mi][nj][q];
            const float dcn = m * dc_t + g * so * (1.f - tc * tc);
            dgt[3][e] = g * tc * so * (1.f - so);
            dgt[1][e] = dcn * cprev[e] * sf * (1.f - sf);
            dgt[0][e] = dcn * tg * si * (1.f - si);
            dgt[2][e] = dcn * si * (1.f - tg * tg);
            base[mi][nj][q] = (1.f - m) * dh_t;
            dc[mi][nj][q] = (1.f - m) * dc_t + dcn * sf;
#pragma unroll
            for (int gi = 0; gi < 4; ++gi) dbs[gi][nj][e] += dgt[gi][e];
          }
          __nv_bfloat16* ds = dg + rl * ldw + col;
          __nv_bfloat16* dgl = dgb + tb * N + col;
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(dgt[gi][0], dgt[gi][1]);
            *reinterpret_cast<__nv_bfloat162*>(ds + gi * H) = v;
            if (valid) *reinterpret_cast<__nv_bfloat162*>(dgl + gi * H) = v;
          }
        }
      }
    __syncthreads();

    // dh = base + dgates_b·Whᵀ over K = 4H
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
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
        for (int q = 0; q < 4; ++q) dh[mi][nj][q] = base[mi][nj][q] + acc[mi][nj][q];
    cur ^= 1;
  }

  // db partial of this block: sum the 8 row groups with a fixed shuffle tree
#pragma unroll
  for (int g = 0; g < 4; ++g)
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

// Shared memory of the serial kernel; the wrapper rejects shapes above the
// 232,448-byte opt-in limit before launching (H > 128 among them).
extern "C" int sse_lstm_bwd_smem_bytes(int H) {
  return (H * (4 * H + KPAD) + 2 * BM * (4 * H + KPAD)) * (int)sizeof(__nv_bfloat16);
}

// Rows of the batch one serial block owns (the db partials come one per block).
extern "C" int sse_lstm_bwd_block_rows() { return BM; }

// One LSTM layer backward. xs [T,B,E], ys, cs, dys [T,B,H] bf16; mask
// [T,1,B], dfin [B,H], bias [4H] fp32; wx [E,4H], wh [H,4H] and
// wt = [Wx;Wh]ᵀ [4H,E+H] bf16. Scratch from the wrapper: gates [T·B,4H]
// fp32, dgb [T·B,4H] bf16, db_part [ceil(B/32),4H] and w_part
// [splits,E+H,4H] fp32. Out: dxs [T,B,E] bf16, dw [E+H,4H] (dWx over
// dWh) and db [4H] fp32. T, B >= 1; E, H multiples of 16.
extern "C" int sse_lstm_bwd(const void* xs, const void* ys, const void* cs, const void* mask,
                            const void* wt, const void* wx, const void* wh,
                            const void* bias, const void* dys, const void* dfin,
                            void* gates, void* dgb, void* db_part, void* w_part,
                            void* dxs, void* dw, void* db, int T, int B, int E, int H,
                            int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = T * B, N = 4 * H, K = E + H;
  const Mat xh = {static_cast<const __nv_bfloat16*>(xs), E, E,
                  static_cast<const __nv_bfloat16*>(ys), H, B, M, K};  // [xs ; h_prev]
  cudaError_t err;

  // 1. gates = [xs ; h_prev]·[Wx ; Wh] + b
  err = launch_gates(xh, static_cast<const __nv_bfloat16*>(wt), M, N, K,
                     static_cast<const float*>(bias), static_cast<float*>(gates), st);
  if (err != cudaSuccess) return (int)err;

  // 2. the serial dh / dc loop
  const int smem = sse_lstm_bwd_smem_bytes(H);
  err = cudaFuncSetAttribute(lstm_bwd_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cdiv(B, BM);
  lstm_bwd_dh_kernel<<<nblk, 32 * (H / WH), smem, st>>>(
      static_cast<const float*>(gates), static_cast<const __nv_bfloat16*>(cs),
      static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(dys), static_cast<const float*>(dfin),
      static_cast<__nv_bfloat16*>(dgb), static_cast<float*>(db_part), T, B, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 3-5. dxs = bf16(dgates_b·Wxᵀ), the split-K dW partials, their in-order sums
  return (int)launch_bwd_products(
      xh, static_cast<const __nv_bfloat16*>(dgb), static_cast<const __nv_bfloat16*>(wx), M, N, E,
      splits, static_cast<float*>(w_part), static_cast<const float*>(db_part), nblk, dxs,
      static_cast<float*>(dw), static_cast<float*>(db), st);
}
