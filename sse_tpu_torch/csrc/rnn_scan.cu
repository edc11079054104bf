// Recurrence over precomputed x-side pre-activations, and the LSTM layer
// forward built on it, for Hopper (sm_90a).
//
// Replaces two TPU kernels of sse_tpu/ops/pallas_rnn.py:
//   * scan_layer (_gru_kernel, _lstm_kernel; kernel 1): given
//     ax [T,B,G·H] fp32 = xs·Wx + b for all steps, run
//       gates_t = ax_t + bf16(h_{t-1})·Wh      (bf16 operands, fp32 sums)
//       the cell (GRU fused-reset, or LSTM with the +1 forget bias)
//       h_t = m_t·h_new + (1-m_t)·h_{t-1},  c likewise (carry frozen past length)
//     emitting ys = bf16(h) [T,B,H], fin = h [B,H] fp32 and, for the
//     LSTM forward, cs = bf16(c) [T,B,H] after the mask;
//   * _layer_fwd_pallas, LSTM (_fwd_lstm_kernel → _fwd_core; kernel 3):
//     sse_lstm_fwd = one tiled product for ax over all T·B rows
//     (gemm_tiles.cuh, EPI_GATES) + this scan. Summed in this order,
//     ax + bf16(h)·Wh is _fwd_core's (xs·Wx + b) + h·Wh.
//
// Why two launches for the LSTM, where gru_fwd.cu fuses its layer: that
// design keeps Wxᵀ in shared memory and each warp's Whᵀ fragments in
// registers (96 a thread at E=H=128, 180 registers in all). With four
// gates Whᵀ alone would be 128 registers a thread, beside a cell that
// also carries c, and [Wx;Wh]ᵀ all in shared memory is 4·128·(256+8)·2 =
// 270,336 B, above the 232,448-byte opt-in limit. The scan keeps only
// Whᵀ: (4·128·136 + 2·32·136)·2 = 156,672 B. The price is the ax round trip through device
// memory, 2·T·B·4H·4 bytes: 0.84 GB at B=4096, T=50, ~0.25 ms at
// 3.35 TB/s. A fused design (a thread-block cluster sharing the weights
// through distributed shared memory, or Wx streamed from L2) is later work.
//
// What bounds the scan on the H100: the chain over T. One block owns
// BM=32 batch rows for all T steps (ceil(B/32) blocks: 1 SM at B=8, 128 at
// B=4096); each step is one dependent mma.sync sweep over K=H and a
// barrier, plus the step's ax loads (issued before the sweep, which hides
// their latency behind it). The h and c carries stay fp32 in registers;
// bf16(h) sits in a double-buffered shared tile that is the next step's A
// operand. Warp w owns hidden units [16w, 16w+16) of every gate, so the
// cell needs no exchange between warps (gru_fwd.cu's layout). A thread
// keeps its ax values, gate sums and both carries in registers (243 for
// the LSTM instance, 167 for the GRU's), so 2H threads cap the LSTM scan
// at H=128: sse_rnn_scan_max_threads lets the wrappers check it.
#include "gemm_tiles.cuh"

namespace {

constexpr int BM = 32;    // batch rows per block: two m16 tiles
constexpr int WH = 16;    // hidden units per warp (two n8 tiles per gate)
constexpr int KPAD = 8;   // bf16 row padding: spreads fragment loads over banks

template <int G>  // gates: 3 = GRU (z, r, n), 4 = LSTM (i, f, g, o)
__global__ void rnn_scan_kernel(const float* __restrict__ ax,
                                const float* __restrict__ mask,
                                const __nv_bfloat16* __restrict__ wh,
                                __nv_bfloat16* __restrict__ ys,
                                float* __restrict__ fin,
                                __nv_bfloat16* __restrict__ cs,  // LSTM only; may be null
                                int T, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = G * H, ldw = H + KPAD;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [N][ldw]: Whᵀ
  __nv_bfloat16* hs = wt + N * ldw;                              // [2][BM][ldw]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int col0 = warp * WH;

  // Whᵀ: wt[n][k] = Wh[k][n], so a B fragment is one 32-bit load
  for (int i = tid; i < H * N; i += blockDim.x) {
    const int k = i / N, n = i - k * N;
    wt[n * ldw + k] = wh[i];
  }
  for (int i = tid; i < 2 * BM * ldw; i += blockDim.x) hs[i] = __float2bfloat16(0.f);
  __syncthreads();

  float h[2][2][4], c[2][2][4];  // fp32 carries: [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) h[mi][nj][q] = c[mi][nj][q] = 0.f;

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    // the step's x-side pre-activations, for this thread's (row, unit)s
    float a[2][G][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mi * 16 + grp + half * 8;
        const float* at = ax + ((size_t)t * B + r) * N;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            float2 v = make_float2(0.f, 0.f);
            if (r < B) v = *reinterpret_cast<const float2*>(at + g * H + col0 + nj * 8 + 2 * tig);
            a[mi][g][nj][half * 2] = v.x;
            a[mi][g][nj][half * 2 + 1] = v.y;
          }
      }

    // bf16(h_{t-1})·Wh from the carry tile
    float acc[2][G][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][g][nj][q] = 0.f;
    const __nv_bfloat16* hc = hs + cur * BM * ldw;
    for (int kk = 0; kk < H; kk += 16) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p0 = hc + (mi * 16 + grp) * ldw + kk + 2 * tig;
        fa[mi][0] = sse::ld32(p0);
        fa[mi][1] = sse::ld32(p0 + 8 * ldw);
        fa[mi][2] = sse::ld32(p0 + 8);
        fa[mi][3] = sse::ld32(p0 + 8 * ldw + 8);
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const __nv_bfloat16* wb = wt + (g * H + col0 + nj * 8 + grp) * ldw + kk + 2 * tig;
          const uint32_t b0 = sse::ld32(wb), b1 = sse::ld32(wb + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) sse::mma_bf16(acc[mi][g][nj], fa[mi], b0, b1);
        }
    }

    // cell + masked carries; publish bf16(h) for the next step, ys and cs
    __nv_bfloat16* hn = hs + (cur ^ 1) * BM * ldw;
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
            const int q = half * 2 + e;
            float gt[G];
#pragma unroll
            for (int g = 0; g < G; ++g) gt[g] = a[mi][g][nj][q] + acc[mi][g][nj][q];
            const float hp = h[mi][nj][q];
            float hnew;
            if (G == 3) {
              const float z = sse::sigmoid(gt[0]);
              const float rg = sse::sigmoid(gt[1]);
              const float n = tanhf(gt[2] * rg);
              hnew = (1.f - z) * n + z * hp;
            } else {
              const float cp = c[mi][nj][q];
              const float cnew = sse::sigmoid(gt[1] + 1.f) * cp +
                                 sse::sigmoid(gt[0]) * tanhf(gt[2]);
              hnew = sse::sigmoid(gt[G - 1]) * tanhf(cnew);
              c[mi][nj][q] = m * cnew + (1.f - m) * cp;
            }
            h[mi][nj][q] = m * hnew + (1.f - m) * hp;
          }
          const int col = col0 + nj * 8 + 2 * tig;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(h[mi][nj][half * 2], h[mi][nj][half * 2 + 1]);
          *reinterpret_cast<__nv_bfloat162*>(hn + rl * ldw + col) = v;
          if (r < B) {
            const size_t o = ((size_t)t * B + r) * H + col;
            *reinterpret_cast<__nv_bfloat162*>(ys + o) = v;
            if (G == 4 && cs != nullptr)
              *reinterpret_cast<__nv_bfloat162*>(cs + o) =
                  __floats2bfloat162_rn(c[mi][nj][half * 2], c[mi][nj][half * 2 + 1]);
          }
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

template <int G>
cudaError_t launch_scan(const float* ax, const float* mask, const __nv_bfloat16* wh,
                        __nv_bfloat16* ys, float* fin, __nv_bfloat16* cs, int T, int B,
                        int H, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(rnn_scan_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rnn_scan_kernel<G><<<cdiv(B, BM), 32 * (H / WH), smem, st>>>(ax, mask, wh, ys, fin, cs, T,
                                                                B, H);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one scan block for G gates; the wrappers reject shapes
// above the 232,448-byte opt-in limit before launching.
extern "C" int sse_rnn_scan_smem_bytes(int G, int H) {
  return (G * H * (H + KPAD) + 2 * BM * (H + KPAD)) * (int)sizeof(__nv_bfloat16);
}

// Most threads one scan block can have, as its registers allow (the LSTM
// instance holds ~240 a thread, so 256 threads, H=128, is its limit); the
// wrappers reject H with 2H threads above it before launching.
extern "C" int sse_rnn_scan_max_threads(int G) {
  cudaFuncAttributes a;
  const cudaError_t err = G == 3 ? cudaFuncGetAttributes(&a, rnn_scan_kernel<3>)
                                 : cudaFuncGetAttributes(&a, rnn_scan_kernel<4>);
  return err == cudaSuccess ? a.maxThreadsPerBlock : 0;
}

// Kernel 1. ax [T,B,G·H] fp32, mask [T,1,B] fp32, wh [H,G·H] bf16 → ys
// [T,B,H] bf16, fin [B,H] fp32 (no c stream: the scan alone has no
// backward). T, B >= 1; H a multiple of 16.
extern "C" int sse_rnn_scan(const void* ax, const void* mask, const void* wh, void* ys,
                            void* fin, int T, int B, int H, int G, void* stream) {
  const int smem = sse_rnn_scan_smem_bytes(G, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(ax);
  const auto* m = static_cast<const float*>(mask);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* y = static_cast<__nv_bfloat16*>(ys);
  auto* f = static_cast<float*>(fin);
  if (G == 3) return (int)launch_scan<3>(a, m, w, y, f, nullptr, T, B, H, smem, st);
  if (G == 4) return (int)launch_scan<4>(a, m, w, y, f, nullptr, T, B, H, smem, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel 3, the LSTM layer forward. xs [T,B,E] bf16, mask [T,1,B] fp32,
// wxt = Wxᵀ [4H,E] and wh [H,4H] bf16, bias [4H] fp32; scratch ax
// [T·B,4H] fp32. Out: ys, cs [T,B,H] bf16 and fin [B,H] fp32. T, B >= 1;
// E, H multiples of 16.
extern "C" int sse_lstm_fwd(const void* xs, const void* mask, const void* wxt,
                            const void* wh, const void* bias, void* ax, void* ys, void* fin,
                            void* cs, int T, int B, int E, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = T * B, N = 4 * H;
  const Mat x = {static_cast<const __nv_bfloat16*>(xs), E, E, nullptr, 0, 0, M, E};
  cudaError_t err = launch_gates(x, static_cast<const __nv_bfloat16*>(wxt), M, N, E,
                                 static_cast<const float*>(bias), static_cast<float*>(ax), st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_scan<4>(static_cast<const float*>(ax), static_cast<const float*>(mask),
                             static_cast<const __nv_bfloat16*>(wh),
                             static_cast<__nv_bfloat16*>(ys), static_cast<float*>(fin),
                             static_cast<__nv_bfloat16*>(cs), T, B, H,
                             sse_rnn_scan_smem_bytes(4, H), st);
}
