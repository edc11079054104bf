// Fused GRU layer forward for Hopper (sm_90a).
//
// Replaces sse_tpu/ops/pallas_rnn.py:_layer_fwd_pallas → _fwd_gru_kernel
// (_fwd_core). One launch runs a whole recurrent layer:
//   gates_t = (xs_t·Wx + b) + bf16(h_{t-1})·Wh   (bf16 operands, fp32 sums in that order)
//   h_new   = (1-z)·tanh(r·n_pre) + z·h_{t-1}     (fused-reset GRU cell)
//   h_t     = m_t·h_new + (1-m_t)·h_{t-1}         (carry frozen past length)
// emitting ys [T,B,H] bf16 and fin [B,H] fp32. As on the TPU, the
// x-projection is computed inside the kernel, step by step.
//
// What bounds it on the H100: the recurrence is serial over T, so the only
// parallelism is the batch, and each step waits for every warp's bf16(h)
// of the step before. At the batches the main path runs (8 to 384 rows,
// 1 to 48 SMs) a step is a chain of the h-part's tensor-core products
// (mma.sync issue) and the cell's dependent math (each IEEE division and
// tanhf a branch the compiler schedules alone). The design:
//
// * Transposed products: gatesᵀ = Wᵀ·[xs;h]ᵀ, so the 3H gate columns are
//   the m16 rows of mma.sync and 8 batch rows one n8 tile. A block takes
//   one tile (B=8 computes 8 rows, not a padded 16; B=256 and 384 run on
//   32 and 48 SMs), or two where one-tile blocks would fill the SMs more
//   than once (B=4096: 256 blocks), which then share every weight
//   fragment. Each warp issues 3 products a k16 slice and tile.
// * Weights: the wrapper passes [Wx;Wh]ᵀ [3H, E+H] bf16 (the layout the
//   backward uses too; RNNLayer builds it once). At E=H=128 each warp
//   holds its Whᵀ fragments in registers (96 a thread), so the h-part
//   reads only h from shared memory; Wxᵀ is copied into padded shared
//   rows with 16-byte cp.async (104,448 B). No transposing loads.
// * Step inputs: the xs tile (rows x E bf16) and the mask of step t+3 are
//   copied by cp.async into a 3-slot shared ring while step t runs; step
//   t+1's x-part (xs·Wx, then + b from registers: _fwd_core's sum order)
//   is computed during step t's cell into its own accumulators, so after
//   each barrier only the h-part and the cell are on the chain. ys leaves
//   from the shared h tile in 16-byte stores, off the chain too.
// * The cell is staged: exponentials first, then the divisions back to
//   back beside the x-part's slices, then the tanh (sse::sigmoid's and
//   tanhf's values, bit for bit).
// * E and H are template arguments at E=H=128, so every k loop unrolls.
//   Other widths take a generic one-tile instance: Whᵀ in shared memory
//   too, xs and the mask read from global memory.
//
// Warp w owns hidden units [16w, 16w+16) of all three gates (z, r, n): its
// three m16 tiles, so the cell needs no cross-warp exchange. The h carry
// stays fp32 in registers and, rounded to bf16, in a double-buffered
// shared [rows][H] tile that is the next step's B operand.
#include "common.cuh"

namespace {

constexpr int BN = 8;       // batch rows of one n8 tile (a block takes one or two)
constexpr int WH = 16;      // hidden units per warp: one m16 tile per gate
constexpr int KPAD = 8;     // bf16 row padding: conflict-free 32-bit fragment loads
constexpr int RING = 3;     // xs slots: step t+3's tile is copied while step t runs
constexpr int MSLOTS = 4;   // mask slots: mask_t is read in step t, after slot t%3 is refilled
constexpr int MAX_THREADS = 352;      // 2H threads; H <= 176 is what shared memory allows

// Byte offsets of the shared buffers for blocks of `rows` batch rows:
// weights [3H][ldw], [2][rows][ldh] bf16 h tiles and, in the E=H=128
// instance (`fixed`), [RING][rows][ldx] xs tiles and [MSLOTS][rows] masks.
// That instance holds Whᵀ in registers and stages only Wxᵀ; the generic
// one stages [Wx;Wh]ᵀ and reads xs and the mask from global memory.
struct Layout {
  int kw, ldw, ldh, ldx, w, h, x, m, total;
};

__host__ __device__ inline Layout layout(int E, int H, bool fixed, int rows) {
  Layout L;
  L.kw = fixed ? E : E + H;  // weight columns held in shared memory
  L.ldw = L.kw + KPAD;
  L.ldh = H + KPAD;
  L.ldx = E + KPAD;
  L.w = 0;
  L.h = L.w + 3 * H * L.ldw * 2;
  L.x = L.h + 2 * rows * L.ldh * 2;
  L.m = L.x + (fixed ? RING * rows * L.ldx * 2 : 0);
  L.total = L.m + (fixed ? MSLOTS * rows * 4 : 0);
  return L;
}

// B fragment (k16 x n8) of 8 rows of a row-major bf16 tile read as its
// transpose: p points at row grp, column k + 2·tig.
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const __nv_bfloat16* p) {
  b[0] = sse::ld32(p);
  b[1] = sse::ld32(p + 8);
}

// KE, KH: E and H at compile time, with the Whᵀ fragments in registers
// and the step inputs through the shared ring (0: E and H from the
// arguments, Whᵀ in shared memory, inputs from global memory). NB: n8
// tiles of batch rows a block (a second one, where the batch fills the
// SMs more than once, shares every weight fragment between the two).
template <int KE, int KH, int NB>
__global__ void __launch_bounds__(KH ? 2 * KH : MAX_THREADS, 1)
gru_fwd_kernel(const __nv_bfloat16* __restrict__ xs, const float* __restrict__ mask,
               const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ ys, float* __restrict__ fin, int T, int B,
               int e_arg, int h_arg) {
  constexpr bool FIXED = KH != 0;
  constexpr int R = BN * NB;  // batch rows a block
  const int E = KE ? KE : e_arg, H = KH ? KH : h_arg;
  const int K = E + H;
  const Layout L = layout(E, H, FIXED, R);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  __nv_bfloat16* xr = reinterpret_cast<__nv_bfloat16*>(smem + L.x);
  float* mr = reinterpret_cast<float*>(smem + L.m);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * R;
  const int u0 = warp * WH + grp;  // this thread's units: u0 and u0 + 8
  // this thread's A fragments of gate g start at wa + g·H·ldw (+ k)
  const __nv_bfloat16* wa = ws + u0 * L.ldw + 2 * tig;

  // step s's xs tile into ring slot s % RING and its mask into slot
  // s % MSLOTS (rows >= B zero-filled), as one group of copies
  auto fetch = [&](int s) {
    if (s < T) {
      __nv_bfloat16* dst = xr + (s % RING) * R * L.ldx;
      const __nv_bfloat16* src = xs + (size_t)s * B * E;
      const int pieces = E / 8;
      for (int q = tid; q < R * pieces; q += blockDim.x) {
        const int r = q / pieces, c = (q - r * pieces) * 8;
        const bool v = row0 + r < B;
        sse::cp_async16(dst + r * L.ldx + c, src + (size_t)(v ? row0 + r : 0) * E + c, v);
      }
      if (tid < R) {
        const bool v = row0 + tid < B;
        sse::cp_async4(mr + (s % MSLOTS) * R + tid, mask + (size_t)s * B + (v ? row0 + tid : 0), v);
      }
    }
    sse::cp_async_commit();
  };

  // ys_s (the rows < B) from a shared bf16 h tile, 16 bytes a store
  auto store_ys = [&](int s, const __nv_bfloat16* tile) {
    for (int q = tid; q < R * (H / 8); q += blockDim.x) {
      const int r = q / (H / 8), c = (q - r * (H / 8)) * 8;
      if (row0 + r < B)
        *reinterpret_cast<uint4*>(ys + ((size_t)s * B + row0 + r) * H + c) =
            *reinterpret_cast<const uint4*>(tile + r * L.ldh + c);
    }
  };

  // the weight columns kept in shared memory into padded rows, 16 bytes a
  // copy; zero h_{-1}
  const int wpieces = L.kw / 8;
  for (int q = tid; q < 3 * H * wpieces; q += blockDim.x) {
    const int n = q / wpieces, c = (q - n * wpieces) * 8;
    sse::cp_async16(ws + n * L.ldw + c, wt + (size_t)n * K + c, true);
  }
  for (int i = tid; i < 2 * R * L.ldh; i += blockDim.x) hs[i] = __float2bfloat16(0.f);
  if constexpr (FIXED) {
    fetch(0);  // with the weights
    fetch(1);
    fetch(2);
  } else {
    sse::cp_async_commit();
  }

  // Whᵀ fragments of this warp's three m16 tiles, one per k16 slice
  constexpr int NKH = KH ? KH / 16 : 1;
  uint32_t whr[3][NKH][4];
  if constexpr (FIXED) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int kq = 0; kq < NKH; ++kq)
        sse::frag_a(whr[g][kq], wt + (size_t)(g * H + u0) * K + E + 16 * kq + 2 * tig, K);
  }
  float bv[3][2];  // the bias of this thread's units, per gate
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    bv[g][0] = bias[g * H + u0];
    bv[g][1] = bias[g * H + u0 + 8];
  }
  if constexpr (FIXED) sse::cp_async_wait<1>();  // the weights, steps 0 and 1
  else sse::cp_async_wait<0>();
  __syncthreads();

  // x-part slice kk of step s into a[j][g]: B from the ring slot or global xs
  auto x_slice = [&](float (&a)[NB][3][4], int s, int kk) {
    uint32_t b[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if constexpr (FIXED) {
        frag_b(b[j], xr + (s % RING) * R * L.ldx + (8 * j + grp) * L.ldx + kk + 2 * tig);
      } else {
        const int r = row0 + 8 * j + grp;
        const __nv_bfloat16* p = xs + ((size_t)s * B + r) * E + kk + 2 * tig;
        const bool v = s < T && r < B;
        b[j][0] = v ? sse::ld32(p) : 0u;
        b[j][1] = v ? sse::ld32(p + 8) : 0u;
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      uint32_t f[4];
      sse::frag_a(f, wa + g * H * L.ldw + kk, L.ldw);
#pragma unroll
      for (int j = 0; j < NB; ++j) sse::mma_bf16(a[j][g], f, b[j][0], b[j][1]);
    }
  };
  auto add_bias = [&](float (&a)[NB][3][4]) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        a[j][g][0] += bv[g][0];
        a[j][g][1] += bv[g][0];
        a[j][g][2] += bv[g][1];
        a[j][g][3] += bv[g][1];
      }
  };

  // step 0's x-part + b; the loop computes each next step's during the
  // current. Fragment c of tile j: unit u0 + 8·(c >> 1), row 8·j + 2·tig + (c & 1).
  float acc[NB][3][4] = {};
#pragma unroll
  for (int kk = 0; kk < E; kk += 16) x_slice(acc, 0, kk);
  add_bias(acc);
  __syncthreads();  // slot 0 is read; step 0 refills it

  float h[NB][4] = {};  // fp32 carry, at acc's positions
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hc = hs + cur * R * L.ldh;

    // h-part of step t: the chain
#pragma unroll
    for (int kk = 0; kk < H; kk += 16) {
      uint32_t b[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) frag_b(b[j], hc + (8 * j + grp) * L.ldh + kk + 2 * tig);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        uint32_t f[4];
        if constexpr (FIXED) {
#pragma unroll
          for (int q = 0; q < 4; ++q) f[q] = whr[g][kk / 16][q];
        } else {
          sse::frag_a(f, wa + g * H * L.ldw + E + kk, L.ldw);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) sse::mma_bf16(acc[j][g], f, b[j][0], b[j][1]);
      }
    }
    // while it runs: step t+3's inputs into the ring, and ys_{t-1} from
    // the h tile the h-part reads
    if constexpr (FIXED) fetch(t + RING);
    if (t > 0) store_ys(t - 1, hc);

    // The cell. Each IEEE division and each tanhf is a branch that the
    // compiler schedules on its own, so the exponentials come first, then
    // the divisions back to back, beside two k16 slices of step t+1's
    // x-part at a time (whose products run while the divisions wait), then
    // the tanh and the carry. (Step T's x-part reads a stale slot; it is
    // never used.)
    float nxt[NB][3][4] = {};  // step t+1's x-part
    float z[NB][4], rg[NB][4], n[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        z[j][c] = expf(-acc[j][0][c]);
        rg[j][c] = expf(-acc[j][1][c]);
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (32 * c < E) x_slice(nxt, t + 1, 32 * c);
      if (32 * c + 16 < E) x_slice(nxt, t + 1, 32 * c + 16);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        z[j][c] = sse::sigmoid_exp(z[j][c]);
        rg[j][c] = sse::sigmoid_exp(rg[j][c]);
      }
    }
    for (int kk = 128; kk < E; kk += 16) x_slice(nxt, t + 1, kk);  // E > 128
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) n[j][c] = tanhf(acc[j][2][c] * rg[j][c]);

    // masked carry, then publish bf16(h): the next step's B operand (ys_t
    // is stored from it during the next step)
    __nv_bfloat16* hn = hs + (cur ^ 1) * R * L.ldh;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float m[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * tig + e;
        if constexpr (FIXED) m[e] = mr[(t % MSLOTS) * R + r];
        else m[e] = row0 + r < B ? mask[(size_t)t * B + row0 + r] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float hnew = (1.f - z[j][c]) * n[j][c] + z[j][c] * h[j][c];
        h[j][c] = m[c & 1] * hnew + (1.f - m[c & 1]) * h[j][c];
        hn[(8 * j + 2 * tig + (c & 1)) * L.ldh + u0 + 8 * (c >> 1)] = __float2bfloat16(h[j][c]);
      }
    }
    add_bias(nxt);
    if constexpr (FIXED) sse::cp_async_wait<1>();  // step t+2's inputs
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][g][c] = nxt[j][g][c];
    cur ^= 1;
  }
  if (T > 0) store_ys(T - 1, hs + cur * R * L.ldh);

#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row0 + 8 * j + 2 * tig + (c & 1);
      if (r < B) fin[(size_t)r * H + u0 + 8 * (c >> 1)] = h[j][c];
    }
}

template <int KE, int KH, int NB>
int launch(const void* xs, const void* mask, const void* wt, const void* bias, void* ys,
           void* fin, int T, int B, int E, int H, cudaStream_t st) {
  const int smem = layout(E, H, KH != 0, BN * NB).total;
  auto* kernel = gru_fwd_kernel<KE, KH, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + BN * NB - 1) / (BN * NB), 32 * (H / WH), smem, st>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(ys), static_cast<float*>(fin), T, B, E, H);
  return (int)cudaGetLastError();
}

// Blocks of 8 rows until they would fill the card's SMs more than once;
// then 16 (E=H=128 only).
bool two_tiles(int B) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  return B > BN * sms;
}

}  // namespace

// Shared memory one block needs, at most (E=H=128: Wxᵀ and the ring, 16
// rows; else [Wx;Wh]ᵀ, 8 rows); the wrapper rejects shapes above the
// 232,448-byte opt-in limit before launching.
extern "C" int sse_gru_fwd_smem_bytes(int E, int H) {
  const bool fixed = E == 128 && H == 128;
  return layout(E, H, fixed, fixed ? 2 * BN : BN).total;
}

// One GRU layer forward. xs [T,B,E] bf16, mask [T,1,B] fp32, wt =
// [Wx;Wh]ᵀ [3H,E+H] bf16, bias [3H] fp32 → ys [T,B,H] bf16, fin [B,H]
// fp32. T, B >= 1; E, H multiples of 16; every pointer 16-byte aligned.
extern "C" int sse_gru_fwd(const void* xs, const void* mask, const void* wt, const void* bias,
                           void* ys, void* fin, int T, int B, int E, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E == 128 && H == 128)
    return two_tiles(B) ? launch<128, 128, 2>(xs, mask, wt, bias, ys, fin, T, B, E, H, st)
                        : launch<128, 128, 1>(xs, mask, wt, bias, ys, fin, T, B, E, H, st);
  return launch<0, 0, 1>(xs, mask, wt, bias, ys, fin, T, B, E, H, st);
}
