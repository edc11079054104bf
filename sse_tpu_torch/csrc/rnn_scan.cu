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
//     sse_rnn_fwd = one product for ax over all T·B rows (products.cu
//     gates_product_kernel, from the Wx columns of [Wx;Wh]ᵀ) + this scan.
//     Summed in this order, ax + bf16(h)·Wh is _fwd_core's (xs·Wx + b) +
//     h·Wh. The GRU layer forward (kernel 2) takes the same route where
//     gru_fwd.cu cannot hold its [Wx;Wh]ᵀ (E=256 at H=128, E=128 at H >
//     128, every H above 176): the order is also that of JAX's lax.scan
//     layer (towers.py _rnn_layer: ax + h·Wh).
//
// Why two launches for the LSTM, where gru_fwd.cu fuses its layer: with
// four gates Whᵀ alone takes the 128 registers a thread that gru_fwd.cu
// gives to Whᵀ and its x-part accumulators together, and [Wx;Wh]ᵀ all in
// shared memory is 4·128·(256+8)·2 = 270,336 B, above the 232,448-byte
// opt-in limit. The price is the ax round trip through device memory,
// 2·T·B·4H·4 bytes: 0.84 GB at B=4096, T=50, ~0.25 ms at 3.35 TB/s.
//
// What bounds the scan on the H100: the chain over T. The only
// parallelism is the batch, and each step waits for every warp's bf16(h)
// of the step before. The design keeps everything else off that chain:
//
// * Transposed products: gatesᵀ = Whᵀ·bf16(h)ᵀ, so the G·H gate columns
//   are the m16 rows of mma.sync and 8 batch rows one n8 tile. Warp w
//   owns units [16w, 16w+16) of all G gates (G m16 tiles), so the cell
//   needs no exchange between warps. A block takes one tile (B=8 computes
//   8 rows; B=128 and 256 run on 16 and 32 SMs), or two where that halves
//   the waves of blocks over the SMs (two_tiles).
// * Whᵀ comes as rows of a matrix with a row stride: for the layer
//   forward the Wh columns of [Wx;Wh]ᵀ (RNNLayer builds it once), for the
//   scan alone whᵀ. At H=128 each warp holds its fragments in registers
//   (4·8·4 = 128 a thread for the LSTM, 96 for the GRU), so a step reads
//   only the h tile from shared memory: 16 32-bit loads a thread.
// * Step inputs: the ax tile of step t+3 (fp32, rows x G·H: 16 KB for 8
//   rows at H=128, G=4) and its mask are copied by cp.async into a 4-slot
//   shared ring while step t runs; ys and cs leave from shared bf16 tiles
//   in 16-byte stores during the next step, off the chain.
// * The cell is staged: the exponentials first, then the divisions back
//   to back, then the tanhf's (sse::sigmoid's and tanhf's values, bit for
//   bit; the +1 forget bias where the reference adds it).
// * H=128 is a template instance (both cells). Other widths take a
//   generic one-tile instance: Whᵀ in shared memory, ax and the mask read
//   from global memory; shared memory caps it at H=160 (LSTM) and H=176
//   (GRU).
// * Wider layers take the cluster instance (rnn_scan_cluster_kernel,
//   below): Whᵀ split over C <= 8 blocks of a thread-block cluster, a
//   cluster carrying a tile of R batch rows. The wrapper's plan (ops/rnn.py
//   layer_plan) picks the instance and C from the shapes and checks the
//   shared memory before launching; the launch (scan_tile) picks R, and
//   may widen C, from B and the clusters the card holds at once.
//
// The h and c carries stay fp32 in registers at the accumulators'
// positions; bf16(h) sits in a double-buffered shared [rows][H] tile
// that is the next step's B operand, bf16(c) in another (for cs).
#include "cluster.cuh"
#include "products.cuh"

namespace {

constexpr int BN = 8;       // batch rows of one n8 tile (a block takes one or two)
constexpr int WH = 16;      // hidden units per warp: one m16 tile per gate
constexpr int KPAD = 8;     // bf16 row padding: conflict-free 32-bit fragment loads
constexpr int APAD = 4;     // fp32 ax row padding: rows 2·tig apart fall in distinct banks
constexpr int RING = 4;     // ax and mask slots: step t+3's are copied while step t runs
constexpr int MAX_THREADS = 352;  // 2H threads; H <= 176 is what shared memory allows

// Byte offsets of the shared buffers for blocks of `rows` batch rows:
// Whᵀ [G·H][ldw] bf16 (generic instance only), [2][rows][ldh] bf16 h and
// c tiles and, in the H=128 instance (`fixed`), [RING][rows][lda] fp32
// ax tiles and [RING][rows] masks.
struct Layout {
  int ldw, ldh, lda, w, h, c, a, m, total;
};

__host__ __device__ inline Layout layout(int G, int H, bool fixed, int rows) {
  Layout L;
  L.ldw = H + KPAD;
  L.ldh = H + KPAD;
  L.lda = G * H + APAD;
  L.w = 0;
  L.h = L.w + (fixed ? 0 : G * H * L.ldw * 2);
  L.c = L.h + 2 * rows * L.ldh * 2;
  L.a = L.c + (G == 4 ? 2 * rows * L.ldh * 2 : 0);
  L.m = L.a + (fixed ? RING * rows * L.lda * 4 : 0);
  L.total = L.m + (fixed ? RING * rows * 4 : 0);
  return L;
}

// G gates; KH: H at compile time, with the Whᵀ fragments in registers and
// the step inputs through the shared ring (0: H from the argument, Whᵀ in
// shared memory, inputs from global memory). NB: n8 tiles of batch rows a
// block (a second one shares every weight fragment with the first).
template <int G, int KH, int NB>
__global__ void __launch_bounds__(KH ? 2 * KH : MAX_THREADS, 1)
rnn_scan_kernel(const float* __restrict__ ax, const float* __restrict__ mask,
                const __nv_bfloat16* __restrict__ wt, int ldwt,
                __nv_bfloat16* __restrict__ ys, float* __restrict__ fin,
                __nv_bfloat16* __restrict__ cs,  // LSTM only; may be null
                int T, int B, int h_arg) {
  constexpr bool FIXED = KH != 0;
  constexpr int R = BN * NB;  // batch rows a block
  const int H = KH ? KH : h_arg, N = G * H;
  const Layout L = layout(G, H, FIXED, R);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  __nv_bfloat16* cts = reinterpret_cast<__nv_bfloat16*>(smem + L.c);
  float* ar = reinterpret_cast<float*>(smem + L.a);
  float* mr = reinterpret_cast<float*>(smem + L.m);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * R;
  const int u0 = warp * WH + grp;  // this thread's units: u0 and u0 + 8
  const bool want_c = G == 4 && cs != nullptr;

  // step s's ax tile into ring slot s % RING and its mask beside it
  // (rows >= B zero-filled), as one group of copies
  auto fetch = [&](int s) {
    if (s < T) {
      float* dst = ar + (s % RING) * R * L.lda;
      const float* src = ax + (size_t)s * B * N;
      const int pieces = N / 4;
      for (int q = tid; q < R * pieces; q += blockDim.x) {
        const int r = q / pieces, c = (q - r * pieces) * 4;
        const bool v = row0 + r < B;
        sse::cp_async16(dst + r * L.lda + c, src + (size_t)(v ? row0 + r : 0) * N + c, v);
      }
      if (tid < R) {
        const bool v = row0 + tid < B;
        sse::cp_async4(mr + (s % RING) * R + tid, mask + (size_t)s * B + (v ? row0 + tid : 0), v);
      }
    }
    sse::cp_async_commit();
  };

  // the rows < B of a shared bf16 [R][ldh] tile into out_s [B, H], 16
  // bytes a store
  auto store_tile = [&](__nv_bfloat16* out_s, const __nv_bfloat16* tile) {
    for (int q = tid; q < R * (H / 8); q += blockDim.x) {
      const int r = q / (H / 8), c = (q - r * (H / 8)) * 8;
      if (row0 + r < B)
        *reinterpret_cast<uint4*>(out_s + (size_t)(row0 + r) * H + c) =
            *reinterpret_cast<const uint4*>(tile + r * L.ldh + c);
    }
  };

  // Whᵀ into padded shared rows (generic instance), 16 bytes a copy;
  // zero h_{-1} (and c_{-1}); the first ring slots
  if constexpr (!FIXED) {
    const int wpieces = H / 8;
    for (int q = tid; q < N * wpieces; q += blockDim.x) {
      const int n = q / wpieces, c = (q - n * wpieces) * 8;
      sse::cp_async16(ws + n * L.ldw + c, wt + (size_t)n * ldwt + c, true);
    }
  }
  const int ntile = (G == 4 ? 4 : 2) * R * L.ldh;  // the h tiles, then the c tiles
  for (int i = tid; i < ntile; i += blockDim.x) hs[i] = __float2bfloat16(0.f);
  if constexpr (FIXED) {
#pragma unroll
    for (int s = 0; s < RING - 1; ++s) fetch(s);
  } else {
    sse::cp_async_commit();
  }

  // Whᵀ fragments of this warp's G m16 tiles, one per k16 slice
  constexpr int NK = KH ? KH / 16 : 1;
  uint32_t whr[G][NK][4];
  if constexpr (FIXED) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int kq = 0; kq < NK; ++kq)
        sse::frag_a(whr[g][kq], wt + (size_t)(g * H + u0) * ldwt + 16 * kq + 2 * tig, ldwt);
  }
  if constexpr (FIXED) sse::cp_async_wait<RING - 2>();  // step 0's inputs
  else sse::cp_async_wait<0>();                        // Whᵀ
  __syncthreads();

  // fp32 carries; fragment c of tile j: unit u0 + 8·(c >> 1), row
  // 8·j + 2·tig + (c & 1)
  float h[NB][4] = {}, c[NB][4] = {};
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hc = hs + cur * R * L.ldh;

    // bf16(h_{t-1})·Wh: the chain
    float acc[NB][G][4] = {};
#pragma unroll
    for (int kq = 0; kq < H / 16; ++kq) {
      uint32_t b[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const __nv_bfloat16* p = hc + (8 * j + grp) * L.ldh + 16 * kq + 2 * tig;
        b[j][0] = sse::ld32(p);
        b[j][1] = sse::ld32(p + 8);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t f[4];
        if constexpr (FIXED) {
#pragma unroll
          for (int q = 0; q < 4; ++q) f[q] = whr[g][kq][q];
        } else {
          sse::frag_a(f, ws + (g * H + u0) * L.ldw + 16 * kq + 2 * tig, L.ldw);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) sse::mma_bf16(acc[j][g], f, b[j][0], b[j][1]);
      }
    }
    // while it runs: step t+3's inputs into the slot step t-1 read, and
    // ys_{t-1} (cs_{t-1}) from the tiles step t-1 wrote
    if constexpr (FIXED) fetch(t + RING - 1);
    if (t > 0) {
      store_tile(ys + (size_t)(t - 1) * B * H, hc);
      if (want_c) store_tile(cs + (size_t)(t - 1) * B * H, cts + cur * R * L.ldh);
    }

    // gates = ax + h-part, at the accumulators' positions
    float m[NB][2];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * tig + e;
        if constexpr (FIXED) m[j][e] = mr[(t % RING) * R + r];
        else m[j][e] = row0 + r < B ? mask[(size_t)t * B + row0 + r] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 8 * j + 2 * tig + (q & 1), u = g * H + u0 + 8 * (q >> 1);
          float a;
          if constexpr (FIXED) a = ar[((t % RING) * R + r) * L.lda + u];
          else a = row0 + r < B ? ax[((size_t)t * B + row0 + r) * N + u] : 0.f;
          acc[j][g][q] = a + acc[j][g][q];
        }
    }

    // The cell. Each IEEE division and each tanhf is a branch that the
    // compiler schedules on its own: the exponentials first, then the
    // divisions back to back, then the tanhf's. The values are
    // sse::sigmoid's (sigmoid_exp(expf(-x))) and tanhf's.
    float hnew[NB][4];
    if constexpr (G == 3) {  // z, r, n: h' = (1-z)·tanh(r·n_pre) + z·h
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = expf(-acc[j][0][q]);
          acc[j][1][q] = expf(-acc[j][1][q]);
        }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = sse::sigmoid_exp(acc[j][0][q]);
          acc[j][1][q] = sse::sigmoid_exp(acc[j][1][q]);
        }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float z = acc[j][0][q], n = tanhf(acc[j][2][q] * acc[j][1][q]);
          hnew[j][q] = (1.f - z) * n + z * h[j][q];
        }
    } else {  // i, f, g, o: c' = σ(f+1)·c + σ(i)·tanh(g), h' = σ(o)·tanh(c')
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = expf(-acc[j][0][q]);
          acc[j][1][q] = expf(-(acc[j][1][q] + 1.f));
          acc[j][G - 1][q] = expf(-acc[j][G - 1][q]);
        }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = sse::sigmoid_exp(acc[j][0][q]);
          acc[j][1][q] = sse::sigmoid_exp(acc[j][1][q]);
          acc[j][G - 1][q] = sse::sigmoid_exp(acc[j][G - 1][q]);
        }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][2][q] = tanhf(acc[j][2][q]);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float cp = c[j][q];
          const float cnew = acc[j][1][q] * cp + acc[j][0][q] * acc[j][2][q];
          hnew[j][q] = acc[j][G - 1][q] * tanhf(cnew);
          c[j][q] = m[j][q & 1] * cnew + (1.f - m[j][q & 1]) * cp;
        }
    }

    // masked carry, then publish bf16(h) (and bf16(c)): the next step's B
    // operand, and ys_t (cs_t), stored from the tiles during the next step
    __nv_bfloat16* hn = hs + (cur ^ 1) * R * L.ldh;
    __nv_bfloat16* cn = cts + (cur ^ 1) * R * L.ldh;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mq = m[j][q & 1];
        h[j][q] = mq * hnew[j][q] + (1.f - mq) * h[j][q];
        const int o = (8 * j + 2 * tig + (q & 1)) * L.ldh + u0 + 8 * (q >> 1);
        hn[o] = __float2bfloat16(h[j][q]);
        if (want_c) cn[o] = __float2bfloat16(c[j][q]);
      }
    if constexpr (FIXED) sse::cp_async_wait<RING - 2>();  // step t+1's inputs
    __syncthreads();
    cur ^= 1;
  }
  if (T > 0) {
    store_tile(ys + (size_t)(T - 1) * B * H, hs + cur * R * L.ldh);
    if (want_c) store_tile(cs + (size_t)(T - 1) * B * H, cts + cur * R * L.ldh);
  }

#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + 8 * j + 2 * tig + (q & 1);
      if (r < B) fin[(size_t)r * H + u0 + 8 * (q >> 1)] = h[j][q];
    }
}

template <int G, int KH, int NB>
cudaError_t launch_scan(const float* ax, const float* mask, const __nv_bfloat16* wt, int ldwt,
                        __nv_bfloat16* ys, float* fin, __nv_bfloat16* cs, int T, int B, int H,
                        cudaStream_t st) {
  const int smem = layout(G, H, KH != 0, BN * NB).total;
  auto* kernel = rnn_scan_kernel<G, KH, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<cdiv(B, BN * NB), 32 * (H / WH), smem, st>>>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- clusters
// The cluster instance, for layers whose Whᵀ (G·H rows of H) outgrows one
// SM's shared memory: at H=256 the GRU's is 405,504 B, the LSTM's 540,672
// B. A cluster of C blocks owns one tile of R batch rows (R a multiple of
// 8, chosen at launch: ops/rnn.py scan_tile), and block r of the cluster
// owns units [r·H/C, (r+1)·H/C) of every gate: it holds the Whᵀ rows of
// those units (G·H/C rows of H) in its shared memory for all T steps, so
// a block does the multiply-adds of a layer C times narrower. What the
// blocks share is the step's B operand, the full bf16(h) tile [R][H]:
// double-buffered in every block.
//
// Inside a block, warp w owns 16 units of every gate (w mod H/(16·C): G
// m16 tiles) and one slice of the tile's rows (w div H/(16·C)): up to NJ
// n8 groups of 8 rows. For each k16 slice a warp reads the G Whᵀ A
// fragments of its units once and feeds each to the NJ mma's of its row
// groups, so a fragment read from shared memory does NJ products, not
// one; the NJ·G products of a slice are independent, and the step's chain
// stays one pass over k. A row's sums run over k in the same order for
// every R, slice and C (the generic single block's order), so neither
// where a row sits in the tile nor C changes its bits. Each step, each
// warp
//   1. computes its units' gates for its rows, ax_t + bf16(h_{t-1})·Wh,
//      and runs the staged cell on them;
//   2. writes its bf16(h_t) block (its rows x 16 units) into its own
//      block's next h tile, then copies it, 16 bytes a piece, into the
//      next h tile of every other block of the cluster
//      (st.shared::cluster);
//   3. meets the whole cluster at one barrier (arrive.release, then
//      wait.acquire).
// One barrier a step is enough because h is double-buffered: in step t a
// block writes only the tile that step t reads none of (any of its R
// rows), and it can write that tile again (step t+2) only after passing
// the barrier of step t+1, which no block reaches before every one of its
// warps has finished reading that tile, all R rows of it, in step t+1's
// products. A block exits only after the last step's barrier, past which
// nothing writes into another block, and nothing writes into a block
// before the barrier that follows its own set-up. ys, cs and fin leave
// from the block that owns the unit.
//
// What bounds it: the chain over T, as for the single block, plus one
// exchange and one cluster barrier a step; at large B, the waves of
// clusters over the card (one block an SM), which R cuts: an H100 80GB
// HBM3 (700 W) holds 30 clusters of 4 blocks at once, so the LSTM at
// H=256, B=4096 runs 3 waves of 48-row tiles where 8-row tiles took 18.
// A warp's step grows with its row groups (the chain of its loads, mma's
// and cell), while warps side by side cost little more than one, so a
// tile takes the fewest groups a warp that the registers allow
// (cluster_tile). A step's shared-memory traffic is each row slice's pass
// over the Whᵀ slice plus each unit group's pass over the h tile. ax is
// read from global memory one step ahead into registers (G·4·NJ floats
// a thread).
struct ClusterLayout {
  int hc, ldw, ldh, ldc, w, h, c, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int G, int H, int C, int R) {
  ClusterLayout L;
  L.hc = H / C;
  L.ldw = H + KPAD;
  L.ldh = H + KPAD;
  L.ldc = L.hc + KPAD;
  L.w = 0;
  L.h = L.w + G * L.hc * L.ldw * 2;
  L.c = L.h + 2 * R * L.ldh * 2;
  L.total = L.c + (G == 4 ? 2 * R * L.ldc * 2 : 0);
  return L;
}

// Threads a block takes at most when its warps carry NJ n8 row groups
// each: what one SM's registers hold (a thread's registers grow with NJ:
// measured by ptxas at most 128, 160-179 and 220-232 for NJ = 1, 2, 3)
__host__ __device__ constexpr int cl_threads_most(int NJ) {
  return NJ == 1 ? 512 : NJ == 2 ? 384 : 256;
}
// n8 row groups a warp carries at most: the LSTM's four gates spill
// registers at four
__host__ __device__ constexpr int cl_groups_most(int G) { return G == 4 ? 3 : 4; }

// A tile of R rows on a block of H/C units: S row slices of at most NJ
// groups each (the last slice may hold fewer), H/(16·C)·S warps. A step
// costs a warp about NJ times a group's chain, and warps side by side
// little more than one, so NJ is the fewest that cl_threads_most allows.
// threads = 0: no split of R rows fits a block.
struct ClusterTile {
  int S, NJ, threads;
};

inline ClusterTile cluster_tile(int G, int H, int C, int R) {
  const int groups = R / BN, warps = H / C / WH;
  for (int n = 1; n <= cl_groups_most(G); ++n) {
    const int S = cdiv(groups, n);
    if (32 * warps * S <= cl_threads_most(n)) return {S, cdiv(groups, S), 32 * warps * S};
  }
  return {0, 0, 0};
}

template <int G, int NJ>
__global__ void __launch_bounds__(cl_threads_most(NJ), 1)
rnn_scan_cluster_kernel(const float* __restrict__ ax, const float* __restrict__ mask,
                        const __nv_bfloat16* __restrict__ wt, int ldwt,
                        __nv_bfloat16* __restrict__ ys, float* __restrict__ fin,
                        __nv_bfloat16* __restrict__ cs,  // LSTM only; may be null
                        int T, int B, int H, int C, int R) {
  const int N = G * H;
  const ClusterLayout L = cluster_layout(G, H, C, R);
  const int HC = L.hc, UW = HC / WH;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
  __nv_bfloat16* cts = reinterpret_cast<__nv_bfloat16*>(smem + L.c);
  const int rank = sse::cluster_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int uw = warp % UW, slice = warp / UW;
  const int row0 = (blockIdx.x / C) * R;  // the cluster's first row
  const int r0 = slice * NJ * BN;         // this warp's first row in the tile
  const int nj = NJ == 1 ? 1 : min(NJ, R / BN - slice * NJ);  // ... and its row groups
  const int v0 = rank * HC;          // this block's first unit
  const int ul = uw * WH + grp;      // this thread's units, local: ul and ul + 8
  const int u0 = v0 + ul;            // ... and in the layer
  const bool want_c = G == 4 && cs != nullptr;

  // the Whᵀ rows of this block's units, gate by gate: local row g·HC + j
  // is row g·H + v0 + j of wt
  const int wpieces = H / 8;
  for (int q = tid; q < G * HC * wpieces; q += blockDim.x) {
    const int n = q / wpieces, c = (q - n * wpieces) * 8;
    const int g = n / HC, j = n - g * HC;
    sse::cp_async16(ws + n * L.ldw + c, wt + (size_t)(g * H + v0 + j) * ldwt + c, true);
  }
  sse::cp_async_commit();
  for (int i = tid; i < 2 * R * L.ldh; i += blockDim.x) hs[i] = __float2bfloat16(0.f);
  if (G == 4)
    for (int i = tid; i < 2 * R * L.ldc; i += blockDim.x) cts[i] = __float2bfloat16(0.f);
  sse::cp_async_wait<0>();
  sse::cluster_sync();  // every block of the cluster set up (Whᵀ, zero tiles)

  // step t's ax values and mask at this thread's fragment positions; row
  // 8·j + 2·tig + (q & 1) of the warp's rows
  float an[NJ][G][4], mn[NJ][2];
  auto load = [&](int t) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + r0 + 8 * j + 2 * tig + e;
        mn[j][e] = j < nj && r < B ? mask[(size_t)t * B + r] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = row0 + r0 + 8 * j + 2 * tig + (q & 1), u = g * H + u0 + 8 * (q >> 1);
          an[j][g][q] = j < nj && r < B ? ax[((size_t)t * B + r) * N + u] : 0.f;
        }
    }
  };
  // the rows < B of this block's columns of a shared bf16 tile into out_s
  // [B, H], 16 bytes a store (c tiles hold only this block's columns)
  auto store_own = [&](__nv_bfloat16* out_s, const __nv_bfloat16* tile, int ld, int col0) {
    for (int q = tid; q < R * (HC / 8); q += blockDim.x) {
      const int r = q / (HC / 8), c = (q - r * (HC / 8)) * 8;
      if (row0 + r < B)
        *reinterpret_cast<uint4*>(out_s + (size_t)(row0 + r) * H + v0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * ld + col0 + c);
    }
  };

  // the exchange: the warp's 8·nj rows x 16 units, two 16-byte pieces a
  // row, to each of the C-1 other blocks
  const unsigned pieces = 16 * nj;

  load(0);
  float h[NJ][4] = {}, c[NJ][4] = {};
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hc = hs + cur * R * L.ldh;

    // bf16(h_{t-1})·Wh for this warp's units and rows: the chain. No
    // branch inside it: a group past the warp's last (j >= nj, the short
    // last slice) reads that last group's rows and is never published
    float acc[NJ][G][4] = {};
    // unrolled so that a slice's loads issue over the last one's mma's;
    // deeper with one group a warp, where the registers allow it
#pragma unroll (NJ == 1 ? 4 : 2)
    for (int kq = 0; kq < H / 16; ++kq) {
      uint32_t b[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* p =
            hc + (r0 + 8 * min(j, nj - 1) + grp) * L.ldh + 16 * kq + 2 * tig;
        b[j][0] = sse::ld32(p);
        b[j][1] = sse::ld32(p + 8);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t f[4];
        sse::frag_a(f, ws + (g * HC + ul) * L.ldw + 16 * kq + 2 * tig, L.ldw);
#pragma unroll
        for (int j = 0; j < NJ; ++j) sse::mma_bf16(acc[j][g], f, b[j][0], b[j][1]);
      }
    }
    // ax_t into the sums
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][g][q] = an[j][g][q] + acc[j][g][q];
    // while the cell runs: ys_{t-1} (cs_{t-1}) and, with one group a warp,
    // step t+1's inputs (more groups load them after the cell, where
    // fewer registers are live)
    float m[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      m[j][0] = mn[j][0];
      m[j][1] = mn[j][1];
    }
    if (NJ == 1 && t + 1 < T) load(t + 1);
    if (t > 0) {
      store_own(ys + (size_t)(t - 1) * B * H, hc, L.ldh, v0);
      if (want_c) store_own(cs + (size_t)(t - 1) * B * H, cts + cur * R * L.ldc, L.ldc, 0);
    }

    // the cell, staged as in rnn_scan_kernel (the same values, bit for bit)
    float hnew[NJ][4];
    if constexpr (G == 3) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = expf(-acc[j][0][q]);
          acc[j][1][q] = expf(-acc[j][1][q]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = sse::sigmoid_exp(acc[j][0][q]);
          acc[j][1][q] = sse::sigmoid_exp(acc[j][1][q]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float z = acc[j][0][q], n = tanhf(acc[j][2][q] * acc[j][1][q]);
          hnew[j][q] = (1.f - z) * n + z * h[j][q];
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = expf(-acc[j][0][q]);
          acc[j][1][q] = expf(-(acc[j][1][q] + 1.f));
          acc[j][G - 1][q] = expf(-acc[j][G - 1][q]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[j][0][q] = sse::sigmoid_exp(acc[j][0][q]);
          acc[j][1][q] = sse::sigmoid_exp(acc[j][1][q]);
          acc[j][G - 1][q] = sse::sigmoid_exp(acc[j][G - 1][q]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][2][q] = tanhf(acc[j][2][q]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float cp = c[j][q];
          const float cnew = acc[j][1][q] * cp + acc[j][0][q] * acc[j][2][q];
          hnew[j][q] = acc[j][G - 1][q] * tanhf(cnew);
          c[j][q] = m[j][q & 1] * cnew + (1.f - m[j][q & 1]) * cp;
        }
    }

    // masked carry; bf16(h_t) into this block's next h tile (and bf16(c_t)
    // into its next c tile); step t+1's inputs where the cell did not take
    // them (the exchange, the barrier and step t+1's products give them
    // time to land); then the warp's block of h_t into every other block's
    // tile
    __nv_bfloat16* hn = hs + (cur ^ 1) * R * L.ldh;
    __nv_bfloat16* cn = cts + (cur ^ 1) * R * L.ldc;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mq = m[j][q & 1];
        h[j][q] = mq * hnew[j][q] + (1.f - mq) * h[j][q];
        const int r = r0 + 8 * j + 2 * tig + (q & 1), du = 8 * (q >> 1);
        if (j < nj) {
          hn[r * L.ldh + u0 + du] = __float2bfloat16(h[j][q]);
          if (G == 4) cn[r * L.ldc + ul + du] = __float2bfloat16(c[j][q]);
        }
      }
    if (NJ > 1 && t + 1 < T) load(t + 1);
    __syncwarp();
    for (unsigned p = lane; p < pieces * (C - 1); p += 32) {
      const int other = p / pieces, piece = p - other * pieces;  // shifts where NJ = 1
      sse::copy_to_rank(hn + (r0 + (piece >> 1)) * L.ldh + v0 + uw * WH + (piece & 1) * 8,
                        other + (other >= rank));
    }
    sse::cluster_sync();  // step t's h tile complete in every block
    cur ^= 1;
  }
  if (T > 0) {
    store_own(ys + (size_t)(T - 1) * B * H, hs + cur * R * L.ldh, L.ldh, v0);
    if (want_c) store_own(cs + (size_t)(T - 1) * B * H, cts + cur * R * L.ldc, L.ldc, 0);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + r0 + 8 * j + 2 * tig + (q & 1);
      if (j < nj && r < B) fin[(size_t)r * H + u0 + 8 * (q >> 1)] = h[j][q];
    }
}

// Whether a tile of R rows on C blocks runs: C a cluster size whose
// blocks own 16·k <= 128 units, R a multiple of 8 that a block's threads
// and shared memory hold.
bool cluster_takes(int G, int H, int C, int R) {
  return C >= 2 && C <= sse::kMaxCluster && H % (WH * C) == 0 && H / C <= 128 && R >= BN &&
         R % BN == 0 && cluster_tile(G, H, C, R).threads > 0 &&
         cluster_layout(G, H, C, R).total <= 232448;
}

template <int G, int NJ>
cudaError_t launch_scan_cluster_nj(const float* ax, const float* mask, const __nv_bfloat16* wt,
                                   int ldwt, __nv_bfloat16* ys, float* fin, __nv_bfloat16* cs,
                                   int T, int B, int H, int C, int R, cudaStream_t st) {
  return sse::launch_cluster(rnn_scan_cluster_kernel<G, NJ>, C * cdiv(B, R),
                             cluster_tile(G, H, C, R).threads, cluster_layout(G, H, C, R).total, C,
                             st, ax, mask, wt, ldwt, ys, fin, cs, T, B, H, C, R);
}

template <int G>
cudaError_t launch_scan_cluster(const float* ax, const float* mask, const __nv_bfloat16* wt,
                                int ldwt, __nv_bfloat16* ys, float* fin, __nv_bfloat16* cs,
                                int T, int B, int H, int C, int R, cudaStream_t st) {
  if (!cluster_takes(G, H, C, R)) return cudaErrorInvalidValue;
  switch (cluster_tile(G, H, C, R).NJ) {
    case 1: return launch_scan_cluster_nj<G, 1>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, C, R, st);
    case 2: return launch_scan_cluster_nj<G, 2>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, C, R, st);
    case 3: return launch_scan_cluster_nj<G, 3>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, C, R, st);
  }
  if constexpr (cl_groups_most(G) == 4)
    return launch_scan_cluster_nj<G, 4>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, C, R, st);
  return cudaErrorInvalidValue;
}

// Clusters of C blocks of the tile (G, H, C, R) the card holds at once.
template <int G>
cudaError_t active_clusters(int H, int C, int R, int* n) {
  const int threads = cluster_tile(G, H, C, R).threads, smem = cluster_layout(G, H, C, R).total;
  switch (cluster_tile(G, H, C, R).NJ) {
    case 1: return sse::max_active_clusters(rnn_scan_cluster_kernel<G, 1>, threads, smem, C, n);
    case 2: return sse::max_active_clusters(rnn_scan_cluster_kernel<G, 2>, threads, smem, C, n);
    case 3: return sse::max_active_clusters(rnn_scan_cluster_kernel<G, 3>, threads, smem, C, n);
  }
  if constexpr (cl_groups_most(G) == 4)
    return sse::max_active_clusters(rnn_scan_cluster_kernel<G, 4>, threads, smem, C, n);
  return cudaErrorInvalidValue;
}

// Blocks of 8 rows, or of 16 (H=128 only) where that halves the waves of
// blocks over the SMs (one block fits an SM). Measured on an H100, a
// 16-row step takes ~1.9x an 8-row one (~3.4 against 1.8 µs, LSTM), so
// 16 rows win only then: B=4096 runs 2 waves of them against 4 of 8
// rows, while at B=2304 (2 against 3) 8 rows are faster.
bool two_tiles(int B) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  return cdiv(cdiv(B, BN), sms) >= 2 * cdiv(cdiv(B, 2 * BN), sms);
}

// C >= 2: the cluster instance, tiles of R rows; C = 1: one block a tile
// (R unused).
template <int G>
cudaError_t scan(const float* ax, const float* mask, const __nv_bfloat16* wt, int ldwt,
                 __nv_bfloat16* ys, float* fin, __nv_bfloat16* cs, int T, int B, int H, int C,
                 int R, cudaStream_t st) {
  if (C > 1) return launch_scan_cluster<G>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, C, R, st);
  if (H == 128)
    return two_tiles(B) ? launch_scan<G, 128, 2>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, st)
                        : launch_scan<G, 128, 1>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, st);
  return launch_scan<G, 0, 1>(ax, mask, wt, ldwt, ys, fin, cs, T, B, H, st);
}

}  // namespace

// Shared memory one scan block needs for G gates, at most (H=128: the
// ring, 16 rows; else Whᵀ, 8 rows); ops/rnn.py scan_smem mirrors it and
// the plan rejects shapes above the 232,448-byte opt-in limit.
extern "C" int sse_rnn_scan_smem_bytes(int G, int H) {
  const bool fixed = H == 128;
  return layout(G, H, fixed, fixed ? 2 * BN : BN).total;
}

// The same for a block of the cluster instance on C blocks: with tiles of
// 8 rows (the plan's test of a width), and with tiles of R rows.
extern "C" int sse_rnn_scan_cluster_smem_bytes(int G, int H, int C) {
  return cluster_layout(G, H, C, BN).total;
}
extern "C" int sse_rnn_scan_cluster_rows_smem_bytes(int G, int H, int C, int R) {
  return cluster_layout(G, H, C, R).total;
}

// Threads a block of the cluster instance takes for tiles of R rows on C
// blocks (0: none fits; ops/rnn.py cluster_split mirrors it).
extern "C" int sse_rnn_scan_cluster_threads(int G, int H, int C, int R) {
  return cluster_tile(G, H, C, R).threads;
}

// How many clusters of the tile (G, H, C, R) the current card holds at
// once (cudaOccupancyMaxActiveClusters, kept after the first question);
// a negative cudaError_t where the tile cannot run or the question fails.
extern "C" int sse_rnn_scan_cluster_active(int G, int H, int C, int R) {
  if ((G != 3 && G != 4) || !cluster_takes(G, H, C, R)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err =
      G == 3 ? active_clusters<3>(H, C, R, &n) : active_clusters<4>(H, C, R, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Kernel 1. ax [T,B,G·H] fp32, mask [T,1,B] fp32, wht = Whᵀ [G·H,H] bf16
// → ys [T,B,H] bf16, fin [B,H] fp32 (no c stream: the scan alone has no
// backward), on clusters of C blocks carrying R rows each (C = 1: one
// block a tile). T, B >= 1; H a multiple of 16·C; every pointer 16-byte
// aligned.
extern "C" int sse_rnn_scan(const void* ax, const void* mask, const void* wht, void* ys,
                            void* fin, int T, int B, int H, int G, int C, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(ax);
  const auto* m = static_cast<const float*>(mask);
  const auto* w = static_cast<const __nv_bfloat16*>(wht);
  auto* y = static_cast<__nv_bfloat16*>(ys);
  auto* f = static_cast<float*>(fin);
  if (G == 3) return (int)scan<3>(a, m, w, H, y, f, nullptr, T, B, H, C, R, st);
  if (G == 4) return (int)scan<4>(a, m, w, H, y, f, nullptr, T, B, H, C, R, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel 3 (the LSTM layer forward, G = 4) and the GRU layer forward
// where gru_fwd.cu cannot hold [Wx;Wh]ᵀ (G = 3): the x-product, then the
// scan on clusters of C blocks carrying R rows each. xs [T,B,E] bf16,
// mask [T,1,B] fp32, wt = [Wx;Wh]ᵀ [G·H,E+H] bf16, bias [G·H] fp32;
// scratch ax [T·B,G·H] fp32. Out: ys [T,B,H] bf16, fin [B,H] fp32 and,
// for the LSTM, cs [T,B,H] bf16 (null for the GRU). T, B >= 1; E a
// multiple of 16, H of 16·C; every pointer 16-byte aligned.
extern "C" int sse_rnn_fwd(const void* xs, const void* mask, const void* wt, const void* bias,
                           void* ax, void* ys, void* fin, void* cs, int T, int B, int E, int H,
                           int G, int C, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((G != 3 && G != 4) || (C > 1 && !cluster_takes(G, H, C, R)))
    return (int)cudaErrorInvalidValue;
  const int K = E + H;
  const auto* w = static_cast<const __nv_bfloat16*>(wt);
  const sse::XH x = {static_cast<const __nv_bfloat16*>(xs), nullptr, T * B, E, H, B};
  cudaError_t err =
      sse::launch_gates(x, w, G * H, static_cast<const float*>(bias), static_cast<float*>(ax), st);
  if (err != cudaSuccess) return (int)err;
  const auto* a = static_cast<const float*>(ax);
  const auto* m = static_cast<const float*>(mask);
  auto* y = static_cast<__nv_bfloat16*>(ys);
  auto* f = static_cast<float*>(fin);
  if (G == 3) return (int)scan<3>(a, m, w + E, K, y, f, nullptr, T, B, H, C, R, st);
  return (int)scan<4>(a, m, w + E, K, y, f, static_cast<__nv_bfloat16*>(cs), T, B, H, C, R, st);
}
