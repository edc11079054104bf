// The serial dh loop of the recurrent layer backward (kernel 4) on a
// thread-block cluster, for the layers whose Wh [H, G·H] outgrows one SM:
// the GRU's (gru_bwd.cu, G = 3, gru_bwd_dh_cluster_kernel) and the
// LSTM's (lstm_bwd.cu, G = 4, with its dc carry,
// lstm_bwd_dh_cluster_kernel). Each source gives the loop its cell (a
// struct with the input factors and the cell backward); the loop, the
// tile, the exchange and the product are the same for both.
//
// A cluster of C blocks owns one tile of R batch rows (R a multiple of 8,
// chosen at launch: ops/rnn.py dh_tile), and block r of the cluster owns
// units [r·H/C, (r+1)·H/C): it holds their Wh rows [H/C, G·H] in shared
// memory for all T steps and carries their dh (and dc). Inside a block,
// warp w owns 16 units (w mod H/(16·C)) and one n8 group of the tile's
// rows (w div H/(16·C)). Each step, each warp
//   1. runs the cell backward for its units and rows from their fp32
//      gates, dys_t, h_{t-1} (c_{t-1}) and mask, read from global memory
//      one step ahead into registers (no stage ring in shared memory);
//   2. writes its dgates_b block {g·H + its units} x its rows into its
//      own block's dgates_b tile [R][G·H], then copies it, 16 bytes a
//      piece, into the same tile of every other block of the cluster by
//      st.async, each store completing on the receiving block's mbarrier
//      of that tile (its transaction count: the bytes the other blocks
//      send it a step), and into dgates_b in global memory;
//   3. meets its own block at __syncthreads (the block's own columns) and
//      waits on its tile's mbarrier (the other blocks' columns), after
//      which its block holds the step's whole dgates_b tile;
//   4. computes dh = base + Wh·dgates_bᵀ for its units and rows over all
//      G·H columns, one mma a k16 slice and gate. Each gate has one
//      accumulator, summed over k in the single block's order, then
//      ((a0 + a1) + a2) (+ a3): neither R, the row group nor C changes a
//      row's bits (C=2 gives C=1's);
//   5. prepares the next step's factors and loads its inputs.
// The db partials stay one row per 8-row group of db_part [ceil(B/8),
// G·H], each group's own sum (its rows' pairs, then a fixed shuffle tree
// over the row pairs), whatever R is, so the fixed-order reduce of
// products.cu is unchanged.
//
// A warp carries one row group, so a block's R/8 · H/(16·C) warps cap R
// at 512 threads (32 rows at H/C = 64, where the GRU's shared memory
// would hold 80). Two groups a warp would share each Wh fragment, but at
// the registers they need (255 at 256 threads, ptxas) a block holds half
// the warps, so they carry no more rows.
//
// The tile and its synchronization, which takes no cluster barrier a step
// where the tile is double-buffered. A read whose value an instruction has
// consumed is complete. The tile is full: a block reads its tile of step
// t only after its own threads' writes (__syncthreads) and after the
// mbarrier's phase for step t has received every byte the other blocks
// send it, their stores released at cluster scope by the complete_tx and
// acquired by the wait (thread 0 arms each phase with one arrival and the
// byte count, at the top of the step; stores that land first drive the
// count below zero, and the phase cannot complete before that arrival).
// The tile is free:
//   * Where two tiles of R rows fit beside the Wh rows (every R=8 tile,
//     and the wider ones of most layers), the tile is double-buffered. A
//     block X writes block Y's tile b in step t only after its wait of
//     step t+1 (the other tile), which needs Y's pieces of step t+1. Y's
//     warps send those only after their cell of step t+1, which consumes
//     the dh of step t+2's product, which consumed every value read from
//     tile b in step t+2 (the products', and the pieces' sent on to the
//     other blocks and dgates_b). So every read of tile b in step t+2 is done before any
//     block writes it for step t, and no phase of an mbarrier receives a
//     byte of the next phase: X's pieces of step t reach Y after Y's
//     phase of step t+2 on tile b completed. (Steps run from t = T-1
//     down. A block's writes into its own tile b follow its __syncthreads
//     of step t+1, which every one of its warps reaches after its cell of
//     step t+1.)
//   * Where only one fits (the LSTM at H=384 beyond 8 rows, at H=256
//     beyond 24), the order above holds only for a tile two steps back,
//     so a split cluster barrier frees the one tile: each thread arrives
//     (release) after its last read of the tile, a product after its
//     stores to dgates_b and before its loads of the next step's inputs,
//     which the release would wait for (after them, it cost 4-12% a step
//     on an H100), and waits (acquire) before it writes the next step's
//     tile, after that step's cell, where the slowest block's arrive has
//     usually come. Release and acquire order every block's reads of the
//     tile before any block's next writes into it.
// Nothing is written into a block before the cluster barrier that follows
// every block's set-up (the mbarriers initialized), and a block exits
// only after the cluster barrier that follows its last wait, past which
// nothing is written into another block.
//
// What bounds it on the H100: the chain over T (the cell backward, the
// exchange, the wait for the tile, the product) and, at large B, the waves of
// clusters over the card (one block an SM): an H100 80GB HBM3 (700 W)
// holds 30 clusters of 4 blocks at once and 15 of 8, so 8-row tiles ran
// the LSTM at H=256, B=4096 in 18 waves. A step's shared-memory traffic is
// each row group's pass over the Wh slice (131 KB at H=256, C=4) plus
// each unit group's pass over the tile.
#pragma once

#include "cluster.cuh"

namespace sse {
namespace dh {

constexpr int BN = 8;             // batch rows of one n8 tile: a row group
constexpr int WH = 16;            // hidden units of one m16 tile: a unit group
constexpr int KPAD = 8;           // bf16 row padding: conflict-free 32-bit fragment loads
constexpr int kSmemMost = 232448;  // opt-in dynamic shared memory of a block
constexpr int kUnitsMost = 128;   // units a block owns at most
// The rows whose tile the wrapper's plan (ops/rnn.py layer_plan) needs a
// cluster width's shared memory to hold: three n8 groups
constexpr int kPlanRows = 24;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Threads a block takes at most (65,536 registers an SM, one block an
// SM). ptxas (CUDA 12.8, sm_90a), registers (GRU / LSTM) of the instances
// by their threads' bound: 128 / 128 at 512, 153 / 168 at 384, 154 / 187
// at 256; none spills.
constexpr int kThreadsMost = 512;

// Byte offsets of a block's shared buffers for tiles of R rows: the Wh
// rows of its H/C units [H/C][ldw] bf16, then `nb` dgates_b tiles
// [R][ldw] bf16 (two where they fit, else one), then an mbarrier for each
// tile.
struct Layout {
  int hc, ldw, wh, dg, nb, bar, total;
};

__host__ __device__ inline Layout layout(int G, int H, int C, int R) {
  Layout L;
  L.hc = H / C;
  L.ldw = G * H + KPAD;
  L.wh = 0;
  L.dg = L.wh + L.hc * L.ldw * 2;
  const int tile = R * L.ldw * 2;
  L.nb = L.dg + 2 * tile + 2 * 8 <= kSmemMost ? 2 : 1;
  L.bar = L.dg + L.nb * tile;
  L.total = L.bar + L.nb * 8;
  return L;
}

// The threads of a block for a tile of R rows on H/C units: a warp for
// each unit group and row group (0: more than kThreadsMost).
inline int threads(int H, int C, int R) {
  const int n = 32 * (H / C / WH) * (R / BN);
  return n <= kThreadsMost ? n : 0;
}

// Whether a tile of R rows on C blocks runs: C a power of two (the
// exchange's ranks) up to the cluster's most, whose blocks own 16·k <= 128
// units, R a multiple of 8 that a block's threads and shared memory hold.
inline bool takes(int G, int H, int C, int R) {
  return C >= 2 && C <= kMaxCluster && (C & (C - 1)) == 0 && H % (WH * C) == 0 &&
         H / C <= kUnitsMost && R >= BN && R % BN == 0 && threads(H, C, R) > 0 &&
         layout(G, H, C, R).total <= kSmemMost;
}

// A bf16 value held as its 16 bits, as float (exact).
__device__ __forceinline__ float bf16_bits(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The loop. Cell::G gates; Cell::prepare(g, v, f) turns one row group's
// raw inputs at a thread's four fragment positions (g: the G fp32 gates;
// v: dys_t and the second stream, h_{t-1} or c_{t-1}, as bf16 bits) into
// its G+3 factors f (those that need no dh); Cell::step(f, m, dh, dc, dg,
// db, base) runs the cell backward's chain on them: the fp32 dgates dg,
// the db sums, base (dh's terms other than the product) and the dc carry.
// sp: the second stream, ys (GRU) or cs (LSTM).
template <class Cell>
__device__ __forceinline__ void cluster_loop(const float* __restrict__ gates,
                                             const __nv_bfloat16* __restrict__ sp,
                                             const float* __restrict__ mask,
                                             const __nv_bfloat16* __restrict__ wh,
                                             const __nv_bfloat16* __restrict__ dys,
                                             const float* __restrict__ dfin,
                                             __nv_bfloat16* __restrict__ dgb,
                                             float* __restrict__ db_part, int T, int B, int H,
                                             int C, int R) {
  constexpr int G = Cell::G;
  const int N = G * H;
  const Layout L = layout(G, H, C, R);
  const int HC = L.hc, UW = HC / WH;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);  // this block's Wh rows
  __nv_bfloat16* dgs = reinterpret_cast<__nv_bfloat16*>(smem + L.dg);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);  // one a tile
  const int rank = cluster_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int uw = warp % UW;
  const int row0 = blockIdx.x / C * R;  // the cluster's first row
  const int r0 = warp / UW * BN;        // this warp's first row in the tile
  const int v0 = rank * HC;             // this block's first unit
  const int ul = uw * WH + grp;         // this thread's units, local: ul and ul + 8
  const int u0 = v0 + ul;               // ... and in the layer
  const bool one = L.nb == 1;           // one dgates_b tile: the split barrier frees it

  // this block's Wh rows, and its tiles' mbarriers: one arrival a phase
  // (thread 0's, with the bytes the other blocks send it a step)
  if (tid == 0) {
    for (int b = 0; b < L.nb; ++b) mbar_init(full + b, 1);
    mbar_fence_init();
  }
  for (int i = tid; i < HC * (N / 8); i += blockDim.x) {
    const int j = i / (N / 8), c = (i - j * (N / 8)) * 8;
    cp_async16(whs + j * L.ldw + c, wh + (size_t)(v0 + j) * N + c, true);
  }
  cp_async_commit();

  // step s's inputs at this thread's fragment positions, into registers:
  // position q is unit u0 + 8·(q >> 1), row 2·tig + (q & 1) of the warp's
  // rows; rows >= B and h_{-1} (c_{-1}) read as 0
  float gin[G][4], mn[2];
  unsigned short vin[2][4];
  const unsigned short* dys_u = reinterpret_cast<const unsigned short*>(dys);
  const unsigned short* sp_u = reinterpret_cast<const unsigned short*>(sp);
  auto load = [&](int s) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + r0 + 2 * tig + e;
      mn[e] = r < B ? mask[(size_t)s * B + r] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + r0 + 2 * tig + (q & 1), u = u0 + 8 * (q >> 1);
      const bool ok = r < B;
      const size_t at = (size_t)s * B + r;
#pragma unroll
      for (int g = 0; g < G; ++g) gin[g][q] = ok ? gates[at * N + g * H + u] : 0.f;
      vin[0][q] = ok ? dys_u[at * H + u] : (unsigned short)0;
      vin[1][q] = ok && s > 0 ? sp_u[(at - B) * H + u] : (unsigned short)0;
    }
  };
  // the factors of the step whose inputs were loaded last
  float f[G + 3][4], m[2];
  auto prepare = [&]() {
    Cell::prepare(gin, vin, f);
    m[0] = mn[0];
    m[1] = mn[1];
  };

  // fp32 dh and dc carries and the db sums over this thread's rows
  float dh[4], dc[4] = {}, dbs[G][2] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = row0 + r0 + 2 * tig + (q & 1);
    dh[q] = r < B ? dfin[(size_t)r * H + u0 + 8 * (q >> 1)] : 0.f;
  }

  load(T - 1);
  cp_async_wait<0>();
  prepare();
  if (T > 1) load(T - 2);
  cluster_sync();  // every block running and set up (Wh rows, mbarriers)
  if (one) cluster_arrive();  // step 0's wait of the split barrier is this arrive's
  const uint32_t bytes = (C - 1) * R * G * HC * 2;  // from the other blocks, a step

  // the exchange: the warp's 8 rows x G gates x 16 units, two 16-byte
  // pieces a row and gate (half, then row, then gate: the 16 lanes of a
  // gate read distinct banks), each lane's read once from its own tile,
  // sent to the C-1 other blocks and stored to dgates_b in global memory
  // (there, not after the product, where the split barrier's release
  // arrive would wait for the stores, or holding the pieces past it would
  // spill the 512-thread instance). Each piece's offsets, in the tile and
  // in a step of dgates_b, are fixed
  constexpr int pieces = 16 * G, PL = (pieces + 31) / 32;  // pieces a lane at most
  int po[PL], pg[PL];  // the tile's offset (-1: no piece); dgates_b's (-1: row >= B)
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int p = lane + 32 * i, rg = p >> 1, r = r0 + (rg & (BN - 1));
    const int c = rg / BN * H + v0 + uw * WH + (p & 1) * 8;
    po[i] = p < pieces ? r * L.ldw + c : -1;
    pg[i] = p < pieces && row0 + r < B ? (row0 + r) * N + c : -1;
  }
  int cur = 0;
  for (int it = 0; it < T; ++it) {
    const int t = T - 1 - it;
    __nv_bfloat16* dg = dgs + cur * R * L.ldw;

    if (tid == 0) mbar_expect_tx(full + cur, bytes);
    // the cell backward's part that needs dh: the chain
    float base[4], dgv[G][4];
    Cell::step(f, m, dh, dc, dgv, dbs, base);
    if (one) cluster_wait();  // every block's reads of the tile done (step t+1's)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat16* ds = dg + (r0 + 2 * tig + (q & 1)) * L.ldw + u0 + 8 * (q >> 1);
#pragma unroll
      for (int g = 0; g < G; ++g) ds[g * H] = __float2bfloat16(dgv[g][q]);
    }
    // the warp's dgates_b block into every other block's tile, each
    // block sending to the next ranks first
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PL; ++i)
      if (po[i] >= 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(dg + po[i]);
        for (int o = 1; o < C; ++o)
          put_async_to_rank(dg + po[i], v, full + cur, (rank + o) & (C - 1));
        if (pg[i] >= 0) *reinterpret_cast<uint4*>(dgb + (size_t)t * B * N + pg[i]) = v;
      }
    __syncthreads();  // the tile's columns of this block
    mbar_wait_cluster(full + cur, one ? it & 1 : (it >> 1) & 1);  // ... and of the others

    // dh = base + Wh·dgates_bᵀ over K = G·H: one accumulator a gate, each
    // summed over k in order
    float acc[G][4] = {};
    const __nv_bfloat16* wa = whs + ul * L.ldw + 2 * tig;
    const __nv_bfloat16* wb = dg + (r0 + grp) * L.ldw + 2 * tig;  // this thread's B row
#pragma unroll 2
    for (int kq = 0; kq < H / WH; ++kq) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = g * H + WH * kq;
        uint32_t a[4];
        frag_a(a, wa + k, L.ldw);
        mma_bf16(acc[g], a, ld32(wb + k), ld32(wb + k + 8));
      }
    }
    // this thread's reads of the tile done (a release waits for the
    // thread's loads and stores before it, so it comes before the next
    // step's loads); while the products run, the next step's factors and
    // inputs
    if (one && it + 1 < T) cluster_arrive();
    if (it + 1 < T) {
      prepare();
      if (it + 2 < T) load(t - 2);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = acc[0][q];
#pragma unroll
      for (int g = 1; g < G; ++g) s = s + acc[g][q];
      dh[q] = base[q] + s;
    }
    if (!one) cur ^= 1;  // the other dgates_b tile
  }

  cluster_sync();  // no block leaves while another may still write into it

  // the group's db partial: its row of db_part, this block's columns
  const int first = row0 + r0;
  if (first < B) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dbs[g][e];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        if (tig == 0) db_part[(size_t)(first / BN) * N + g * H + u0 + 8 * e] = v;
      }
  }
}

// The instance of the cluster dh loop `Kernel<THREADS>` (a __global__
// that runs cluster_loop<Cell> under __launch_bounds__(THREADS, 1)) for a
// block of n threads: the fewest of 256, 384 and 512 that hold them, so
// that a narrow tile keeps the registers a wide one must give up (with the
// 512-thread instance alone, 128 registers, the LSTM's B=8 step ran 11-16%
// above the 8-row kernel's it replaces).
template <template <int> class Kernel>
auto instance(int n) {
  return n <= 256   ? Kernel<256>::kernel()
         : n <= 384 ? Kernel<384>::kernel()
                    : Kernel<512>::kernel();
}

// Launch the cluster dh loop on clusters of C blocks, tiles of R rows.
template <int G, template <int> class Kernel, typename... Args>
cudaError_t launch(int B, int H, int C, int R, cudaStream_t st, Args... args) {
  if (!takes(G, H, C, R)) return cudaErrorInvalidValue;
  const int n = threads(H, C, R);
  return launch_cluster(instance<Kernel>(n), C * ceil_div(B, R), n, layout(G, H, C, R).total, C,
                        st, args...);
}

// Clusters of C blocks of the tile (G, H, C, R) the current card holds at
// once (cudaOccupancyMaxActiveClusters, kept after the first question).
template <int G, template <int> class Kernel>
cudaError_t active(int H, int C, int R, int* n) {
  if (!takes(G, H, C, R)) return cudaErrorInvalidValue;
  const int k = threads(H, C, R);
  return max_active_clusters(instance<Kernel>(k), k, layout(G, H, C, R).total, C, n);
}

}  // namespace dh
}  // namespace sse
