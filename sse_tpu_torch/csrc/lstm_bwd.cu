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
// Design: gru_bwd.cu's five launches with N = 4H. (1) one product
// recomputes the gates of all T·B rows off the serial chain; (2) the
// serial loop carries dh and dc (below); (3) dxs, (4) the split-K dW
// product into fixed partials, (5) their in-order sum with the loop's
// per-block db partials (products.cu). No float atomics.
//
// What bounds it on the H100: the serial loop, T steps of a chain: the
// cell backward's dh-dependent part, one barrier, and the dh product over
// K = 4H. The design keeps everything else off that chain, as
// gru_bwd.cu's dh kernel does:
//   * Transposed product: dhᵀ = Wh·dgates_bᵀ, so the H units are the m16
//     rows of mma.sync and a block's BN=8 batch rows one n8 tile (B=128,
//     256 and 2304 run on 16, 32 and 288 blocks). At H=128 each warp holds
//     its Wh fragments in registers (32 k16 slices: 128 a thread), so the
//     product reads only the 8 KB dgates_b tile from shared memory, in one
//     accumulator chain per gate.
//   * Step inputs: each warp copies its own units' fp32 i, f, g, o for 8
//     rows (2 KB), dys_t, c_{t-1} = cs[t-1] and the mask three steps ahead
//     into a shared stage by cp.async, so no barrier guards them (the
//     gates buffer, 52 MB at T=50, B=256, does not stay in the 50 MB L2).
//   * σ(i), σ(f+1), tanh(g̃), σ(o), c_new and tanh(c_new) need no dh: each
//     step's are computed while the step before runs its product, staged
//     (exponentials, divisions back to back, tanhf's). The chain keeps the
//     reference's left-to-right products (g·σ(o)·(1-tanh²), dc_new·c·σ(f)·
//     (1-σ(f)), ...), so moving the factors changes no rounding.
//   * dgates_b goes to global memory from the shared tile in 16-byte
//     stores while the product runs.
// Other widths take a generic instance: Wh in shared memory, one input
// stage (H <= 144, what shared memory allows), and wider ones the cluster
// instance, lstm_bwd_dh_cluster_kernel<THREADS> (dh_cluster.cuh: Wh's rows
// split over C <= 8 blocks, a cluster carrying R batch rows; the plan in
// ops/rnn.py layer_plan picks the instance and C, the launch R).
// The products are ~4/3 of the GRU's FLOPs on the same engine
// (products.cu); the gates buffer costs 2·T·B·4H·4 bytes of traffic.
#include "dh_cluster.cuh"
#include "products.cuh"

namespace {

constexpr int BN = 8;     // dh kernel: batch rows per block (one n8 tile)
constexpr int WH = 16;    // dh kernel: hidden units per warp (one m16 tile)
constexpr int KPAD = 8;   // bf16 row padding: conflict-free 32-bit fragment loads
constexpr int GPAD = 4;   // fp32 gate row padding: rows 2·tig apart fall in distinct banks
constexpr int MAX_THREADS = 288;  // 2H threads; H <= 144 is what shared memory allows

// Input stages of the dh loop: three with H fixed at compile time (Wh in
// registers leaves room), one with Wh in shared memory.
__host__ __device__ constexpr int dh_stages(int kh) { return kh ? 3 : 1; }

// Byte offsets of the dh kernel's shared buffers: Wh [H][ldw] bf16 as
// stored (only where it is not held in registers), dgates_b [2][BN][ldw]
// bf16, then `stages` stages of step inputs, each gates [BN][ldg] fp32,
// dys_t and c_{t-1} [BN][ldv] bf16 and the mask, one [BN] copy per warp.
struct DhLayout {
  int ldw, ldg, ldv, wh, dg, st, g, dy, cp, m, stage, total;
};

__host__ __device__ inline DhLayout dh_layout(int H, int stages, bool wh_shared) {
  DhLayout L;
  L.ldw = 4 * H + KPAD;
  L.ldg = 4 * H + GPAD;
  L.ldv = H + KPAD;
  L.wh = 0;
  L.dg = L.wh + (wh_shared ? H * L.ldw * 2 : 0);
  L.st = L.dg + 2 * BN * L.ldw * 2;
  L.g = 0;  // offsets inside a stage
  L.dy = L.g + BN * L.ldg * 4;
  L.cp = L.dy + BN * L.ldv * 2;
  L.m = L.cp + BN * L.ldv * 2;
  L.stage = L.m + (H / WH) * BN * 4;
  L.total = L.st + stages * L.stage;
  return L;
}

// The serial reverse loop, transposed: dhᵀ = Wh·dgates_bᵀ. Warp w owns
// units [16w, 16w+16) of all four gates: the cell backward for a (unit,
// row) needs only what the same warp copied, and its dh and dc carries
// sit where the forward's h and c do. KH: H at compile time, with the
// warp's Wh fragments in registers (0: H from the argument, Wh in shared
// memory, one input stage).
template <int KH>
__global__ void __launch_bounds__(KH ? 2 * KH : MAX_THREADS, 1)
lstm_bwd_dh_kernel(const float* __restrict__ gates, const __nv_bfloat16* __restrict__ cs,
                   const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wh,
                   const __nv_bfloat16* __restrict__ dys, const float* __restrict__ dfin,
                   __nv_bfloat16* __restrict__ dgb, float* __restrict__ db_part, int T, int B,
                   int h_arg) {
  constexpr bool WREG = KH != 0;
  constexpr int STAGES = dh_stages(KH);  // copies run STAGES steps ahead
  const int H = KH ? KH : h_arg, N = 4 * H;
  const DhLayout L = dh_layout(H, STAGES, !WREG);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);  // Wh as stored
  __nv_bfloat16* dgs = reinterpret_cast<__nv_bfloat16*>(smem + L.dg);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BN;
  const int col0 = warp * WH;
  const int u0 = col0 + grp;  // this thread's units: u0 and u0 + 8; rows 2·tig, 2·tig+1

  // Iteration i's inputs (step s = T-1-i) into stage i % STAGES, this
  // warp's columns only, as one group of copies: four 16-byte pieces of
  // its fp32 i, f, g, o columns a lane (8 rows x 4 gates x 4 pieces);
  // lanes < 16 one piece of dys_t, the others one of c_{t-1} = cs[t-1]
  // (8 rows x 2 pieces); lanes < 8 one mask value. Rows >= B (and c_{-1})
  // are zero-filled.
  const bool is_cp = lane >= 16;
  const int v_r = (lane & 15) >> 1, v_col = col0 + (lane & 1) * 8;
  const int v_s = (is_cp ? L.cp : L.dy) / 2 + v_r * L.ldv + v_col;  // bf16 offset into a stage
  const bool v_ok = row0 + v_r < B, m_ok = lane < BN && row0 + lane < B;
  auto fetch = [&](int i) {
    const int s = T - 1 - i;
    if (s >= 0) {
      unsigned char* st = smem + L.st + (i % STAGES) * L.stage;
      float* sg = reinterpret_cast<float*>(st + L.g);
      const float* gs = gates + (size_t)s * B * N;
#pragma unroll
      for (int j = 0; j < BN * 16 / 32; ++j) {
        const int q = lane + 32 * j, r = q >> 4, rem = q & 15;
        const int col = (rem >> 2) * H + col0 + (rem & 3) * 4;
        const bool v = row0 + r < B;
        sse::cp_async16(sg + r * L.ldg + col, gs + (v ? (size_t)(row0 + r) * N + col : 0), v);
      }
      const __nv_bfloat16* src = is_cp ? cs + (size_t)(s > 0 ? s - 1 : 0) * B * H
                                       : dys + (size_t)s * B * H;
      sse::cp_async16(reinterpret_cast<__nv_bfloat16*>(st) + v_s,
                      src + (v_ok ? (size_t)(row0 + v_r) * H + v_col : 0),
                      v_ok && (!is_cp || s > 0));
      if (lane < BN)
        sse::cp_async4(reinterpret_cast<float*>(st + L.m) + warp * BN + lane,
                       mask + (size_t)s * B + (m_ok ? row0 + lane : 0), m_ok);
    }
    sse::cp_async_commit();
  };

  // C[u][n] = Σ_k Wh[u][k]·dg[n][k]: an A fragment is Wh's rows u0, u0+8,
  // k-contiguous as stored. With H known, each warp keeps its m16 tile's
  // fragments in registers (128 at H=128); else Wh is staged.
  constexpr int NK = KH ? 4 * KH / 16 : 1;
  uint32_t whr[NK][4];
  if constexpr (WREG) {
#pragma unroll
    for (int kq = 0; kq < NK; ++kq)
      sse::frag_a(whr[kq], wh + (size_t)u0 * N + 16 * kq + 2 * tig, N);
  } else {
    for (int i = tid; i < H * (N / 8); i += blockDim.x) {
      const int j = i / (N / 8), c = (i - j * (N / 8)) * 8;
      sse::cp_async16(whs + j * L.ldw + c, wh + (size_t)j * N + c, true);
    }
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) fetch(i);  // the first with Wh, where staged

  // fp32 dh and dc carries and the db sums over this thread's rows;
  // fragment c is unit u0 + 8·(c >> 1), row 2·tig + (c & 1)
  float dh[4], dc[4] = {}, dbs[4][2] = {};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int r = row0 + 2 * tig + (c & 1);
    dh[c] = r < B ? dfin[(size_t)r * H + u0 + 8 * (c >> 1)] : 0.f;
  }

  // Iteration i's inputs from its stage, and the factors that need no
  // dh: σ(i), σ(f+1), tanh(g̃), σ(o) and tanh(c_new), c_new from the bf16
  // c_{t-1}; staged (exponentials, then the divisions back to back, then
  // the tanhf's), the values of sse::sigmoid and tanhf.
  float si[4], sf[4], tg[4], so[4], tc[4], cprev[4], dyv[4], m[2];
  auto prepare = [&](int i) {
    sse::cp_async_wait<STAGES - 1>();  // this thread's copies of iteration i
    __syncwarp();                      // ... and its warp's
    const unsigned char* st = smem + L.st + (i % STAGES) * L.stage;
    const float* sg = reinterpret_cast<const float*>(st + L.g);
    const __nv_bfloat16* sdy = reinterpret_cast<const __nv_bfloat16*>(st + L.dy);
    const __nv_bfloat16* scp = reinterpret_cast<const __nv_bfloat16*>(st + L.cp);
    const float* sm = reinterpret_cast<const float*>(st + L.m) + warp * BN;
    m[0] = sm[2 * tig];
    m[1] = sm[2 * tig + 1];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 2 * tig + (c & 1), u = u0 + 8 * (c >> 1);
      const float* gr = sg + r * L.ldg + u;
      si[c] = expf(-gr[0]);
      sf[c] = expf(-(gr[H] + 1.f));
      tg[c] = gr[2 * H];
      so[c] = expf(-gr[3 * H]);
      dyv[c] = __bfloat162float(sdy[r * L.ldv + u]);
      cprev[c] = __bfloat162float(scp[r * L.ldv + u]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      si[c] = sse::sigmoid_exp(si[c]);
      sf[c] = sse::sigmoid_exp(sf[c]);
      so[c] = sse::sigmoid_exp(so[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) tg[c] = tanhf(tg[c]);
#pragma unroll
    for (int c = 0; c < 4; ++c) tc[c] = tanhf(sf[c] * cprev[c] + si[c] * tg[c]);
  };

  prepare(0);
  int cur = 0;
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    __nv_bfloat16* dg = dgs + cur * BN * L.ldw;
    float base[4];  // (1-m)·dh_t

    // the cell backward's part that needs dh: the chain
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float mc = m[c & 1];
      const float dh_t = dh[c] + dyv[c];
      const float g = mc * dh_t;  // d h_new
      const float dcn = mc * dc[c] + g * so[c] * (1.f - tc[c] * tc[c]);
      const float d_o = g * tc[c] * so[c] * (1.f - so[c]);
      const float d_f = dcn * cprev[c] * sf[c] * (1.f - sf[c]);
      const float d_i = dcn * tg[c] * si[c] * (1.f - si[c]);
      const float d_g = dcn * si[c] * (1.f - tg[c] * tg[c]);
      base[c] = (1.f - mc) * dh_t;
      dc[c] = (1.f - mc) * dc[c] + dcn * sf[c];
      dbs[0][c >> 1] += d_i;
      dbs[1][c >> 1] += d_f;
      dbs[2][c >> 1] += d_g;
      dbs[3][c >> 1] += d_o;
      __nv_bfloat16* ds = dg + (2 * tig + (c & 1)) * L.ldw + u0 + 8 * (c >> 1);
      ds[0] = __float2bfloat16(d_i);
      ds[H] = __float2bfloat16(d_f);
      ds[2 * H] = __float2bfloat16(d_g);
      ds[3 * H] = __float2bfloat16(d_o);
    }
    __syncthreads();  // every warp's dgates_b of step t

    // dh = base + Wh·dgates_bᵀ over K = 4H, one accumulator chain per gate
    float acc[4][4] = {};
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int kq = 0; kq < H / 16; ++kq) {
        const int k = g * H + 16 * kq;
        const __nv_bfloat16* p = dg + grp * L.ldw + k + 2 * tig;
        const uint32_t b0 = sse::ld32(p), b1 = sse::ld32(p + 8);
        if constexpr (WREG) {
          sse::mma_bf16(acc[g], whr[k / 16], b0, b1);
        } else {
          uint32_t f[4];
          sse::frag_a(f, whs + u0 * L.ldw + k + 2 * tig, L.ldw);
          sse::mma_bf16(acc[g], f, b0, b1);
        }
      }
    // while the products run: refill the stage prepare(i) read, store
    // dgates_b of step t from the shared tile (16 bytes a store), and
    // prepare the next step
    fetch(i + STAGES);
    for (int q = tid; q < BN * (N / 8); q += blockDim.x) {
      const int r = q / (N / 8), c = (q - r * (N / 8)) * 8;
      if (row0 + r < B)
        *reinterpret_cast<uint4*>(dgb + ((size_t)t * B + row0 + r) * N + c) =
            *reinterpret_cast<const uint4*>(dg + r * L.ldw + c);
    }
    if (i + 1 < T) prepare(i + 1);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dh[c] = base[c] + (((acc[0][c] + acc[1][c]) + acc[2][c]) + acc[3][c]);
    cur ^= 1;
  }

  // db partial of this block: sum the 4 row pairs with a fixed shuffle tree
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = dbs[g][j];
      v += __shfl_xor_sync(sse::kFull, v, 1);
      v += __shfl_xor_sync(sse::kFull, v, 2);
      if (tig == 0) db_part[(size_t)blockIdx.x * N + g * H + u0 + 8 * j] = v;
    }
}

// Shared memory of the dh loop's instance for H: H=128 at compile time
// (Wh in registers), else generic.
int dh_smem(int H) {
  const int kh = H == 128 ? 128 : 0;
  return dh_layout(H, dh_stages(kh), kh == 0).total;
}

template <int KH>
cudaError_t launch_dh(const float* gates, const __nv_bfloat16* cs, const float* mask,
                      const __nv_bfloat16* wh, const __nv_bfloat16* dys, const float* dfin,
                      __nv_bfloat16* dgb, float* db_part, int T, int B, int H, cudaStream_t st) {
  const int smem = dh_smem(H);
  auto* kernel = lstm_bwd_dh_kernel<KH>;
  // once a (kernel, card), at the opt-in most: the bytes vary with H
  const cudaError_t err = sse::allow_smem((const void*)kernel, sse::dh::kSmemMost);
  if (err != cudaSuccess) return err;
  kernel<<<cdiv(B, BN), 32 * (H / WH), smem, st>>>(gates, cs, mask, wh, dys, dfin, dgb, db_part,
                                                   T, B, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- clusters
// The dh/dc loop on clusters of C blocks carrying R rows each
// (dh_cluster.cuh: the tile, the exchange, the barriers and the
// product); here the LSTM's cell, the same values as lstm_bwd_dh_kernel's
// bit for bit. Factors: σ(i), σ(f+1), tanh(g̃), σ(o), dys_t, c_{t-1},
// tanh(c_new).
struct LstmCell {
  static constexpr int G = 4;

  __device__ __forceinline__ static void prepare(const float (&g)[4][4],
                                                 const unsigned short (&v)[2][4],
                                                 float (&f)[7][4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      f[0][c] = expf(-g[0][c]);
      f[1][c] = expf(-(g[1][c] + 1.f));
      f[2][c] = g[2][c];
      f[3][c] = expf(-g[3][c]);
      f[4][c] = sse::dh::bf16_bits(v[0][c]);
      f[5][c] = sse::dh::bf16_bits(v[1][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      f[0][c] = sse::sigmoid_exp(f[0][c]);
      f[1][c] = sse::sigmoid_exp(f[1][c]);
      f[3][c] = sse::sigmoid_exp(f[3][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) f[2][c] = tanhf(f[2][c]);
#pragma unroll
    for (int c = 0; c < 4; ++c) f[6][c] = tanhf(f[1][c] * f[5][c] + f[0][c] * f[2][c]);
  }

  __device__ __forceinline__ static void step(const float (&f)[7][4], const float (&m)[2],
                                              float (&dh)[4], float (&dc)[4], float (&dg)[4][4],
                                              float (&db)[4][2], float (&base)[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float si = f[0][c], sf = f[1][c], tg = f[2][c], so = f[3][c], tc = f[6][c];
      const float mc = m[c & 1];
      const float dh_t = dh[c] + f[4][c];
      const float g = mc * dh_t;
      const float dcn = mc * dc[c] + g * so * (1.f - tc * tc);
      dg[3][c] = g * tc * so * (1.f - so);
      dg[1][c] = dcn * f[5][c] * sf * (1.f - sf);
      dg[0][c] = dcn * tg * si * (1.f - si);
      dg[2][c] = dcn * si * (1.f - tg * tg);
      base[c] = (1.f - mc) * dh_t;
      dc[c] = (1.f - mc) * dc[c] + dcn * sf;
#pragma unroll
      for (int k = 0; k < 4; ++k) db[k][c >> 1] += dg[k][c];
    }
  }
};

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_dh_cluster_kernel(const float* __restrict__ gates, const __nv_bfloat16* __restrict__ cs,
                           const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wh,
                           const __nv_bfloat16* __restrict__ dys, const float* __restrict__ dfin,
                           __nv_bfloat16* __restrict__ dgb, float* __restrict__ db_part, int T,
                           int B, int H, int C, int R) {
  sse::dh::cluster_loop<LstmCell>(gates, cs, mask, wh, dys, dfin, dgb, db_part, T, B, H, C, R);
}

template <int THREADS>
struct LstmDh {
  static auto kernel() { return &lstm_bwd_dh_cluster_kernel<THREADS>; }
};

}  // namespace

// Shared memory of the dh kernel; the wrapper rejects shapes above the
// 232,448-byte opt-in limit before launching (H > 144 among them).
extern "C" int sse_lstm_bwd_smem_bytes(int H) { return dh_smem(H); }

// The same for a block of the cluster instance on C blocks: with tiles of
// kPlanRows rows (the plan's test of a width), and with tiles of R rows;
// its threads for R rows (0: more than a block takes); and how many
// clusters of the tile the current card holds at once
// (cudaOccupancyMaxActiveClusters, kept after the first question; a
// negative cudaError_t where the tile cannot run or the question fails).
extern "C" int sse_lstm_bwd_cluster_smem_bytes(int H, int C) {
  return sse::dh::layout(4, H, C, sse::dh::kPlanRows).total;
}
extern "C" int sse_lstm_bwd_cluster_rows_smem_bytes(int H, int C, int R) {
  return sse::dh::layout(4, H, C, R).total;
}
extern "C" int sse_lstm_bwd_cluster_threads(int H, int C, int R) {
  return sse::dh::threads(H, C, R);
}
extern "C" int sse_lstm_bwd_cluster_active(int H, int C, int R) {
  int n = 0;
  const cudaError_t err = sse::dh::active<4, LstmDh>(H, C, R, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Rows of the batch one dh block owns (the db partials come one per block).
extern "C" int sse_lstm_bwd_block_rows() { return BN; }

// One LSTM layer backward. xs [T,B,E], ys, cs, dys [T,B,H] bf16; mask
// [T,1,B], dfin [B,H], bias [4H] fp32; wx [E,4H], wh [H,4H] and
// wt = [Wx;Wh]ᵀ [4H,E+H] bf16. Scratch from the wrapper: gates [T·B,4H]
// fp32, dgb [T·B,4H] bf16, db_part [ceil(B/8),4H] and w_part
// [splits,E+H,4H] fp32. Out: dxs [T,B,E] bf16, dw [E+H,4H] (dWx over
// dWh) and db [4H] fp32. The dh loop runs on clusters of C blocks carrying
// R rows each (C = 1: one block a tile, R unused). T, B >= 1; E a
// multiple of 16, H of 16·C.
extern "C" int sse_lstm_bwd(const void* xs, const void* ys, const void* cs, const void* mask,
                            const void* wt, const void* wx, const void* wh,
                            const void* bias, const void* dys, const void* dfin,
                            void* gates, void* dgb, void* db_part, void* w_part,
                            void* dxs, void* dw, void* db, int T, int B, int E, int H,
                            int splits, int C, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = 4 * H;
  if (C > 1 && !sse::dh::takes(4, H, C, R)) return (int)cudaErrorInvalidValue;
  const sse::XH xh = {static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(ys),
                      T * B, E, H, B};  // [xs ; h_prev] over T·B rows
  cudaError_t err;

  // 1. gates = [xs ; h_prev]·[Wx ; Wh] + b
  err = sse::launch_gates(xh, static_cast<const __nv_bfloat16*>(wt), N,
                          static_cast<const float*>(bias), static_cast<float*>(gates), st);
  if (err != cudaSuccess) return (int)err;

  // 2. the serial dh / dc loop
  const auto* g_f = static_cast<const float*>(gates);
  const auto* cs_b = static_cast<const __nv_bfloat16*>(cs);
  const auto* m_f = static_cast<const float*>(mask);
  const auto* wh_b = static_cast<const __nv_bfloat16*>(wh);
  const auto* dys_b = static_cast<const __nv_bfloat16*>(dys);
  const auto* dfin_f = static_cast<const float*>(dfin);
  auto* dgb_b = static_cast<__nv_bfloat16*>(dgb);
  auto* dbp_f = static_cast<float*>(db_part);
  err = C > 1      ? sse::dh::launch<4, LstmDh>(B, H, C, R, st, g_f, cs_b, m_f, wh_b, dys_b, dfin_f,
                                                 dgb_b, dbp_f, T, B, H, C, R)
        : H == 128 ? launch_dh<128>(g_f, cs_b, m_f, wh_b, dys_b, dfin_f, dgb_b, dbp_f, T, B, H, st)
                   : launch_dh<0>(g_f, cs_b, m_f, wh_b, dys_b, dfin_f, dgb_b, dbp_f, T, B, H, st);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cdiv(B, BN);

  // 3-5. dxs = bf16(dgates_b·Wxᵀ), the split-K dW partials, their in-order sums
  return (int)sse::launch_bwd_products(
      xh, static_cast<const __nv_bfloat16*>(dgb), static_cast<const __nv_bfloat16*>(wx), N, splits,
      static_cast<float*>(w_part), static_cast<const float*>(db_part), nblk,
      static_cast<__nv_bfloat16*>(dxs), static_cast<float*>(dw), static_cast<float*>(db), st);
}
