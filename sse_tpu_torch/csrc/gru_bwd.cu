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
//   1. gates   [T·B, 3H] fp32 = [xs ; h_prev]·[Wx ; Wh] + b   (wgmma, TMA)
//   2. dh      the reverse loop: one block owns 8 batch rows for all T
//              steps; it writes dgates_b [T·B, 3H] bf16 and a per-block
//              fp32 db partial.
//   3. dxs     [T·B, E] = dgates_b·Wxᵀ                       (wgmma, TMA)
//   4. dW      [E+H, 3H] = [xs ; h_prev]ᵀ·dgates_b, split over T·B into
//              fixed fp32 partial buffers                    (wgmma, TMA)
//   5. reduce  sums the dW and db partials in a fixed order.
//
// Taking the gate recompute off the serial chain is what the TPU kernel's
// own comment asks for (pallas_rnn.py:145-149); it also keeps the serial
// kernel's shared memory to its step inputs (and Wh, at widths where Wh
// is not held in registers): [Wx;Wh] for the recompute plus Whᵀ would
// need ~301 KB, above the 232,448-byte opt-in limit. No float atomics
// anywhere: every sum runs in an order fixed by the shapes, so the
// gradients are the same from run to run.
//
// What bounds it on the H100: the dh loop is serial over T, and a step is
// a chain: the cell backward's dh-dependent part, one barrier, and the
// dh product. The design keeps everything else off that chain:
//   * Transposed product: dhᵀ = Wh·dgates_bᵀ, so the H units are the m16
//     rows of mma.sync and a block's BN=8 batch rows one n8 tile: 24
//     products a warp a step at H=128, and B=256 and 384 run on 32 and 48
//     SMs. With H=128 at compile time each warp holds its Wh fragments in
//     registers (96 a thread), so the product reads only the 6 KB
//     dgates_b tile from shared memory, in one accumulator chain per gate.
//   * Step inputs: each warp copies its own inputs three steps ahead (its
//     units' fp32 z, r, n_pre for 8 rows: 1.5 KB; dys_t, ys_{t-1}, the
//     mask) into a shared stage by cp.async, so no barrier guards them
//     (the 59 MB gates buffer at T=50, B=384 does not stay in the 50 MB
//     L2).
//   * The gates' nonlinearities (σ(z), σ(r), tanh(r·n_pre)) need no dh:
//     each step's are computed while the step before runs its product,
//     staged so the divisions (IEEE, each a branch) run back to back.
//   * dgates_b goes to global memory from the shared tile in 16-byte
//     stores, while the product runs.
// The three products (1, 3, 4: products.cu, bound by bytes) are ~3.8
// GFLOP each at T=50, B=384; the gates buffer costs 2·T·B·3H·4 bytes of
// traffic.
//
// Widths: H=128 holds Wh in registers; other H up to 176 take a generic
// instance with Wh in shared memory; wider layers (Wh at H=256 is 405,504
// B) take the cluster instance, gru_bwd_dh_cluster_kernel<THREADS>
// (dh_cluster.cuh), which splits Wh's rows over C <= 8 blocks, a cluster
// carrying R batch rows. The wrapper's plan (ops/rnn.py layer_plan) picks
// the instance and C, the launch R.
#include "dh_cluster.cuh"
#include "products.cuh"

namespace {

constexpr int BN = 8;     // dh kernel: batch rows per block (one n8 tile)
constexpr int WH = 16;    // dh kernel: hidden units per warp (one m16 tile)
constexpr int KPAD = 8;   // bf16 row padding: conflict-free 32-bit fragment loads
constexpr int GPAD = 4;   // fp32 gate row padding: rows 2·tig apart fall in distinct banks
constexpr int MAX_THREADS = 352;  // 2H threads; H <= 176 is what shared memory allows

// Input stages of the dh loop: three with H fixed at compile time (Wh in
// registers leaves room), one with Wh in shared memory (two do not fit
// at H=176).
__host__ __device__ constexpr int dh_stages(int kh) { return kh ? 3 : 1; }

// Byte offsets of the dh kernel's shared buffers: Wh [H][ldw] bf16 as
// stored (only where it is not held in registers), dgates_b [2][BN][ldw]
// bf16, then `stages` stages of step inputs, each gates [BN][ldg] fp32,
// dys_t and h_{t-1} [BN][ldv] bf16 and the mask, one [BN] copy per warp.
struct DhLayout {
  int ldw, ldg, ldv, wh, dg, st, g, dy, hp, m, stage, total;
};

__host__ __device__ inline DhLayout dh_layout(int H, int stages, bool wh_shared) {
  DhLayout L;
  L.ldw = 3 * H + KPAD;
  L.ldg = 3 * H + GPAD;
  L.ldv = H + KPAD;
  L.wh = 0;
  L.dg = L.wh + (wh_shared ? H * L.ldw * 2 : 0);
  L.st = L.dg + 2 * BN * L.ldw * 2;
  L.g = 0;  // offsets inside a stage
  L.dy = L.g + BN * L.ldg * 4;
  L.hp = L.dy + BN * L.ldv * 2;
  L.m = L.hp + BN * L.ldv * 2;
  L.stage = L.m + (H / WH) * BN * 4;
  L.total = L.st + stages * L.stage;
  return L;
}

// The serial reverse loop, transposed: dhᵀ = Wh·dgates_bᵀ, so the H units
// are the m16 rows of mma.sync and the block's BN=8 batch rows one n8
// tile. Warp w owns units [16w, 16w+16): the cell backward for a (unit,
// row) needs z, r, n_pre that the same warp copied, and its dh fragment
// sits where the forward kernel's h carry does. KH: H at compile time,
// with the warp's Wh fragments held in registers (0: H from the argument,
// Wh in shared memory, one input stage).
template <int KH>
__global__ void __launch_bounds__(KH ? 2 * KH : MAX_THREADS, 1)
gru_bwd_dh_kernel(const float* __restrict__ gates, const __nv_bfloat16* __restrict__ ys,
                  const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wh,
                  const __nv_bfloat16* __restrict__ dys, const float* __restrict__ dfin,
                  __nv_bfloat16* __restrict__ dgb, float* __restrict__ db_part, int T, int B,
                  int h_arg) {
  constexpr bool WREG = KH != 0;
  constexpr int STAGES = dh_stages(KH);  // copies run STAGES steps ahead
  const int H = KH ? KH : h_arg, N = 3 * H;
  const DhLayout L = dh_layout(H, STAGES, !WREG);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* whs = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);  // Wh as stored
  __nv_bfloat16* dgs = reinterpret_cast<__nv_bfloat16*>(smem + L.dg);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * BN;
  const int col0 = warp * WH;
  const int u0 = col0 + grp;  // this thread's units: u0 and u0 + 8; rows 2·tig, 2·tig+1

  // What this lane copies each step, as offsets fixed for the whole loop:
  // three 16-byte pieces of the warp's fp32 z, r, n_pre columns (8 rows x
  // 3 gates x 4 pieces); lanes < 16 one piece of dys_t, the others one of
  // h_{t-1} (8 rows x 2 pieces); lanes < 8 one mask value. Rows >= B (and
  // h_{-1}) are zero-filled.
  constexpr int GP = BN * 12 / 32;
  int g_s[GP], g_g[GP];  // gates: shared (floats into a stage), global (floats into a step)
  unsigned g_ok = 0;
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    const int q = lane + 32 * j, r = q / 12, rem = q - 12 * r;
    const int col = (rem >> 2) * H + col0 + (rem & 3) * 4;
    g_s[j] = r * L.ldg + col;
    g_g[j] = (row0 + r) * N + col;
    g_ok |= (row0 + r < B ? 1u : 0u) << j;
  }
  const bool is_hp = lane >= 16;
  const int v_r = (lane & 15) >> 1, v_col = col0 + (lane & 1) * 8;
  const int v_s = (is_hp ? L.hp : L.dy) / 2 + v_r * L.ldv + v_col;  // bf16 offset into a stage
  const int v_g = (row0 + v_r) * H + v_col;
  const bool v_ok = row0 + v_r < B, m_ok = lane < BN && row0 + lane < B;

  // iteration i's inputs (step s = T-1-i) into stage i % STAGES: this
  // warp's columns only, one group of copies
  auto fetch = [&](int i) {
    const int s = T - 1 - i;
    if (s >= 0) {
      unsigned char* st = smem + L.st + (i % STAGES) * L.stage;
      float* sg = reinterpret_cast<float*>(st + L.g);
      const float* gs = gates + (size_t)s * B * N;
#pragma unroll
      for (int j = 0; j < GP; ++j) {
        const bool v = (g_ok >> j) & 1u;
        sse::cp_async16(sg + g_s[j], gs + (v ? g_g[j] : 0), v);
      }
      // dys_t, or h_{t-1} = ys[t-1] (zero at t = 0)
      const __nv_bfloat16* src = is_hp ? ys + (size_t)(s > 0 ? s - 1 : 0) * B * H
                                       : dys + (size_t)s * B * H;
      sse::cp_async16(reinterpret_cast<__nv_bfloat16*>(st) + v_s, src + (v_ok ? v_g : 0),
                      v_ok && (!is_hp || s > 0));
      if (lane < BN)
        sse::cp_async4(reinterpret_cast<float*>(st + L.m) + warp * BN + lane,
                       mask + (size_t)s * B + (m_ok ? row0 + lane : 0), m_ok);
    }
    sse::cp_async_commit();
  };

  // C[u][n] = Σ_k Wh[u][k]·dg[n][k]: an A fragment is Wh's rows u0, u0+8,
  // k-contiguous as stored. With H known, each warp keeps its m16 tile's
  // fragments in registers (96 at H=128), so the product reads only the
  // dgates_b tile from shared memory; else Wh is staged there.
  constexpr int NK = KH ? 3 * KH / 16 : 1;
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

  // fp32 dh carry and the db sums over this thread's rows; fragment c is
  // unit u0 + 8·(c >> 1), row 2·tig + (c & 1)
  float dh[4], dbs[3][2] = {};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int r = row0 + 2 * tig + (c & 1);
    dh[c] = r < B ? dfin[(size_t)r * H + u0 + 8 * (c >> 1)] : 0.f;
  }

  // Iteration i's inputs from its stage, and the nonlinearities of its
  // gates (they need no dh, so each step's are computed while the step
  // before runs its product): z = σ(z_pre), r = σ(r_pre), n = tanh(r·n_pre),
  // staged as in the forward kernel (exponentials, then the divisions back
  // to back, then the tanh: each IEEE division and tanhf is a branch the
  // compiler schedules on its own). The same functions as sse::sigmoid
  // and tanhf.
  float z[4], rg[4], n[4], npre[4], dyv[4], hprev[4], m[2];
  auto prepare = [&](int i) {
    sse::cp_async_wait<STAGES - 1>();  // this thread's copies of iteration i
    __syncwarp();                      // ... and its warp's
    const unsigned char* st = smem + L.st + (i % STAGES) * L.stage;
    const float* sg = reinterpret_cast<const float*>(st + L.g);
    const __nv_bfloat16* sdy = reinterpret_cast<const __nv_bfloat16*>(st + L.dy);
    const __nv_bfloat16* shp = reinterpret_cast<const __nv_bfloat16*>(st + L.hp);
    const float* sm = reinterpret_cast<const float*>(st + L.m) + warp * BN;
    m[0] = sm[2 * tig];
    m[1] = sm[2 * tig + 1];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = 2 * tig + (c & 1), u = u0 + 8 * (c >> 1);
      z[c] = expf(-sg[r * L.ldg + u]);
      rg[c] = expf(-sg[r * L.ldg + H + u]);
      npre[c] = sg[r * L.ldg + 2 * H + u];
      dyv[c] = __bfloat162float(sdy[r * L.ldv + u]);
      hprev[c] = __bfloat162float(shp[r * L.ldv + u]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      z[c] = sse::sigmoid_exp(z[c]);
      rg[c] = sse::sigmoid_exp(rg[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) n[c] = tanhf(npre[c] * rg[c]);
  };

  prepare(0);
  int cur = 0;
  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    __nv_bfloat16* dg = dgs + cur * BN * L.ldw;
    float base[4];  // (1-m)·dh_t + g·z

    // the cell backward's part that needs dh: the chain
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float mc = m[c & 1];
      const float dh_t = dh[c] + dyv[c];
      const float g = mc * dh_t;  // d h_new
      const float zc = z[c], rc = rg[c], nc = n[c];
      // h_new = (1-z)·n + z·h_prev
      const float dnn = g * (1.f - zc);
      const float dz = g * (hprev[c] - nc) * zc * (1.f - zc);
      const float dtanh = dnn * (1.f - nc * nc);
      const float dn = dtanh * rc;
      const float dr = dtanh * npre[c] * rc * (1.f - rc);
      base[c] = (1.f - mc) * dh_t + g * zc;
      dbs[0][c >> 1] += dz;
      dbs[1][c >> 1] += dr;
      dbs[2][c >> 1] += dn;
      __nv_bfloat16* ds = dg + (2 * tig + (c & 1)) * L.ldw + u0 + 8 * (c >> 1);
      ds[0] = __float2bfloat16(dz);
      ds[H] = __float2bfloat16(dr);
      ds[2 * H] = __float2bfloat16(dn);
    }
    __syncthreads();  // every warp's dgates_b of step t

    // dh = base + Wh·dgates_bᵀ over K = 3H, one accumulator chain per gate
    float acc[3][4] = {};
#pragma unroll
    for (int g = 0; g < 3; ++g)
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
    for (int c = 0; c < 4; ++c) dh[c] = base[c] + ((acc[0][c] + acc[1][c]) + acc[2][c]);
    cur ^= 1;
  }

  // db partial of this block: sum the 4 row pairs with a fixed shuffle tree
#pragma unroll
  for (int g = 0; g < 3; ++g)
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
cudaError_t launch_dh(const float* gates, const __nv_bfloat16* ys, const float* mask,
                      const __nv_bfloat16* wh, const __nv_bfloat16* dys, const float* dfin,
                      __nv_bfloat16* dgb, float* db_part, int T, int B, int H, cudaStream_t st) {
  const int smem = dh_smem(H);
  auto* kernel = gru_bwd_dh_kernel<KH>;
  // once a (kernel, card), at the opt-in most: the bytes vary with H
  const cudaError_t err = sse::allow_smem((const void*)kernel, sse::dh::kSmemMost);
  if (err != cudaSuccess) return err;
  kernel<<<cdiv(B, BN), 32 * (H / WH), smem, st>>>(gates, ys, mask, wh, dys, dfin, dgb, db_part,
                                                   T, B, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- clusters
// The dh loop on clusters of C blocks carrying R rows each
// (dh_cluster.cuh: the tile, the exchange, the barriers and the
// product); here the GRU's cell, the same values as gru_bwd_dh_kernel's
// bit for bit. Factors: σ(z), σ(r), n_pre, dys_t, h_{t-1}, n =
// tanh(r·n_pre).
struct GruCell {
  static constexpr int G = 3;

  __device__ __forceinline__ static void prepare(const float (&g)[3][4],
                                                 const unsigned short (&v)[2][4],
                                                 float (&f)[6][4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      f[0][c] = expf(-g[0][c]);
      f[1][c] = expf(-g[1][c]);
      f[2][c] = g[2][c];
      f[3][c] = sse::dh::bf16_bits(v[0][c]);
      f[4][c] = sse::dh::bf16_bits(v[1][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      f[0][c] = sse::sigmoid_exp(f[0][c]);
      f[1][c] = sse::sigmoid_exp(f[1][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) f[5][c] = tanhf(f[2][c] * f[1][c]);
  }

  __device__ __forceinline__ static void step(const float (&f)[6][4], const float (&m)[2],
                                              float (&dh)[4], float (&)[4], float (&dg)[3][4],
                                              float (&db)[3][2], float (&base)[4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float mc = m[c & 1];
      const float dh_t = dh[c] + f[3][c];
      const float g = mc * dh_t;
      const float zc = f[0][c], rc = f[1][c], nc = f[5][c];
      const float dnn = g * (1.f - zc);
      const float dtanh = dnn * (1.f - nc * nc);
      dg[0][c] = g * (f[4][c] - nc) * zc * (1.f - zc);
      dg[1][c] = dtanh * f[2][c] * rc * (1.f - rc);
      dg[2][c] = dtanh * rc;
      base[c] = (1.f - mc) * dh_t + g * zc;
#pragma unroll
      for (int k = 0; k < 3; ++k) db[k][c >> 1] += dg[k][c];
    }
  }
};

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_dh_cluster_kernel(const float* __restrict__ gates, const __nv_bfloat16* __restrict__ ys,
                          const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wh,
                          const __nv_bfloat16* __restrict__ dys, const float* __restrict__ dfin,
                          __nv_bfloat16* __restrict__ dgb, float* __restrict__ db_part, int T,
                          int B, int H, int C, int R) {
  sse::dh::cluster_loop<GruCell>(gates, ys, mask, wh, dys, dfin, dgb, db_part, T, B, H, C, R);
}

template <int THREADS>
struct GruDh {
  static auto kernel() { return &gru_bwd_dh_cluster_kernel<THREADS>; }
};

}  // namespace

// Shared memory of the dh kernel; the wrapper rejects shapes above the
// 232,448-byte opt-in limit before launching.
extern "C" int sse_gru_bwd_smem_bytes(int H) { return dh_smem(H); }

// The same for a block of the cluster instance on C blocks: with tiles of
// kPlanRows rows (the plan's test of a width), and with tiles of R rows;
// its threads for R rows (0: more than a block takes); and how many
// clusters of the tile the current card holds at once
// (cudaOccupancyMaxActiveClusters, kept after the first question; a
// negative cudaError_t where the tile cannot run or the question fails).
extern "C" int sse_gru_bwd_cluster_smem_bytes(int H, int C) {
  return sse::dh::layout(3, H, C, sse::dh::kPlanRows).total;
}
extern "C" int sse_gru_bwd_cluster_rows_smem_bytes(int H, int C, int R) {
  return sse::dh::layout(3, H, C, R).total;
}
extern "C" int sse_gru_bwd_cluster_threads(int H, int C, int R) {
  return sse::dh::threads(H, C, R);
}
extern "C" int sse_gru_bwd_cluster_active(int H, int C, int R) {
  int n = 0;
  const cudaError_t err = sse::dh::active<3, GruDh>(H, C, R, &n);
  return err == cudaSuccess ? n : -(int)err;
}

// Rows of the batch one dh block owns (the db partials come one per block).
extern "C" int sse_gru_bwd_block_rows() { return BN; }

// One GRU layer backward. xs [T,B,E], ys [T,B,H], dys [T,B,H] bf16; mask
// [T,1,B], dfin [B,H], bias [3H] fp32; wx [E,3H], wh [H,3H] and
// wt = [Wx;Wh]ᵀ [3H,E+H] bf16. Scratch from the wrapper: gates [T·B,3H]
// fp32, dgb [T·B,3H] bf16, db_part [ceil(B/8),3H] and w_part
// [splits,E+H,3H] fp32. Out: dxs [T,B,E] bf16, dw [E+H,3H] (dWx over
// dWh) and db [3H] fp32. The dh loop runs on clusters of C blocks carrying
// R rows each (C = 1: one block a tile, R unused). T, B >= 1; E a
// multiple of 16, H of 16·C.
extern "C" int sse_gru_bwd(const void* xs, const void* ys, const void* mask,
                           const void* wt, const void* wx, const void* wh,
                           const void* bias, const void* dys, const void* dfin,
                           void* gates, void* dgb, void* db_part, void* w_part,
                           void* dxs, void* dw, void* db, int T, int B, int E, int H,
                           int splits, int C, int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = 3 * H;
  if (C > 1 && !sse::dh::takes(3, H, C, R)) return (int)cudaErrorInvalidValue;
  const auto* xs_b = static_cast<const __nv_bfloat16*>(xs);
  const auto* ys_b = static_cast<const __nv_bfloat16*>(ys);
  const sse::XH xh = {xs_b, ys_b, T * B, E, H, B};  // [xs ; h_prev] over T·B rows
  cudaError_t err;

  // 1. gates = [xs ; h_prev]·[Wx ; Wh] + b
  err = sse::launch_gates(xh, static_cast<const __nv_bfloat16*>(wt), N,
                          static_cast<const float*>(bias), static_cast<float*>(gates), st);
  if (err != cudaSuccess) return (int)err;

  // 2. the serial dh loop
  const auto* g_f = static_cast<const float*>(gates);
  const auto* m_f = static_cast<const float*>(mask);
  const auto* wh_b = static_cast<const __nv_bfloat16*>(wh);
  const auto* dys_b = static_cast<const __nv_bfloat16*>(dys);
  const auto* dfin_f = static_cast<const float*>(dfin);
  auto* dgb_b = static_cast<__nv_bfloat16*>(dgb);
  auto* dbp_f = static_cast<float*>(db_part);
  err = C > 1      ? sse::dh::launch<3, GruDh>(B, H, C, R, st, g_f, ys_b, m_f, wh_b, dys_b, dfin_f,
                                                dgb_b, dbp_f, T, B, H, C, R)
        : H == 128 ? launch_dh<128>(g_f, ys_b, m_f, wh_b, dys_b, dfin_f, dgb_b, dbp_f, T, B, H, st)
                   : launch_dh<0>(g_f, ys_b, m_f, wh_b, dys_b, dfin_f, dgb_b, dbp_f, T, B, H, st);
  if (err != cudaSuccess) return (int)err;
  const int nblk = cdiv(B, BN);

  // 3-5. dxs = bf16(dgates_b·Wxᵀ), the split-K dW partials, their in-order sums
  return (int)sse::launch_bwd_products(
      xh, static_cast<const __nv_bfloat16*>(dgb), static_cast<const __nv_bfloat16*>(wx), N, splits,
      static_cast<float*>(w_part), static_cast<const float*>(db_part), nblk,
      static_cast<__nv_bfloat16*>(dxs), static_cast<float*>(dw), static_cast<float*>(db), st);
}
