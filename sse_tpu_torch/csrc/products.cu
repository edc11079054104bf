// The product engine of the recurrent layers, for Hopper (sm_90a): the
// products over all M = T·B rows of a layer, which the layer kernels
// launch (products.cuh), and the fixed-order reduce of their partials.
//
// What the TPU kernels compute, and where these products come from:
// _fwd_core (sse_tpu/ops/pallas_rnn.py:167-200) sums xs·Wx + b + h·Wh a
// step; the LSTM forward here takes xs·Wx + b for all steps at once
// (gates_product_kernel, its x-product), and the scan adds h·Wh
// (rnn_scan.cu). _bwd_kernel (pallas_rnn.py:217-314) recomputes the gates
// a step, writes dxs a step (:294-296) and carries dWx/dWh in VMEM across
// its sequential grid (:299-308). On Hopper blocks run in no order, so
// the backward recomputes every step's gates before its serial loop
// (gates_product_kernel over [xs ; h_prev]) and takes dxs
// (dxs_product_kernel) and dW (dw_product_kernel: fixed slices of the
// rows, summed in order by bwd_reduce_kernel; no atomics) after it.
//
// What bounds them on the H100: bytes. At E=H=128 a product reads or
// writes 2-4 bytes for every 4-8 of its operations' 2·K (K = 128..512),
// far under the ~295 operations a byte at which the tensor cores, not the
// memory, would limit. The largest stream is the fp32 gates (4 bytes an
// output): 472 MB for the x-product at T=50, B=4096. So the design keeps
// the memory busy and every byte moving once:
//   * One block, 288 threads: a producer warp whose one lane issues TMA
//     loads into a 3-stage ring of 32 KB (A and B, 128 x 64 bf16 each,
//     in the 128-byte swizzle), with full/empty mbarriers; two consumer
//     warpgroups, each a 64 x 128 fp32 accumulator, running wgmma
//     m64n128k16 (4 a stage) on the stage that landed.
//   * Two blocks an SM (~97 KB of shared memory and <= 112 registers a
//     thread each), so one block's loads run while the other stores.
//   * The output tile goes through shared memory (the ring, once both
//     warpgroups are done with it), in the swizzle TMA reads, and leaves
//     by TMA stores: whole lines, clipped at the tensor's edges.
//   * Blocks along the output's columns are adjacent in the grid, so the
//     blocks that read the same A rows run together and A leaves device
//     memory once (L2 serves the others).
//
// Operands (each a tensor map: TMA fills what lies outside with 0):
//   gates  A = xs, then ys loaded at row r - B (rows < 0 read 0: h_{-1} =
//          0), each K-major; B = the Wx and the Wh columns of wt =
//          [Wx;Wh]ᵀ, two maps zero past E and H. The xs and the ys columns
//          are tiled apart, so no k-step straddles column E.
//   dxs    A = dgb, B = wx as stored ([E, N]: K-major).
//   dW     A = [xs ; h_prev]ᵀ, B = dgb, both as TMA writes the row-major
//          tensors: MN-major, read with wgmma's transpose bits (no
//          transposing stage). Output rows from xs and from ys are tiled
//          apart and stored through two maps (dWx, dWh) of the partial
//          buffer. Slice z sums rows [z·slice, (z+1)·slice), a whole number
//          of 64-row stages, which the wrapper's plan sizes from the shapes
//          alone (ops/rnn.py dw_plan), never from the card.
//   Rows past M in the ys map pair with dgb rows that read 0, and ys (a
//   bf16 hidden state) is finite, so they add exact zeros.
//
// Rounding points (unchanged from the TPU kernel's): gates fp32, the bias
// added to the whole sum; dxs one bf16 rounding of the fp32 sum; each dW
// slice an fp32 sum, the slices summed in slice order.
#include "hopper.cuh"
#include "products.cuh"

namespace sse {
namespace {

constexpr int kBM = 128;               // output rows a block: two warpgroups of 64
constexpr int kBN = 128;               // output columns a block: wgmma n128
constexpr int kBK = 64;                // reduction depth a stage: 128 bytes of bf16
constexpr int kStages = 3;
constexpr int kBox = 8192;             // 64 rows x 128 bytes, swizzled
constexpr int kHalf = 2 * kBox;        // one operand's stage: 128 rows x 128 bytes
constexpr int kStageBytes = 2 * kHalf;
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kRing = kStages * kStageBytes;
constexpr int kSmem = kRing + 2 * kStages * 8 + 1024;  // ring, barriers, 1024-byte alignment

static_assert(kDwRowTile == kBK, "a dW slice is a whole number of stages");

enum Prod { kGates = 0, kDxs = 1, kDw = 2 };

struct Args {
  int M;        // T·B
  int shift;    // B: h_prev row r is ys row r - B
  int ka, kh;   // gates, dxs: k-steps over the first (xs; dgb) and the second (ys) pair
  int cols;     // output columns (N; E for dxs)
  int rows_a;   // output rows: M, or dW's from xs (E)
  int rows_h;   // dW's output rows from ys (H)
  int tiles_a;  // dW's row tiles from xs; the rest come from ys
  int slice;    // dW: rows of the T·B reduction a slice sums
  const float* bias;
};

// One output tile of product P (see the top of the file). a1/b1 are the
// second operand pair (gates: ys and Wh; dW: a1 = ys), o1 dW's dWh map.
template <int P>
__device__ __forceinline__ void product(unsigned char* smem, const CUtensorMap* a0,
                                        const CUtensorMap* a1, const CUtensorMap* b0,
                                        const CUtensorMap* b1, const CUtensorMap* o0,
                                        const CUtensorMap* o1, const Args& g) {
  unsigned char* ring = align1024(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing);
  uint64_t* empty = full + kStages;
  const int lane = threadIdx.x & 31;

  const int n0 = blockIdx.x * kBN;
  int r0 = blockIdx.y * kBM, m0 = 0, steps = g.ka + g.kh;
  bool from_h = false;
  if (P == kDw) {
    from_h = (int)blockIdx.y >= g.tiles_a;
    if (from_h) r0 -= g.tiles_a * kBM;
    m0 = blockIdx.z * g.slice;
    steps = (max(0, min(g.M, m0 + g.slice) - m0) + kBK - 1) / kBK;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages + 1) & 1);
        unsigned char* a = ring + s * kStageBytes;
        unsigned char* b = a + kHalf;
        mbar_expect_tx(&full[s], kStageBytes);
        if (P == kDw) {  // 64 rows of the reduction: two 64-column boxes of each operand
          const int m = m0 + i * kBK;
          const CUtensorMap* am = from_h ? a1 : a0;
          const int ar = from_h ? m - g.shift : m;
          tma_load(a, am, &full[s], r0, ar);
          tma_load(a + kBox, am, &full[s], r0 + 64, ar);
          tma_load(b, b0, &full[s], n0, m);
          tma_load(b + kBox, b0, &full[s], n0 + 64, m);
        } else if (i < g.ka) {  // 64 columns of the reduction: 128 rows of each operand
          tma_load(a, a0, &full[s], i * kBK, r0);
          tma_load(b, b0, &full[s], i * kBK, n0);
        } else {
          tma_load(a, a1, &full[s], (i - g.ka) * kBK, r0 - g.shift);
          tma_load(b, b1, &full[s], (i - g.ka) * kBK, n0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64·wg, 64·wg + 64) of the tile
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    __syncwarp();  // wgmma is .sync.aligned: the warp converged after its barrier wait
    const uint32_t a = smem_addr(ring + s * kStageBytes) + wg * kBox;
    const uint32_t b = smem_addr(ring + s * kStageBytes + kHalf);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (P == kDw)  // 16 rows of the reduction: 16 rows of 128 bytes on
        wgmma_bf16<1, 1>(acc, mn_desc(a + kk * 2048, kBox), mn_desc(b + kk * 2048, kBox));
      else  // 16 columns of the reduction: 32 bytes on in every row
        wgmma_bf16(acc, sw_desc<128>(a + kk * 32), sw_desc<128>(b + kk * 32));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: both warpgroups are done with the ring, which now stages the
  // output as TMA stores read it: boxes of 64 rows x 128 bytes (32 fp32 or
  // 64 bf16 columns) in the 128-byte swizzle. Accumulator d[4j + c] is row
  // 16·wq + g + 8(c >> 1), column 8j + 2·tig + (c & 1), lane = 4g + tig.
  named_sync(1, kConsumers);
  unsigned char* out = ring + wg * (P == kDxs ? 2 : 4) * kBox;
  const int g8 = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * tig;
    float bias0 = 0.f, bias1 = 0.f;
    if (P == kGates && n0 + n < g.cols) {  // N is even: n0 + n < N ⇒ n0 + n + 1 < N
      bias0 = g.bias[n0 + n];
      bias1 = g.bias[n0 + n + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wq + g8 + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (P == kGates) {
        v0 += bias0;
        v1 += bias1;
      }
      if (P == kDxs) {
        const int c = n & 63;
        *reinterpret_cast<__nv_bfloat162*>(out + (n >> 6) * kBox + swz<128>(r, c >> 3) +
                                           (c & 7) * 2) = __floats2bfloat162_rn(v0, v1);
      } else {
        const int c = n & 31;
        *reinterpret_cast<float2*>(out + (n >> 5) * kBox + swz<128>(r, c >> 2) + (c & 3) * 4) =
            make_float2(v0, v1);
      }
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    const int row = r0 + 64 * wg;
    if (row < (from_h ? g.rows_h : g.rows_a)) {
      constexpr int kBoxes = P == kDxs ? 2 : 4, kWidth = kBN / kBoxes;
      for (int q = 0; q < kBoxes && n0 + q * kWidth < g.cols; ++q) {
        if (P == kDw)
          tma_store(from_h ? o1 : o0, out + q * kBox, n0 + q * kWidth, row, (int)blockIdx.z);
        else
          tma_store(o0, out + q * kBox, n0 + q * kWidth, row);
      }
      bulk_commit();
      bulk_wait_read();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    gates_product_kernel(const __grid_constant__ CUtensorMap xs, const __grid_constant__ CUtensorMap ys,
                         const __grid_constant__ CUtensorMap wx, const __grid_constant__ CUtensorMap wh,
                         const __grid_constant__ CUtensorMap out, const Args g) {
  extern __shared__ unsigned char smem[];
  product<kGates>(smem, &xs, &ys, &wx, &wh, &out, &out, g);
}

__global__ void __launch_bounds__(kThreads, 2)
    dxs_product_kernel(const __grid_constant__ CUtensorMap dgb, const __grid_constant__ CUtensorMap wx,
                       const __grid_constant__ CUtensorMap out, const Args g) {
  extern __shared__ unsigned char smem[];
  product<kDxs>(smem, &dgb, &dgb, &wx, &wx, &out, &out, g);
}

__global__ void __launch_bounds__(kThreads, 2)
    dw_product_kernel(const __grid_constant__ CUtensorMap xs, const __grid_constant__ CUtensorMap ys,
                      const __grid_constant__ CUtensorMap dgb, const __grid_constant__ CUtensorMap dwx,
                      const __grid_constant__ CUtensorMap dwh, const Args g) {
  extern __shared__ unsigned char smem[];
  product<kDw>(smem, &xs, &ys, &dgb, &dgb, &dwx, &dwh, g);
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

// A map over bf16 [rows, cols], rows `ld` elements apart, in boxes of 64
// columns (128 bytes) x box_rows rows.
int bf16_map(CUtensorMap* map, const __nv_bfloat16* p, int cols, int rows, int ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims, strides, box);
}

// A map over fp32 [rows, cols] (planes = 0) or [planes, rows, cols] with
// planes `plane` elements apart; rows `ld` elements apart; boxes of 32
// columns (128 bytes) x 64 rows (x 1 plane).
int f32_map(CUtensorMap* map, const float* p, int cols, int rows, int ld, int planes,
            size_t plane) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)plane * 4};
  const cuuint32_t box[3] = {32, 64, 1};
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, planes ? 3 : 2, p, dims, strides, box);
}

template <typename Kernel>
cudaError_t allow(Kernel* kernel) {
  return allow_smem(reinterpret_cast<const void*>(kernel), kSmem);
}

}  // namespace

cudaError_t launch_gates(const XH& x, const __nv_bfloat16* wt, int N, const float* bias,
                         float* out, cudaStream_t st) {
  const int ldw = x.E + x.H;
  CUtensorMap xs, ys, wx, wh, o;
  int err = bf16_map(&xs, x.xs, x.E, x.M, x.E, kBM);
  if (!err) err = bf16_map(&wx, wt, x.E, N, ldw, kBN);
  if (!err && x.ys) err = bf16_map(&ys, x.ys, x.H, x.M, x.H, kBM);
  if (!err && x.ys) err = bf16_map(&wh, wt + x.E, x.H, N, ldw, kBN);
  if (!err) err = f32_map(&o, out, N, x.M, N, 0, 0);
  if (err) return (cudaError_t)err;
  if (!x.ys) ys = xs, wh = wx;  // not read: no k-step takes the second pair
  Args g{};
  g.M = x.M;
  g.shift = x.B;
  g.ka = cdiv(x.E, kBK);
  g.kh = x.ys ? cdiv(x.H, kBK) : 0;
  g.cols = N;
  g.rows_a = x.M;
  g.bias = bias;
  if (const cudaError_t e = allow(gates_product_kernel)) return e;
  gates_product_kernel<<<dim3(cdiv(N, kBN), cdiv(x.M, kBM)), kThreads, kSmem, st>>>(xs, ys, wx,
                                                                                     wh, o, g);
  return cudaGetLastError();
}

cudaError_t launch_bwd_products(const XH& x, const __nv_bfloat16* dgb, const __nv_bfloat16* wx,
                                int N, int splits, float* w_part, const float* db_part,
                                int nblk, __nv_bfloat16* dxs, float* dw, float* db,
                                cudaStream_t st) {
  const int M = x.M, E = x.E, H = x.H;
  cudaError_t e;

  // dxs [M, E] = bf16(dgb·Wxᵀ)
  CUtensorMap dg, w, o;
  int err = bf16_map(&dg, dgb, N, M, N, kBM);
  if (!err) err = bf16_map(&w, wx, N, E, N, kBN);
  if (!err) err = bf16_map(&o, dxs, E, M, E, 64);
  if (err) return (cudaError_t)err;
  Args g{};
  g.M = M;
  g.ka = cdiv(N, kBK);
  g.cols = E;
  g.rows_a = M;
  if ((e = allow(dxs_product_kernel))) return e;
  dxs_product_kernel<<<dim3(cdiv(E, kBN), cdiv(M, kBM)), kThreads, kSmem, st>>>(dg, w, o, g);
  if ((e = cudaGetLastError())) return e;

  // the dW partials [splits, E+H, N]: slice z into plane z
  CUtensorMap xa, ha, dgr, ox, oh;
  const size_t plane = (size_t)(E + H) * N;
  err = bf16_map(&xa, x.xs, E, M, E, kBK);
  if (!err) err = bf16_map(&ha, x.ys, H, M, H, kBK);
  if (!err) err = bf16_map(&dgr, dgb, N, M, N, kBK);
  if (!err) err = f32_map(&ox, w_part, N, E, N, splits, plane);
  if (!err) err = f32_map(&oh, w_part + (size_t)E * N, N, H, N, splits, plane);
  if (err) return (cudaError_t)err;
  Args d{};
  d.M = M;
  d.shift = x.B;
  d.cols = N;
  d.rows_a = E;
  d.rows_h = H;
  d.tiles_a = cdiv(E, kBM);
  d.slice = dw_slice_rows(M, splits);
  if ((e = allow(dw_product_kernel))) return e;
  dw_product_kernel<<<dim3(cdiv(N, kBN), cdiv(E, kBM) + cdiv(H, kBM), splits), kThreads, kSmem,
                      st>>>(xa, ha, dgr, ox, oh, d);
  if ((e = cudaGetLastError())) return e;

  const int wsize = (E + H) * N;
  bwd_reduce_kernel<<<cdiv(wsize + N, 256), 256, 0, st>>>(w_part, splits, wsize, db_part, nblk,
                                                          N, dw, db);
  return cudaGetLastError();
}

}  // namespace sse
