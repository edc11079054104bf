// The products over all T·B rows of a recurrent layer, which the layers'
// kernels launch (rnn_scan.cu: the LSTM forward's x-product; gru_bwd.cu,
// lstm_bwd.cu: the backward's gate recompute, dxs and the split-K dW),
// and the fixed-order reduce of the dW and db partials. The kernels are
// in products.cu; see there for the design.
#pragma once

#include "common.cuh"

namespace {

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

namespace sse {

// [xs ; h_prev] over the M = T·B rows of a layer: xs [M, E] and ys [M, H]
// bf16, row-major, with h_prev row r = ys row r - B (zero for r < B,
// h_{-1} = 0). ys null: xs alone (the LSTM forward's x-product).
struct XH {
  const __nv_bfloat16* xs;
  const __nv_bfloat16* ys;
  int M, E, H, B;
};

// Rows of the T·B reduction a dW pipeline stage takes.
constexpr int kDwRowTile = 64;

// Rows of the T·B reduction that each of `splits` dW slices takes: slice z
// is rows [z·rows, min(M, (z+1)·rows)), a whole number of kDwRowTile. The
// wrapper's plan (ops/rnn.py dw_plan) picks splits so that no slice is
// empty and the same formula gives back its rows.
inline int dw_slice_rows(int M, int splits) {
  return cdiv(cdiv(M, splits), kDwRowTile) * kDwRowTile;
}

// out [M, N] fp32 = [xs ; h_prev]·[Wx ; Wh] + bias, with wt = [Wx;Wh]ᵀ
// [N, E+H] bf16 (the x-product alone, its Wx columns, where x.ys is null).
cudaError_t launch_gates(const XH& x, const __nv_bfloat16* wt, int N, const float* bias,
                         float* out, cudaStream_t st);

// The products of a layer backward after its serial loop, and the
// fixed-order reduce (dgb [M, N] bf16, wx [E, N] as stored):
//   dxs [M, E] = bf16(dgb·Wxᵀ)
//   dw  [E+H, N] = Σ_z [xs ; h_prev]ᵀ·dgb over slice z of the rows,
//       each slice's sum into w_part [splits, E+H, N] fp32
//   db  [N] = Σ_blk db_part[blk]  (the serial loop's nblk partials)
cudaError_t launch_bwd_products(const XH& x, const __nv_bfloat16* dgb, const __nv_bfloat16* wx,
                                int N, int splits, float* w_part, const float* db_part,
                                int nblk, __nv_bfloat16* dxs, float* dw, float* db,
                                cudaStream_t st);

}  // namespace sse
