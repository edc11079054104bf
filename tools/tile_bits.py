"""Do the two tensor-core products of the port's top-k kernels give the same
float32 scores, bit for bit? On a CUDA card.

    python3 tools/tile_bits.py        # needs one CUDA card and nvcc

The two-phase kernels score through ``score_tile`` (``csrc/topk_tile.cuh``:
wgmma m64n128k16, A and B from shared memory); the streaming kernels
through ``score_mma`` (``csrc/topk_common.cuh``: mma.sync m16n8k16, B
fragments from global memory). Both sum the same k16 slices in the same
order from +0. This script builds a small kernel that runs both on the
same 64 random bf16 unit query rows against 131,072 random bf16 unit
index rows (D = 128), and counts the scores whose bits differ, and the
packed keys (11 mantissa bits) that differ. A difference would mean the
streaming route and the two-phase route can rank a near-tie apart.
The kernel is built into ``build/tile_bits/`` from the sources as they are.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "tile_bits")

SOURCE = r"""
#include "topk_tile.cuh"
using namespace sse;

// one block per 128 index rows: the warpgroup's score_tile over the tile,
// then each warp's score_mma for its 16 queries over the same rows
__global__ void __launch_bounds__(128) bits_kernel(const unsigned char* q, const unsigned char* emb,
                                                   int T, float* out_wg, float* out_mma) {
  extern __shared__ unsigned char raw[];
  unsigned char* sa = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  unsigned char* sb = sa + 2 * 64 * kChunkBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * kTileN;
  for (int x = tid; x < 64 * 16; x += 128) {
    const int r = x / 16, j = x % 16;
    cp_async16(sa + (j >> 3) * 64 * kChunkBytes + sw128(r, j & 7), q + r * 256 + 16 * j, true);
  }
  for (int x = tid; x < kTileN * 16; x += 128) {
    const int r = x / 16, j = x % 16;
    cp_async16(sb + (j >> 3) * kTileChunk + sw128(r, j & 7),
               emb + (size_t)(row0 + r) * 256 + 16 * j, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float acc[64];
  score_tile<kBF16, 8>(acc, smem_addr(sa), 64 * kChunkBytes, smem_addr(sb), kTileChunk);
  for (int j = 0; j < 16; ++j)
    for (int c = 0; c < 4; ++c)
      out_wg[(size_t)(16 * warp + g + 8 * (c >> 1)) * T + row0 + 8 * j + 2 * tig + (c & 1)] =
          acc[4 * j + c];
  uint32_t a[8][4];
  load_a<8>(a, q + (16 * warp + g) * 256, q + (16 * warp + g + 8) * 256, tig);
  float m[16][4];
  score_mma<kBF16, 8, 16>(a, emb, 256, T, row0, g, tig, m);
  for (int j = 0; j < 16; ++j)
    for (int c = 0; c < 4; ++c)
      out_mma[(size_t)(16 * warp + g + 8 * (c >> 1)) * T + row0 + 8 * j + 2 * tig + (c & 1)] =
          m[j][c];
}

extern "C" int tile_bits(const void* q, const void* emb, int T, float* out_wg, float* out_mma) {
  const int smem = 1024 + 2 * 64 * kChunkBytes + 2 * kTileChunk;
  cudaFuncSetAttribute(bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bits_kernel<<<T / kTileN, 128, smem>>>(static_cast<const unsigned char*>(q),
                                          static_cast<const unsigned char*>(emb), T, out_wg,
                                          out_mma);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}
"""


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("tile_bits: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from sse_tpu_torch.ops import _build, topk

    os.makedirs(WORK, exist_ok=True)
    src, lib = os.path.join(WORK, "tile_bits.cu"), os.path.join(WORK, "libtile_bits.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
                    "-fPIC", "-I", _build.CSRC, "-o", lib, src], check=True)
    fn = ctypes.CDLL(lib).tile_bits
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    T = 131072

    def unit(n):
        x = torch.randn((n, 128), generator=gen, device="cuda")
        return (x / x.norm(dim=1, keepdim=True)).bfloat16().contiguous()

    q, emb = unit(64), unit(T)
    wg = torch.empty((64, T), device="cuda")
    mma = torch.empty((64, T), device="cuda")
    status = fn(q.data_ptr(), emb.data_ptr(), T, wg.data_ptr(), mma.data_ptr())
    if status:
        raise RuntimeError(f"tile_bits kernel failed: cudaError {status}")
    exact = (q.double() @ emb.double().T).float()
    bits = int((wg.view(torch.int32) != mma.view(torch.int32)).sum())
    keys = int((topk.enc_key(wg, False) != topk.enc_key(mma, False)).sum())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(f"tile_bits: {64 * T} scores (64 bf16 unit queries x {T} bf16 unit rows, D=128): "
          f"{bits} differ in their float32 bits between wgmma (score_tile) and mma.sync "
          f"(score_mma), {keys} in their 11-bit keys; max |wgmma - float64| "
          f"{float((wg - exact).abs().max()):.3e}, max |mma.sync - float64| "
          f"{float((mma - exact).abs().max()):.3e} [{card}]", flush=True)


if __name__ == "__main__":
    main()
