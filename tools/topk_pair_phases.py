"""Where the two-phase top-k's phase 2 (the pair kernel) spends its cycles,
on a CUDA card.

    python3 tools/topk_pair_phases.py [CHECKOUT]   # needs one CUDA card

Copies ``CHECKOUT/sse_tpu_torch`` (default: this repository's) into
``build/topk_pair_phases/``, inserts ``clock64()`` counters between the
parts of a 64- or 128-row step of the pair kernel, builds that copy and
runs phase 2 at B=4096, k=10, block_t=2048 on the 1,249,280 x 128 index
(exact-dot bf16 rows, then int8 unit rows), with the pairs phase 1 chose.
Prints, per tile of 64 (query, block) pairs, the cycles of thread 0 of
the CTA in each part, the steps, and the share of steps that end in a
merge. Two layouts of the kernel are known:

* the wgmma pair kernel (``csrc/topk_twophase.cu`` ``wg_pairs_kernel``):
  parts "wait for the tile", "score (wgmma)", "compare + append",
  "merge" (warp 0's merges, which only its 16 queries wait for), and the
  final per-query merge and write; a step's merge share is warp 0's;
* the mma.sync kernel it replaced (``range_topk`` in
  ``csrc/topk_common.cuh``, before the two-phase route moved to the wgmma
  tile): "score (loads + mma.sync)", "compare + append",
  "__syncthreads_or", "merge" (the block-wide warp-per-query merge); a
  step ends in a merge when any of the 64 queries took a candidate.

A part ends when its last instruction issues, so a wait shows in the part
whose instruction first uses the result. The counters cost a few cycles
each; the times of the unmodified kernels are chip_smoke.py's. When the
anchored lines change, this script stops with the line it cannot find.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "topk_pair_phases")

COUNTER = """#ifndef PH
static __device__ unsigned long long pair_phase[16];
#define PH(i) { const unsigned long long now = clock64(); ph[i] += now - last; last = now; }
#endif
"""
DECL = "  unsigned long long ph[8] = {}, last = clock64(), steps = 0, merges = 0;\n"
FLUSH = ("  if (threadIdx.x == 0) {\n"
         "    for (int i = 0; i < 8; ++i) atomicAdd(&pair_phase[i], ph[i]);\n"
         "    atomicAdd(&pair_phase[8], steps); atomicAdd(&pair_phase[9], merges);\n"
         "    atomicAdd(&pair_phase[10], 1ull);\n  }\n")
READ = ('extern "C" int sse_pair_phase(unsigned long long* out) '
        '{{ return (int)cudaMemcpyFromSymbol(out, {name}, 128); }}\n')

# (file, anchor, where, text); "replace" puts text in the anchor's place
WG_PARTS = ["wait for the tile", "score (wgmma)", "compare + append", "merge",
            "final merge + write"]
WG_MARKS = [
    ("topk_twophase.cu", "// ------------------------------------------------- bf16 / int8: wgmma path",
     "before", COUNTER),
    ("topk_twophase.cu", "  AccT acc[64];\n  for (int i = 0; i < nt; ++i) {\n", "before", DECL),
    ("topk_twophase.cu", "\n    score_tile<DT, KS, CB>(acc, a_addr, kAChunk, r_addr + s * kStage, "
     "kTileN * CB);\n    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[s]);\n    const int lr0",
     "replace",
     "\n    PH(0)\n    score_tile<DT, KS, CB>(acc, a_addr, kAChunk, r_addr + s * kStage, "
     "kTileN * CB);\n    PH(1)\n    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[s]);\n"
     "    const int lr0"),
    ("topk_twophase.cu", "    if (m0 | m1) {\n      for (unsigned m = m0;", "before",
     "    PH(2)\n    steps += 1;\n    merges += (m0 | m1) != 0;\n"),
    ("topk_twophase.cu", "      t1 = thr[ql1];\n    }\n", "after", "    PH(3)\n"),
    ("topk_twophase.cu", "(x & ~kIdxMask, rs + kIdxMask - (x & kIdxMask));\n    }\n  }\n", "after",
     "  PH(4)\n" + FLUSH),
    ("topk_twophase.cu", "extern \"C\" int sse_twophase_blockmax(", "before",
     READ.format(name="pair_phase")),
]

MMA_PARTS = ["score (loads + mma.sync)", "compare + append", "__syncthreads_or", "merge"]
MMA_MARKS = [
    ("topk_common.cuh", "template <int DT, int KS, int MT, bool EX = false>\n__device__ void range_topk",
     "before", COUNTER),
    ("topk_common.cuh", "  for (int row0 = row_lo; row0 < lim; row0 += kTileRows) {\n", "before",
     DECL),
    ("topk_common.cuh", "    int added = 0;\n", "before", "    PH(0)\n"),
    ("topk_common.cuh", "    if (!__syncthreads_or(added)) continue;\n", "replace",
     "    PH(1)\n    {\n      const int any = __syncthreads_or(added);\n      PH(2)\n"
     "      steps += 1;\n      if (!any) continue;\n      merges += 1;\n    }\n"),
    ("topk_common.cuh", "    t0 = thr[ql0];\n    t1 = thr[ql1];\n", "after", "    PH(3)\n"),
    ("topk_common.cuh", "  __syncthreads();\n  for (int i = tid; i < QB * k; i += blockDim.x) {\n",
     "before", FLUSH),
    ("topk_twophase.cu", "extern \"C\" int sse_twophase_blockmax(", "before",
     READ.format(name="sse::pair_phase")),
]


def insert(csrc: str, marks) -> None:
    for name, anchor, where, text in marks:
        path = os.path.join(csrc, name)
        src = open(path).read()
        if src.count(anchor) != 1:
            raise SystemExit(f"{path}: cannot place a counter at {anchor!r}")
        new = {"before": text + anchor, "after": anchor + text, "replace": text}[where]
        open(path, "w").write(src.replace(anchor, new))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("topk_pair_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    checkout = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "sse_tpu_torch"), os.path.join(WORK, "sse_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(WORK, "sse_tpu_torch", "csrc")
    wgmma = "wg_pairs_kernel" in open(os.path.join(csrc, "topk_twophase.cu")).read()
    insert(csrc, WG_MARKS if wgmma else MMA_MARKS)
    parts = WG_PARTS if wgmma else MMA_PARTS
    sys.path.insert(0, WORK)
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import _build, topk

    lib = _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(1)
    T, D, B, K, BT = 1_249_280, 128, 4096, 10, 2048
    nr = T - 1000
    out = (ctypes.c_ulonglong * 16)()
    for dtype in ("bf16", "int8"):
        if dtype == "bf16":
            emb = (torch.randint(-16, 17, (T, D), generator=gen, device="cuda") / 16).bfloat16()
            q = (torch.randint(-16, 17, (B, D), generator=gen, device="cuda") / 16).bfloat16()
        else:
            x = torch.randn((T, D), generator=gen, device="cuda")
            emb = quantize_rows(x / x.norm(dim=1, keepdim=True), torch.int8)
            y = torch.randn((B, D), generator=gen, device="cuda")
            q = topk.quantize_queries_int8(y / y.norm(dim=1, keepdim=True))
        p1 = topk.twophase_phase1(q, emb, K, nr, BT)
        tq, tb, _ = topk.pair_schedule(p1, T // BT)
        topk.twophase_phase2(q, emb, K, nr, BT, tq, tb)
        torch.cuda.synchronize()
        lib.sse_pair_phase(out)
        before = list(out)
        topk.twophase_phase2(q, emb, K, nr, BT, tq, tb)
        torch.cuda.synchronize()
        lib.sse_pair_phase(out)
        got = [a - b for a, b in zip(out, before)]
        tiles = max(1, got[10])
        cyc = [got[i] / tiles for i in range(len(parts))]
        print(f"phase 2 {dtype} B={B} k={K} block_t={BT} ({'wgmma' if wgmma else 'mma.sync'} "
              f"kernel, {got[10]} tiles with a block): cycles a tile, thread 0: "
              + ", ".join(f"{n} {v:.0f}" for n, v in zip(parts, cyc))
              + f"; total {sum(cyc):.0f}; {got[8] / tiles:.1f} steps a tile, "
              f"{100.0 * got[9] / max(1, got[8]):.1f}% of steps end in a merge [{card} max SM clock]",
              flush=True)
        del emb, q
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
