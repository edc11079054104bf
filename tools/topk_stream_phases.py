"""Where the streaming top-k kernel spends its cycles, on a CUDA card.

    python3 tools/topk_stream_phases.py [CHECKOUT]   # needs one CUDA card

Copies ``CHECKOUT/sse_tpu_torch`` (default: this repository's) into
``build/topk_stream_phases/``, inserts ``clock64()`` counters between the
parts of a step of the streaming kernel, builds that copy and runs
``fused_score_topk`` on the 1,249,280 x 128 index of random unit rows
(bf16, then int8), num_real = T - 1000, at (variant, B, k) in CASES.
Prints, per CTA, the cycles of thread 0 in each part, the steps, and the
share of steps that end in a merge. Two layouts of the kernel are known:

* the wgmma kernel (``csrc/topk_stream.cu`` ``wg_stream_kernel``): parts
  "wait for the tile", "score (wgmma)" (with the wait for the warpgroup's
  other warps), "count + warp vote" (one compare a score), "append +
  merges" (the slow path, taken when a score of warp 0's rows beats its
  threshold) and the final merge and write; a step is one 128-row tile,
  and the share is of steps that take the slow path;
* the mma.sync kernel it replaced (``range_topk`` in
  ``csrc/topk_common.cuh``): "score (loads + mma.sync)", "compare +
  append", "__syncthreads_or", "merge" (the block-wide warp-per-query
  merge); a step is one 64-row tile, and it ends in a merge when any of
  the block's queries took a candidate.

A part ends when its last instruction issues, so a wait shows in the part
whose instruction first uses the result. The counters cost a few cycles
each; the times of the unmodified kernels are ``chip_smoke.py --stream``'s.
When the anchored lines change, this script stops with the line it cannot
find.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from topk_pair_phases import COUNTER, DECL, FLUSH, MMA_MARKS, MMA_PARTS, insert  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "topk_stream_phases")
CASES = [("packed", 8, 10), ("packed", 256, 10), ("exact", 8, 10), ("packed", 8, 100)]
READ = ('extern "C" int sse_stream_phase(unsigned long long* out) '
        '{{ return (int)cudaMemcpyFromSymbol(out, {name}, 128); }}\n')

# the mma.sync layout: topk_pair_phases's counters in range_topk, read
# from topk_stream.cu (each source keeps its own copy of the counters)
OLD_MARKS = [m for m in MMA_MARKS if m[0] == "topk_common.cuh"] + [
    ("topk_stream.cu", 'extern "C" int sse_topk_stream(', "before",
     READ.format(name="sse::pair_phase")),
]

WG_PARTS = ["wait for the tile", "score (wgmma)", "count + warp vote",
            "append + merges (slow path)", "final merge + write"]
WG_MARKS = [
    ("topk_stream.cu", "// ------------------------------------------------------ streaming kernel",
     "before", COUNTER),
    ("topk_stream.cu", "  AccT acc[64];\n  for (int it = 0, s = 0, par = 0; it < nt; ++it) {\n",
     "before", DECL),
    ("topk_stream.cu",
     "    score_tile<DT, KS, CB>(acc, a_addr, a_chunk, r_addr + s * kTile, kTileN * CB);\n",
     "replace",
     "    PH(0)\n    score_tile<DT, KS, CB>(acc, a_addr, a_chunk, r_addr + s * kTile, "
     "kTileN * CB);\n    PH(1)\n"),
    ("topk_stream.cu", "    if (!__any_sync(kFull, m0 | m1)) continue;\n", "replace",
     "    {\n      const bool any = __any_sync(kFull, m0 | m1);\n      PH(2)\n      steps += 1;\n"
     "      if (!any) continue;\n      merges += 1;\n    }\n"),
    ("topk_stream.cu",
     "    if (h1) select_half<1, DT, EX>(acc, r1, m1, cols, lists, W, row0, k, cap, lane);\n",
     "after", "    PH(3)\n"),
    ("topk_stream.cu",
     "    for (int c = lane; c < k; c += 32) o[c] = c < n ? entry_comp<EX, AccT>(list[c]) : kEmpty;"
     "\n  }\n", "after", "  PH(4)\n" + FLUSH),
    ("topk_stream.cu", 'extern "C" int sse_topk_stream(', "before",
     READ.format(name="pair_phase")),
]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("topk_stream_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    checkout = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "sse_tpu_torch"), os.path.join(WORK, "sse_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(WORK, "sse_tpu_torch", "csrc")
    wgmma = "wg_stream_kernel" in open(os.path.join(csrc, "topk_stream.cu")).read()
    insert(csrc, WG_MARKS if wgmma else OLD_MARKS)
    parts = WG_PARTS if wgmma else MMA_PARTS
    sys.path.insert(0, WORK)
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import _build, topk

    lib = _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(1)
    T, D = 1_249_280, 128
    nr = T - 1000
    out = (ctypes.c_ulonglong * 16)()
    for dtype in ("bf16", "int8"):
        x = torch.randn((T, D), generator=gen, device="cuda")
        y = torch.randn((256, D), generator=gen, device="cuda")
        x, y = x / x.norm(dim=1, keepdim=True), y / y.norm(dim=1, keepdim=True)
        if dtype == "bf16":
            emb, q_all = x.bfloat16(), y.bfloat16()
        else:
            emb, q_all = quantize_rows(x, torch.int8), topk.quantize_queries_int8(y)
        del x
        for variant, b, k in CASES:
            q = q_all[:b].contiguous()
            topk.fused_score_topk(q, emb, k, nr, variant=variant)
            torch.cuda.synchronize()
            lib.sse_stream_phase(out)
            before = list(out)
            topk.fused_score_topk(q, emb, k, nr, variant=variant)
            torch.cuda.synchronize()
            lib.sse_stream_phase(out)
            got = [a - c for a, c in zip(out, before)]
            ctas = max(1, got[10])
            cyc = [got[i] / ctas for i in range(len(parts))]
            ended = "take the slow path" if wgmma else "end in a merge"
            print(f"streaming {variant} {dtype} B={b} k={k} "
                  f"({'wgmma' if wgmma else 'mma.sync'} kernel, {got[10]} CTAs): cycles a CTA, "
                  "thread 0: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(parts, cyc))
                  + f"; total {sum(cyc):.0f}; {got[8] / ctas:.1f} steps a CTA, "
                  f"{100.0 * got[9] / max(1, got[8]):.1f}% of steps {ended} "
                  f"[{card} max SM clock]", flush=True)
        del emb, q_all
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
