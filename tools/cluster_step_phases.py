"""Where one step of the port's cluster recurrences spends its cycles, on a
CUDA card: the share of the exchange between the blocks and of the
cluster barrier.

    python3 tools/cluster_step_phases.py        # needs one CUDA card

Copies ``sse_tpu_torch`` into ``build/cluster_step_phases/`` and inserts
``clock64()`` counters between the phases of the step loop of
``rnn_scan_cluster_kernel`` (``csrc/rnn_scan.cu``) and of the cluster dh
loops (``gru_bwd_dh_cluster_kernel``, ``lstm_bwd_dh_cluster_kernel``:
their shared loop in ``csrc/dh_cluster.cuh``), builds that copy, runs
each at T=50, E=128, H=256 and 384, full lengths, B=8, 256 and 4096 (on
the tile each launch picks: blocks a cluster, rows a cluster, waves), and
prints the cycles a step of each phase as thread 0 of block 0 sees them,
with the card's maximum SM clock. A phase ends when
its last instruction issues, so a wait shows in the phase whose
instruction first uses the result; the barrier phase holds the wait for
the cluster's slowest block. The counters cost a few cycles each; the
times of the unmodified kernels are chip_smoke.py's (``--costs``,
``wide_costs``). The counters go in at fixed lines of the sources: when
those lines change, this script stops with the line it cannot find.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "cluster_step_phases")
sys.path.insert(0, os.path.join(ROOT, "tools"))

from gru_step_phases import COUNTER, DECL, READ, insert  # noqa: E402

SCAN_PHASES = ["products issue", "ax + stores", "cell", "publish + loads + exchange", "barrier"]
SCAN_MARKS = [
    ("// ---------------------------------------------------------------- clusters", "before",
     COUNTER.format(name="scan_phase")),
    ("  load(0);\n  float h[NJ][4] = {}, c[NJ][4] = {};\n", "after", DECL),
    ("    // ax_t into the sums\n", "before", "    PH(0)\n"),
    ("    // the cell, staged as in rnn_scan_kernel", "before", "    PH(1)\n"),
    ("    // masked carry; bf16(h_t) into this block's next h tile", "before", "    PH(2)\n"),
    ("    sse::cluster_sync();  // step t's h tile complete in every block\n", "before",
     "    PH(3)\n"),
    ("    sse::cluster_sync();  // step t's h tile complete in every block\n", "after",
     "    PH(4)\n"),
    ("  if (T > 0) {\n    store_own(", "before",
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 16; ++i) scan_phase[i] = ph[i];\n"),
    ('extern "C" int sse_rnn_scan_cluster_smem_bytes', "before", READ.format(name="scan_phase")),
]

DH_PHASES = ["cell backward", "tile free + publish + exchange + stores", "the tile's wait",
             "products issue", "next step, dh update"]
# the loop of both cells (dh_cluster.cuh): one counter array a source
DH_MARKS = [
    ("template <class Cell>\n__device__ __forceinline__ void cluster_loop(", "before",
     "namespace {\n" + COUNTER.format(name="dh_phase") + "}\n"),
    ("  int cur = 0;\n  for (int it = 0; it < T; ++it) {\n", "before", DECL),
    ("    if (one) cluster_wait();  // every block's reads of the tile done", "before",
     "    PH(0)\n"),
    ("    __syncthreads();  // the tile's columns of this block\n", "before", "    PH(1)\n"),
    ("  // ... and of the others\n", "after", "    PH(2)\n"),
    ("    // this thread's reads of the tile done (a release waits", "before",
     "    PH(3)\n"),
    ("    if (!one) cur ^= 1;  // the other dgates_b tile", "before", "    PH(4)\n"),
    ("  // the group's db partial: its row of db_part", "before",
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    for (int i = 0; i < 16; ++i) dh_phase[i] = ph[i];\n"),
]


def dh_read(cell: str):
    """The reading entry point of one source's copy of the counters."""
    return [(f'extern "C" int sse_{cell}_bwd_cluster_smem_bytes', "before",
             f'extern "C" int sse_{cell}_dh_phase(unsigned long long* out) '
             "{ return (int)cudaMemcpyFromSymbol(out, sse::dh::dh_phase, 128); }\n")]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("cluster_step_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "sse_tpu_torch"), os.path.join(WORK, "sse_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(WORK, "sse_tpu_torch", "csrc")
    insert(os.path.join(csrc, "rnn_scan.cu"), SCAN_MARKS)
    insert(os.path.join(csrc, "dh_cluster.cuh"), DH_MARKS)
    insert(os.path.join(csrc, "gru_bwd.cu"), dh_read("gru"))
    insert(os.path.join(csrc, "lstm_bwd.cu"), dh_read("lstm"))
    sys.path.insert(0, WORK)
    from sse_tpu_torch.ops import _build, rnn

    lib = _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, E = 50, 128
    out = (ctypes.c_ulonglong * 16)()

    def report(what: str, names) -> None:
        per = [out[k] / T for k in range(len(names))]
        total = sum(per)
        print(f"{what}: cycles a step: "
              + ", ".join(f"{n} {v:.0f} ({100.0 * v / total:.0f}%)" for n, v in zip(names, per))
              + f"; total {total:.0f} [{card} max SM clock]", flush=True)

    for cell, G in (("gru", 3), ("lstm", 4)):
        for H in (256, 384):
            plan = rnn.layer_plan(cell, E, H)
            wx = (torch.randn((E, G * H), generator=gen, device="cuda") * 0.06).bfloat16()
            wh = (torch.randn((H, G * H), generator=gen, device="cuda") * 0.06).bfloat16()
            b = torch.randn((G * H,), generator=gen, device="cuda") * 0.05
            for B in (8, 256, 4096):
                ax = torch.randn((T, B, G * H), generator=gen, device="cuda")
                mask = torch.ones((T, 1, B), device="cuda")
                for _ in range(3):
                    rnn.scan_layer(ax, mask, wh, cell)
                torch.cuda.synchronize()
                lib.sse_scan_phase(out)
                tile = rnn.card_scan_tile(ax.device, G, H, B, plan.scan_cluster)
                report(f"{cell} scan T={T} B={B} H={H} on {tile.C} blocks, {tile.R} rows a "
                       f"cluster, {tile.waves} waves of {tile.active}", SCAN_PHASES)
                xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
                ys, _, cs = rnn._scan_reference(rnn._x_product(xs, wx, b), mask, wh, cell)
                dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
                dfin = torch.randn((B, H), generator=gen, device="cuda")
                for _ in range(3):
                    rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell)
                torch.cuda.synchronize()
                getattr(lib, f"sse_{cell}_dh_phase")(out)
                tile = rnn.card_dh_tile(xs.device, G, H, B, plan.dh_cluster)
                report(f"{cell} dh loop T={T} B={B} H={H} on {tile.C} blocks, {tile.R} rows a "
                       f"cluster, {tile.waves} waves of {tile.active}", DH_PHASES)


if __name__ == "__main__":
    main()
