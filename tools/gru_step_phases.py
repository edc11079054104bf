"""Where one step of the port's GRU recurrences spends its cycles, on a
CUDA card.

    python3 tools/gru_step_phases.py        # needs one CUDA card

Copies ``sse_tpu_torch`` into ``build/gru_step_phases/`` and inserts
``clock64()`` counters between the phases of the step loop of
``csrc/gru_fwd.cu`` (the layer forward) and of the dh loop in
``csrc/gru_bwd.cu``, builds that copy, runs each at T=50, E=H=128, full
lengths, and prints the cycles per step of each phase as thread 0 of
block 0 sees them, with the card's maximum SM clock. A phase ends when
its last instruction issues, so a wait shows in the phase whose
instruction first uses the result. The counters cost a few cycles each
and a register or two; the times of the unmodified kernels are
chip_smoke.py's. The counters go in at fixed lines of the sources: when
those lines change, this script stops with the line it cannot find.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "gru_step_phases")

COUNTER = """#ifndef PH
__device__ unsigned long long {name}[16];
#define PH(i) {{ const unsigned long long now = clock64(); ph[i] += now - last; last = now; }}
#endif
"""
DECL = "  unsigned long long ph[16] = {}, last = clock64();\n"
READ = ('extern "C" int sse_{name}(unsigned long long* out) '
        '{{ return (int)cudaMemcpyFromSymbol(out, {name}, 128); }}\n')

FWD_PHASES = ["barrier + next", "h-part", "copies + ys", "exp + div + x-part", "tanh",
              "carry + publish", "bias + wait"]
FWD_MARKS = [
    ("// KE, KH: E and H at compile time", "before", COUNTER.format(name="fwd_phase")),
    ("  int cur = 0;\n  for (int t = 0; t < T; ++t) {\n", "before", DECL),
    ("  int cur = 0;\n  for (int t = 0; t < T; ++t) {\n", "after", "    PH(0)\n"),
    ("    // while it runs: step t+3's inputs", "before", "    PH(1)\n"),
    ("    // The cell. Each IEEE division", "before", "    PH(2)\n"),
    ("    for (int kk = 128; kk < E; kk += 16) x_slice", "before", "    PH(3)\n"),
    ("    // masked carry, then publish", "before", "    PH(4)\n"),
    ("    add_bias(nxt);\n", "before", "    PH(5)\n"),
    ("    if constexpr (FIXED) sse::cp_async_wait<1>();  // step t+2's inputs\n", "after",
     "    PH(6)\n"),
    ("  if (T > 0) store_ys(T - 1,", "before",
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    for (int k = 0; k < 16; ++k) fwd_phase[k] = ph[k] + (h[0][0] == 12345.f);\n"),
    ("// Shared memory one block needs, at most", "before", READ.format(name="fwd_phase")),
]

BWD_PHASES = ["loop top", "derivatives + dgates_b", "barrier", "product issue",
              "copies + dgates_b stores", "next step's nonlinearities", "dh update"]
BWD_MARKS = [
    ("// The serial reverse loop, transposed", "before", COUNTER.format(name="bwd_phase")),
    ("  int cur = 0;\n  for (int i = 0; i < T; ++i) {\n", "before", DECL),
    ("  int cur = 0;\n  for (int i = 0; i < T; ++i) {\n", "after", "    PH(0)\n"),
    ("    __syncthreads();  // every warp's dgates_b of step t\n", "before", "    PH(1)\n"),
    ("    __syncthreads();  // every warp's dgates_b of step t\n", "after", "    PH(2)\n"),
    ("    // while the products run", "before", "    PH(3)\n"),
    ("    if (i + 1 < T) prepare(i + 1);\n", "before", "    PH(4)\n"),
    ("    if (i + 1 < T) prepare(i + 1);\n", "after", "    PH(5)\n"),
    ("    cur ^= 1;\n  }\n", "before", "    PH(6)\n"),
    ("  // db partial of this block", "before",
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    for (int k = 0; k < 16; ++k) bwd_phase[k] = ph[k] + (dh[0] == 12345.f);\n"),
    ('extern "C" int sse_gru_bwd_smem_bytes(int H)', "before", READ.format(name="bwd_phase")),
]


def insert(path: str, marks) -> None:
    src = open(path).read()
    for anchor, where, text in marks:
        if src.count(anchor) != 1:
            raise SystemExit(f"{path}: cannot place a counter at {anchor!r}")
        src = src.replace(anchor, text + anchor if where == "before" else anchor + text)
    open(path, "w").write(src)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("gru_step_phases: no CUDA device", file=sys.stderr)
        sys.exit(2)
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "sse_tpu_torch"), os.path.join(WORK, "sse_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    insert(os.path.join(WORK, "sse_tpu_torch", "csrc", "gru_fwd.cu"), FWD_MARKS)
    insert(os.path.join(WORK, "sse_tpu_torch", "csrc", "gru_bwd.cu"), BWD_MARKS)
    sys.path.insert(0, WORK)
    from sse_tpu_torch.ops import _build, rnn

    lib = _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, E, H = 50, 128, 128
    wx = (torch.randn((E, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((3 * H,), generator=gen, device="cuda") * 0.05
    out = (ctypes.c_ulonglong * 16)()

    def report(what: str, names) -> None:
        per = [out[k] / T for k in range(len(names))]
        print(f"{what}: cycles a step: " + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, per))
              + f"; total {sum(per):.0f} [{card} max SM clock]", flush=True)

    for B in (8, 384, 4096):
        xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
        mask = torch.ones((T, 1, B), device="cuda")
        for _ in range(3):
            ys, _ = rnn.rnn_layer(xs, mask, wx, wh, b)
        torch.cuda.synchronize()
        lib.sse_fwd_phase(out)
        report(f"gru_fwd T={T} B={B} E=H={H}", FWD_PHASES)
        if B == 384:
            dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
            dfin = torch.randn((B, H), generator=gen, device="cuda")
            for _ in range(3):
                rnn.gru_bwd_launch(xs, ys, mask, wx, wh, b, dys, dfin)
            torch.cuda.synchronize()
            lib.sse_bwd_phase(out)
            report(f"gru_bwd dh loop T={T} B={B} H={H}", BWD_PHASES)


if __name__ == "__main__":
    main()
