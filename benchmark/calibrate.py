"""The readings that the limits of ``correct`` are set from, for one cell
at its own size, in one process: the program's checks on ``--seeds``
seeds, the control's (the reference one precision lower, in the
program's place) on ``--controls`` seeds and, on ``--witnesses`` seeds,
the reference at the configuration's own precision in the program's
place (a second witness of what a sound run reads), and on
``--fault-seeds`` seeds each ``--fault`` (``benchmark/faults.py``)
planted under the program, each after a short window at the cell's load.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3

prints one JSON line a run and, last, each check's readings by kind.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--witnesses", type=int, default=0)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.run import _caches

    _caches()
    import torch

    from benchmark import harness
    from benchmark.faults import FAULTS

    runs = [("program", args.first_seed + i) for i in range(args.seeds)]
    runs += [("control", args.first_seed + 1000 + i) for i in range(args.controls)]
    runs += [("witness", args.first_seed + i) for i in range(args.witnesses)]
    runs += [(f"fault:{f}", args.first_seed + 2000 + i) for f in args.fault
             for i in range(args.fault_seeds)]
    faults = FAULTS[harness.resolve(args.workload).traffic["driver"]]
    got = {mode: {} for mode, _ in runs}
    for mode, seed in runs:
        fault = faults[mode[6:]] if mode.startswith("fault:") else contextlib.nullcontext
        with fault():
            out = harness.run_cell(args.workload, seed, args.seconds, False, "cuda",
                                   mode="program" if mode.startswith("fault:") else mode)
        print(json.dumps({"mode": mode, "seed": seed, "correct": out["correct"],
                          "metrics": out["metrics"], "checks": out["checks"]}), flush=True)
        for name, c in out["checks"].items():
            got[mode].setdefault(name, []).append(c["value"])
        gc.collect()
        torch.cuda.empty_cache()
    summary = {name: {mode: got[mode].get(name, []) for mode in got}
               for name in got[runs[0][0]]}
    print(json.dumps({"summary": args.workload, "checks": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
