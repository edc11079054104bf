"""Run one cell of the benchmark of ``sse_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the
cell asks for. The last line of standard output is the result, one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``;
with ``--trace 1`` also ``breakdown``; last, ``checks``: each number the
comparison with the plain reference read, beside its limit). The same
numbers close standard error. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics: device numbers from a traced
window, host times and counters from an untraced one before it.

The run exits non-zero and prints no result where torch sees no CUDA
card or fewer than the cell asks for, or where JAX or the JAX package
was loaded in this process. Build and kernel caches stay inside the
checkout (``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every compile and kernel cache a run may write, inside the checkout
    at fixed paths (the port's own library builds into build/sse_tpu_torch)."""
    build = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv_cache")):
        os.environ[var] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from benchmark import harness

    age = harness.process_age()
    started = t0 if age is None else time.perf_counter() - age
    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell {cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell.name, args.seed, args.seconds, bool(args.trace), "cuda",
                              started=started)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules that no run may load are loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
