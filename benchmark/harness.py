"""One run of one cell: set-up, the measured window (traced or not), the
metrics, and the comparison with the plain reference that decides
``correct``.

Everything is found by name. ``BENCHMARK.json`` names a cell's
configuration and traffic mix; the configuration is the file
``BENCHMARK.json`` gives it (``configs/<config>.json``), the mix
``traffic/<mix>.json`` (whose
``driver`` names the module under ``drivers/`` that serves that kind of
traffic), and each per-layer metric ``metrics/<metric>.py``, a reader
with ``read(run) -> float | None``. So a later cell, mix or metric is
added as files and entries only.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "sse_tpu")


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` resolved to its files."""

    name: str
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int

    @property
    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: Optional[Dict] = None, overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and metrics;
    ``overrides`` ({"config": ..., "traffic": ...}) are merged over the
    files (the tests' small sizes)."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json"), encoding="utf-8") as f:
        traffic = json.load(f)
    overrides = overrides or {}
    return Cell(name, _merge(config, overrides.get("config")),
                _merge(traffic, overrides.get("traffic")),
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)], w["chips"])


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def process_age() -> Optional[float]:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What the metric readers read of one run: the cell, the driver (its
    record of the window's work), the trace (traced runs), the card, and
    in a traced run whose mix gives ``untraced_seconds`` the record of an
    untraced window run just before the traced one (``untraced``), where
    host clocks and the program's counters read without the profiler."""

    def __init__(self, cell: Cell, driver, trace, kind: str,
                 untraced: Optional[Dict[str, Any]] = None) -> None:
        self.cell, self.driver, self.trace, self.kind = cell, driver, trace, kind
        self.untraced = untraced

    @property
    def record(self) -> Dict[str, Any]:
        return self.driver.record


def _number(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None, started: Optional[float] = None,
             mode: str = "program") -> Dict:
    """One run: the result line as a dict. ``mode="control"`` judges the
    configuration's control (the reference at the next lower precision)
    in the program's place instead of the program's own output;
    ``mode="witness"`` the reference at the configuration's own precision.
    ``started``: the ``time.perf_counter()`` reading at process start,
    where ``setup_s`` begins (else this call)."""
    import torch

    t_start = time.perf_counter() if started is None else started
    cell = resolve(name, overrides=overrides)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    from benchmark import trace as trace_mod

    driver = cell.driver.Driver(cell, seed, dev, trace_mod.span(trace))
    before = time.perf_counter() - t_start
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"setup_s {setup_s:.3f}: start to set-up {before:.3f}; " + "; ".join(
        f"{k} {v:.3f}" for k, v in driver.phases.parts.items()), file=sys.stderr, flush=True)
    got = untraced = None
    attempted = failed = 0
    if trace:
        ahead = cell.traffic.get("untraced_seconds", 0)
        if ahead:  # host times and counters, read where no profiler slows the host
            driver.span = trace_mod.span(False)
            driver.window(ahead)
            untraced, attempted, failed = driver.record, driver.attempted, driver.failed
            driver.span = trace_mod.span(True)
        got = _traced(driver, min(seconds, cell.traffic.get("trace_seconds", seconds)), on_card)
    else:
        driver.window(seconds)
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run = Run(cell, driver, got, kind, untraced)
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**driver.end_to_end(), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    attempted, failed = attempted + driver.attempted, failed + driver.failed
    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    from benchmark.reference import model as ref

    stand_in = {"program": None, "control": ref.fp8, "witness": ref.bf16}[mode]
    checks = driver.check(stand_in and stand_in())
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    for key, c in checks.items():
        c["value"] = _number(c["value"])
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = got.busy_s
        device["window_s"] = got.window_s
        out["breakdown"] = {"device_ops": got.device_ops(), "idle_gaps": got.idle_gaps()}
    out["checks"] = checks
    return out


def _traced(driver, seconds: float, on_card: bool):
    """The window under torch.profiler, profiled again (up to three
    times) where the trace lost launches that the program counted."""
    import torch
    from benchmark.trace import WINDOW, Trace
    from sse_tpu_torch import ops

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    for attempt in range(1, 4):
        ops.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                driver.window(seconds)
        launched = ops.launch_counts()
        got = Trace.from_profile(prof)
        lost = got.lost(launched) if on_card else {}
        print(f"trace {attempt}: {len(got.device)} device operations, launches counted "
              f"{ {k: v for k, v in launched.items() if v} }", file=sys.stderr, flush=True)
        if not lost:
            return got
        print(f"trace {attempt} lost kernel records (seen, launched): {lost}", file=sys.stderr,
              flush=True)
    raise RuntimeError("torch.profiler lost kernel records in three traced windows: "
                       "no per-layer metric is read from a trace that lost work")
