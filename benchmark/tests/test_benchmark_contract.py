"""BENCHMARK.json resolves, cell by cell, to its files by name, keeps the
contract's shape, and nothing the benchmark runs imports JAX or the JAX
package (compared on the whole top-level name: the port's name begins
with the JAX package's); the reference loads nothing of the port."""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SOURCES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & {"jax", "jaxlib", "flax", "sse_tpu"}, tops
    if os.sep + "reference" + os.sep in path:
        assert "sse_tpu_torch" not in tops


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.model, "
            "benchmark.reference.topk, benchmark.reference.train; "
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout))
    assert not tops & {"sse_tpu_torch", "sse_tpu", "jax", "jaxlib", "flax"}, tops


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.driver.Driver  # drivers/<kind>.py
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e, (m["name"], m["moves"])
    assert c.config["limits"][c.traffic["driver"]]


def test_one_passage_distribution_a_corpus():
    dists = {}
    for w in bench()["workloads"]:
        mx = harness.resolve(w["name"]).traffic
        if "passage_lengths" in mx:
            dists.setdefault(w["config"], []).append(mx["passage_lengths"])
    assert dists
    for config, got in dists.items():
        assert all(d == got[0] for d in got), config


def test_the_file_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for conf in b["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
        assert conf["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, conf["file"]))
        names.add(conf["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = b["end_to_end"] + b["per_layer"]
    all_names = [m["name"] for m in metrics] + [w["name"] for w in b["workloads"]] + list(names)
    assert len(all_names) == len(set(all_names))
    assert all(NAME.match(n) for n in all_names)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_the_command_refuses_to_run_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gru-query-bulk",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
