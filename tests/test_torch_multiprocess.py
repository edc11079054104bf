"""Two processes of the port joined over gloo (``sse_tpu_torch.parallel
.distributed``) on the CPU, each holding two entries of one (1, 4) grid:
the port of ``tests/test_multiprocess.py``'s serving and index-save
tests. The sharded fused query gives both ranks the single-process rows
(bit for bit: the same CPU kernels on the same rows), and an index saved
by the two processes, each writing its own row blocks, loads back equal
in one process. Each process runs under its own time limit."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_torch_mp_worker.py")
sys.path.insert(0, os.path.join(_REPO, "tests"))

import _torch_mp_worker as worker  # noqa: E402

LIMIT = 120  # seconds each process may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(*args) -> dict:
    """Start both workers, wait for each within LIMIT, return their RESULT
    lines by process id (killing both if either fails)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen([sys.executable, _WORKER, str(i), "2", coord, *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, cwd=_REPO)
        for i in range(2)
    ]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=LIMIT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
            r = json.loads(line[len("RESULT "):])
            results[r["pid"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def test_two_process_serving_matches_single_process():
    from sse_tpu_torch.index.sharded_index import from_embeddings
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    results = _run_pair("serve")
    r0, r1 = results[0], results[1]
    assert r0["backend"] == r1["backend"] == "gloo"  # no card: gloo, by the rule
    assert r0["rows"] == r1["rows"] and r0["vals"] == r1["vals"]
    assert r0["topk_ok"] and r1["topk_ok"]
    emb, ids, texts, cfg, params, tokens, lengths = worker.serve_problem()
    idx = from_embeddings(emb, ids, texts, device="cpu")
    vals, rows = build_fused_query_fn(cfg, k=5, num_real=idx.num_real)(
        params, idx.emb, tokens, lengths)
    assert r0["rows"] == rows.tolist()
    np.testing.assert_array_equal(np.asarray(r0["vals"], np.float32), vals.numpy())


def test_two_process_index_save_then_single_process_load(tmp_path):
    from sse_tpu_torch.index.sharded_index import ShardedIndex

    out_dir = str(tmp_path / "mpidx")
    results = _run_pair("indexsave", out_dir)
    assert results[0]["saved"] and results[1]["saved"]
    with open(os.path.join(out_dir, "sidecar.json")) as f:
        side = json.load(f)
    assert side["format"] == "npy-v1"
    assert [s["row0"] for s in side["shards"]] == [0, 16, 32, 48]  # one a grid column
    idx = ShardedIndex.load(out_dir, "cpu")
    emb, ids, texts = worker.saved_problem()
    assert idx.padded_size == 64 and idx.num_real == 50
    np.testing.assert_array_equal(idx.emb[:50].numpy(), emb)
    assert not idx.emb[50:].any()
    assert idx.ids == ids and idx.texts == texts
    grid = ShardedIndex.load(out_dir, worker.make_mesh(1, 2, devices=[worker.CPU] * 2))
    assert torch.equal(grid.emb[:], idx.emb) and grid.ids == ids
