"""A grid across processes over NCCL, a card a rank (marker ``gpu``; skips
where torch sees fewer than two cards, as NCCL takes a card a rank). Run
on the card with ``python -m pytest --noconftest
tests/test_torch_gpu_processes.py``.

Two ranks (``tests/_torch_mp_worker.py``), each under its own time limit:

- ``make_train_step(mesh=, chain=4)`` on a (2, 1) grid captures the
  chain, collectives inside, one graph a rank; a replay equals the eager
  chain of the same grid from the same state bit for bit, as does a
  second replay carrying the state the first returned (where two eager
  runs are bit for bit), both under ``torch.cuda.set_sync_debug_mode
  ("error")``, with the same state on both ranks;
- a (1, 2) ``GridQuery`` captures its body with the exchange and the
  merge inside: the capturing call, a replay under sync debug and the
  eager call give the same rows and values, equal to the one-process
  unsharded call's;
- a capture made to fail on rank 1 (a host read inside it) raises on
  both ranks, and neither hangs.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes a card a rank")
    from sse_tpu_torch.ops import _build

    _build.library()  # built once here: the ranks load it and race no nvcc
    from test_torch_multiprocess import _run_pair

    return _run_pair


def test_chain_across_processes_replays_as_eager(pair):
    r0, r1 = pair("gpu_chain").values()
    for r in (r0, r1):
        assert r["captures"] and r["captured"]
        assert r["graphs"] == 1 and r["copies"] == 0  # the rank's grid row lies on its card
        assert r["collectives"].get("all_gather") and r["collectives"].get("all_reduce")
        assert r["finite"]
    assert r0["collectives"] == r1["collectives"]
    assert r0["replay"] == r1["replay"] and r0["replay_carried"] == r1["replay_carried"]
    assert r0["eager_repeats"], "two eager runs of the grid differ: no bit-for-bit check"
    assert r0["replay"] == r0["eager"] and r0["replay_carried"] == r0["eager_carried"]


def test_grid_query_across_processes_replays_as_eager(pair):
    from sse_tpu_torch import bench
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    r0, r1 = pair("gpu_query").values()
    cfg = bench._default_model()
    params = sse.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rows = 16384
    emb = bench._device_index(rows, 128, torch.bfloat16, "cuda", shards=2)
    fn = build_fused_query_fn(cfg, 10, rows - 100)
    for r in (r0, r1):
        assert r["exchange"]
        assert r["counts"] == {"graph_captures": 2, "graph_replays": 2, "graph_eager": 0}
    for b in (8, 64):
        gen = torch.Generator(device="cuda").manual_seed(b)
        toks = bench._random_tokens(gen, (b, 20), 8000, "cuda")
        lens = torch.randint(1, 21, (b,), generator=gen, device="cuda", dtype=torch.int32)
        vals, got = fn(params, emb[:rows], toks, lens)
        want = [vals.tolist(), got.tolist()]
        for r in (r0, r1):
            calls = r["calls"][str(b)]
            assert calls["replay"] == calls["eager"] == calls["first"] == want, b


def test_capture_failing_on_one_rank_raises_on_both(pair):
    r0, r1 = pair("gpu_fail").values()
    assert r0["error"] is not None and "failed on rank(s) [1]" in r0["error"]
    assert r1["error"] is not None and "capture" in r1["error"].lower()
