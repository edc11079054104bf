"""The port's host spans (``utils.profiling.span``) on the CPU.

- Off (no profiler, no ``record_spans()``): one shared no-op context, no
  profiler range opened, nothing recorded.
- Under a CPU ``torch.profiler.profile``: ``sse.``-prefixed ranges nested
  as opened, the outermost carrying the call's number; totals with the
  count, the duration and the self time (the duration less what the
  children cover).
- Many threads at once lose no update of the totals.
- Two threads keep separate stacks; a span closed by an exception still
  records.
- ``build_index`` records one ``index.build``, one ``index.stage`` and one
  ``index.encode`` a chunk, and one ``index.publish``; ``CapturedQuery``
  one ``engine.call`` a call, and on a replay (a stand-in capture here;
  the card's graph in the ``gpu`` test) ``engine.key``, ``engine.load``,
  ``engine.replay`` and ``engine.out`` once each.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sse_tpu_torch.data.corpus import TargetSpace
from sse_tpu_torch.index import sharded_index
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.models.towers import TowerConfig
from sse_tpu_torch.serve import engine
from sse_tpu_torch.utils import profiling
from sse_tpu_torch.utils.profiling import record_spans, reset_spans, span, span_totals

VOCAB, L = 300, 10
ENGINE_PARTS = ("sse.engine.key", "sse.engine.load", "sse.engine.replay", "sse.engine.out")


@pytest.fixture(autouse=True)
def fresh_totals():
    reset_spans()
    yield
    reset_spans()


def _model(mode: str = "dual-encoder", device: str = "cpu", width: int = 16):
    tower = TowerConfig(vocab_size=VOCAB, embed_dim=width, hidden=width, encoding_dim=width)
    cfg = SSEConfig(mode=NetworkMode(mode), src_tower=tower, tgt_tower=tower)
    return cfg, sse.init_params(cfg, torch.Generator().manual_seed(0), device=device)


def _tokens(rng, n: int):
    lens = rng.integers(1, L + 1, size=(n,)).astype(np.int32)
    toks = rng.integers(2, VOCAB, size=(n, L)).astype(np.int32)
    toks[np.arange(L)[None, :] >= lens[:, None]] = 0
    return toks, lens


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_record_function_with_args_enter",
                        lambda *a: opened.append(a))
    assert span("a") is span("b")  # one shared no-op context
    with span("a"):
        with span("b"):
            pass
    assert opened == [] and span_totals() == {}


def test_ranges_nest_under_the_profiler_and_totals_add_up(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        with span("outer"):
            for pause in (0.002, 0.001):
                with span("inner"):
                    time.sleep(pause)
            time.sleep(0.001)
    events = [e for e in prof.events() if e.name.startswith("sse.")]
    assert sorted(e.name for e in events) == ["sse.inner", "sse.inner", "sse.outer"]
    outer = next(e for e in events if e.name == "sse.outer")
    for e in events:
        if e.name == "sse.inner":
            assert e.cpu_parent is not None and e.cpu_parent.name == "sse.outer"
            assert outer.time_range.start <= e.time_range.start
            assert e.time_range.end <= outer.time_range.end
    got = span_totals()
    (n, total, own), (n_in, total_in, own_in) = got["sse.outer"], got["sse.inner"]
    assert n == 1 and n_in == 2
    assert own_in == total_in >= 0.003
    assert 0.001 <= own <= total - total_in  # the children's bookkeeping left out too
    # the outermost range carries the call's number; its children carry none
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    args = {ev["name"]: ev["args"] for ev in json.loads(path.read_text())["traceEvents"]
            if ev.get("name", "").startswith("sse.")}
    assert args["sse.outer"]["Concrete Inputs"][0].isdigit()
    assert "Concrete Inputs" not in args["sse.inner"]


def test_threads_keep_their_own_stacks():
    both = threading.Barrier(2)

    def first():
        with span("a"):
            both.wait()  # the other thread opens and closes its spans meanwhile
            both.wait()

    def second():
        both.wait()
        with span("b"):
            with span("b.in"):
                pass
        both.wait()

    with record_spans():
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    got = span_totals()
    assert got["sse.a"][2] == got["sse.a"][1]  # no child of another thread's
    assert 0 <= got["sse.b"][2] <= got["sse.b"][1] - got["sse.b.in"][1]
    assert {k: v[0] for k, v in got.items()} == {"sse.a": 1, "sse.b": 1, "sse.b.in": 1}


def test_totals_lose_no_update_across_threads():
    """More threads than cores, switching as often as the interpreter
    allows: every span of every thread is counted once, with its child."""
    threads, each = (os.cpu_count() or 4) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with span("stress"):
                    with span("stress.in"):
                        pass

        with record_spans():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    got = span_totals()
    assert got["sse.stress"][0] == got["sse.stress.in"][0] == threads * each
    assert 0 <= got["sse.stress"][2] <= got["sse.stress"][1] - got["sse.stress.in"][1]


def test_a_span_closed_by_an_exception_records():
    with record_spans():
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("raised inside")
        with span("after"):
            pass
    got = span_totals()
    assert {k: v[0] for k, v in got.items()} == {"sse.outer": 1, "sse.inner": 1, "sse.after": 1}
    assert got["sse.after"][2] == got["sse.after"][1]  # the stack emptied: no stale parent
    assert profiling._local.stack == []


def test_build_index_spans_each_chunk():
    cfg, params = _model()
    t = 40
    toks, lens = _tokens(np.random.default_rng(1), t)
    ids = [f"t{i}" for i in range(t)]
    tspace = TargetSpace(ids=ids, texts=ids, tokens=toks, lengths=lens,
                         id_to_row={x: i for i, x in enumerate(ids)})
    sharded_index.build_index(params, cfg, tspace, batch_size=8, chunk_batches=2)
    assert span_totals() == {}  # tracing off
    with record_spans():
        index = sharded_index.build_index(params, cfg, tspace, batch_size=8, chunk_batches=2)
    assert index.num_real == t
    got = span_totals()
    chunks = 3  # 16 documents a chunk
    counts = {k: v[0] for k, v in got.items() if k.startswith("sse.index.")}
    assert counts == {"sse.index.build": 1, "sse.index.stage": chunks,
                      "sse.index.encode": chunks, "sse.index.publish": 1}
    children = sum(got[k][1] for k in ("sse.index.stage", "sse.index.encode",
                                       "sse.index.publish"))
    build = got["sse.index.build"]
    assert 0 <= build[2] <= build[1] - children


class _Captured:
    """A stand-in for ``graphs.Captured`` (no card here): the warm-up runs
    ``run`` once, and each replay runs it again on the same buffers."""

    def __init__(self, run, dev, pool, side, pack=None):
        self.run, self.pack = run, pack or (lambda out: out)
        self.first = run()
        self.seconds, self.mib = 0.25, 1.5

    def take_first(self):
        out, self.first = self.first, None
        return out

    def replay(self):
        return self.pack(self.run())


def test_captured_query_spans(monkeypatch):
    cfg, params = _model("shared-encoder")
    rng = np.random.default_rng(2)
    emb = torch.nn.functional.normalize(torch.randn(64, 16), dim=1)
    toks, lens = map(torch.from_numpy, _tokens(rng, 4))
    fused = engine.build_fused_query_fn(cfg, k=5, num_real=40)
    with record_spans():
        for _ in range(3):  # CPU tensors: the eager path, no graph
            fused(params, emb, toks, lens)
    got = span_totals()
    assert got["sse.engine.call"][0] == 3 and not set(ENGINE_PARTS) & set(got)

    reset_spans()
    pools = iter(range(100))
    monkeypatch.setattr(engine, "Captured", _Captured)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(pools))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "side")
    first = fused.replay(params, emb, toks, lens, 40, adopt=False)  # the capture
    with record_spans():
        again = fused.replay(params, emb, toks, lens, 40, adopt=False)
    assert torch.equal(first[1], again[1])
    got = span_totals()
    assert {k: got[k][0] for k in got if k.startswith("sse.engine.")} == dict.fromkeys(
        ENGINE_PARTS, 1)
    assert fused.stats.counts() == {"graph_captures": 1, "graph_replays": 1, "graph_eager": 0}


@pytest.mark.gpu
def test_replayed_engine_call_records_each_part_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    cfg, params = _model("shared-encoder", "cuda", width=128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.nn.functional.normalize(torch.randn((4096, 128), generator=gen, device="cuda"),
                                        dim=1).to(torch.bfloat16)
    toks, lens = (torch.from_numpy(x).cuda() for x in _tokens(np.random.default_rng(3), 8))
    fused = engine.build_fused_query_fn(cfg, k=10, num_real=4000)
    fused(params, emb, toks, lens)  # the capture
    with record_spans():
        got_rows = fused(params, emb, toks, lens)[1]
    torch.cuda.synchronize()
    got = span_totals()
    assert {k: got[k][0] for k in got if k.startswith("sse.engine.")} == {
        "sse.engine.call": 1, **dict.fromkeys(ENGINE_PARTS, 1)}
    parts = sum(got[k][1] for k in ENGINE_PARTS)
    assert 0 <= got["sse.engine.call"][2] <= got["sse.engine.call"][1] - parts
    assert torch.equal(got_rows, fused.run(params, emb, toks, lens, 4000)[1])
    assert fused.stats.counts() == {"graph_captures": 1, "graph_replays": 1, "graph_eager": 0}
