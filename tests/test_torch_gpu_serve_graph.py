"""The served query path as CUDA graphs on a card (marker ``gpu``; skips
where torch sees no card): ``build_fused_query_fn`` on one card captures
each input shape once and replays it, and ``QueryEngine.warmup`` captures
every (batch tier, length bucket).

- A replay equals the eager call (``fused.run``, the same kernels issued
  one by one) bit for bit, rows and values: every length bucket, packed
  and exact, bf16, int8 and float32, B=8, 256 and 4096 (streaming, and
  the two-phase route for packed B=4096); the LSTM (``compositional``),
  transformer and bag-of-subwords towers too.
- ``num_real`` as a device operand: the wrappers given a 0-d int32 tensor
  and one captured graph replayed at num_real 0, 5, 127-129, 2047-2049,
  4095-4097 equal the plain versions on exact-dot inputs (bit for bit).
- An add between replays shows the new rows with no new capture; a
  delete recaptures and then matches the eager call on the new snapshot;
  a returned result is not overwritten by the next call.
- A capture while another thread serves, replays and a capture under
  ``torch.cuda.set_sync_debug_mode("error")``, and a capture that fails
  raises (nothing cached, no eager fallback).
Run on the card with ``python -m pytest --noconftest
tests/test_torch_gpu_serve_graph.py``."""

import threading

import pytest
import torch

pytestmark = pytest.mark.gpu

T = 2048 * 16  # two-phase blocks: k=10 needs at least 10
WIDTHS = (8, 16, 32, 50)  # QueryEngine's buckets at max_seq_length 50
EDGES = (0, 5, 127, 128, 129, 2047, 2048, 2049, 4095, 4096, 4097)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


def _config(cell: str = "gru"):
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig

    width = dict(vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128)
    if cell == "lstm":  # the compositional recipe's source tower
        tower = TowerConfig(cell="lstm", num_layers=3, residual=True, **width)
    elif cell == "transformer":
        tower = TowerConfig(cell="transformer", num_layers=4, readout="mean", **width)
    elif cell == "bow":  # the bag-of-subwords tower with the attention readout
        tower = TowerConfig(cell="bow", readout="attention", **width)
    else:
        tower = TowerConfig(cell="gru", **width)
    return SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=tower)


def _model(cell: str = "gru"):
    from sse_tpu_torch.models import sse

    cfg = _config(cell)
    return cfg, sse.init_params(cfg, torch.Generator().manual_seed(0), "cuda")


def _index(gen, dtype: str, t: int = T):
    from sse_tpu_torch.index.sharded_index import quantize_rows

    x = torch.randn((t, 128), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    return quantize_rows(x, {"bf16": torch.bfloat16, "int8": torch.int8,
                             "f32": torch.float32}[dtype])


def _tokens(gen, b: int, w: int):
    toks = torch.randint(2, 8000, (b, w), generator=gen, device="cuda", dtype=torch.int32)
    lens = torch.randint(1, w + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    return toks, lens


def _same(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b", [8, 256, 4096])
@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
def test_replay_equals_eager_every_bucket(cuda, dtype, variant, b):
    from sse_tpu_torch import ops
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg, params = _model()
    emb = _index(cuda, dtype)
    fused = build_fused_query_fn(cfg, 10, T - 1000, variant)
    for w in WIDTHS:
        toks, lens = _tokens(cuda, b, w)
        want = fused.run(params, emb, toks, lens, T - 1000)
        fused(params, emb, toks, lens)  # capture
        toks2, lens2 = _tokens(cuda, b, w)
        want2 = fused.run(params, emb, toks2, lens2, T - 1000)
        ops.reset_launch_counts()
        got2 = fused(params, emb, toks2, lens2)
        replayed = ops.launch_counts()
        got = fused(params, emb, toks, lens)
        assert _same(got, want) and _same(got2, want2), (w, b)
        route = "twophase_p1" if (variant == "packed" and b >= 1024) else (
            "topk_exact" if variant == "exact" else "topk_stream")
        assert replayed[route] == 1 and replayed["gru_fwd"] == 1, replayed
    assert fused.stats.counts() == {"graph_captures": 4, "graph_replays": 8, "graph_eager": 0}


@pytest.mark.parametrize("b", [8, 4096])
@pytest.mark.parametrize("cell", ["lstm", "transformer", "bow"])
def test_replay_equals_eager_other_towers(cuda, cell, b):
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg, params = _model(cell)
    emb = _index(cuda, "bf16")
    fused = build_fused_query_fn(cfg, 10, T)
    toks, lens = _tokens(cuda, b, 50)
    fused(params, emb, toks, lens)
    toks, lens = _tokens(cuda, b, 50)
    assert _same(fused(params, emb, toks, lens), fused.run(params, emb, toks, lens, T))


def _exact_dot(gen, dtype: str, b: int):
    """Queries and rows whose products are exact in float32 (multiples of
    1/16 in [-1, 1]), so the kernels and the plain versions agree bit for
    bit; int8: small integers."""
    if dtype == "int8":
        q = torch.randint(-8, 9, (b, 128), generator=gen, device="cuda").to(torch.int8)
        e = torch.randint(-8, 9, (T, 128), generator=gen, device="cuda").to(torch.int8)
        return q, e
    q = (torch.randint(-16, 17, (b, 128), generator=gen, device="cuda") / 16).bfloat16()
    e = (torch.randint(-16, 17, (T, 128), generator=gen, device="cuda") / 16).bfloat16()
    return q, e


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_num_real_edges_through_the_device_operand(cuda, dtype):
    from sse_tpu_torch.ops import topk

    q8, emb = _exact_dot(cuda, dtype, 8)
    q4k, _ = _exact_dot(cuda, dtype, 4096)
    for nr in EDGES:
        dev_nr = torch.full((), nr, dtype=torch.int32, device="cuda")
        for variant in ("packed", "exact"):
            want = topk.topk_reference(q8, emb, 10, nr, variant)
            assert _same(topk.fused_score_topk(q8, emb, 10, dev_nr, variant), want), (nr, variant)
        want = topk.topk_reference(q4k, emb, 10, nr)
        assert _same(topk.fused_score_topk_twophase(q4k, emb, 10, dev_nr), want), nr


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_one_graph_serves_every_num_real(cuda, dtype):
    """One captured call (two-phase at B=4096, streaming at B=8), replayed
    at each edge: the graph reads num_real from its buffer."""
    from sse_tpu_torch.ops import topk
    from sse_tpu_torch.serve.engine import CapturedQuery

    for b in (8, 4096):
        q, emb = _exact_dot(cuda, dtype, b)

        def run(params, emb, tokens, lengths, nr):  # the top-k of fixed queries
            if tokens.shape[0] >= topk.TWOPHASE_MIN_BATCH:
                return topk.fused_score_topk_twophase(q, emb, 10, nr)
            return topk.fused_score_topk(q, emb, 10, nr)

        fn = CapturedQuery(run, None)
        toks = torch.zeros((b, 8), dtype=torch.int32, device="cuda")
        lens = torch.ones((b,), dtype=torch.int32, device="cuda")
        for nr in EDGES:
            want = topk.topk_reference(q, emb, 10, nr)
            assert _same(fn({}, emb, toks, lens, nr), want), (b, nr)
        assert fn.stats.counts()["graph_captures"] == 1


def _engine(gen, n: int = 5000, capacity: int = 8192):
    from sse_tpu_torch.index import sharded_index
    from sse_tpu_torch.serve import QueryEngine
    from sse_tpu_torch.text.subword import SubwordVocab

    cfg, params = _model()
    vocab = SubwordVocab.build_from_token_counts({f"w{i}": 10 for i in range(300)}, 2, 4)
    rows = torch.randn((n, 128), generator=gen, device="cuda")
    rows = rows / rows.norm(dim=1, keepdim=True)  # the index holds unit rows
    index = sharded_index.from_embeddings(rows, [f"d{i}" for i in range(n)],
                                          [f"doc {i}" for i in range(n)], capacity=capacity,
                                          dtype=torch.bfloat16, device="cuda")
    return QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=10,
                       bulk_batch=256)


def test_engine_warmup_add_delete(cuda):
    eng = _engine(cuda)
    eng.warmup()
    counts = eng.graph_counts()
    assert counts["graph_captures"] == 8 == counts["graphs_cached"]
    texts = ["w1 w2 w3", "w4 w5"]
    first = eng.query(texts)
    # an add with k unchanged: no capture, and the new document ranks first
    eng.add_documents(["new"], ["w7 w8 w9 w10"])
    assert eng.graph_counts()["graph_captures"] == 8
    assert eng.query(["w7 w8 w9 w10"])[0][0]["targetId"] == "new"
    # a delete copies the buffer: its graphs are captured before it returns
    eng.delete_documents(["new", "d0", "d1"])
    after = eng.graph_counts()
    assert after["graph_captures"] == 16 and after["graphs_cached"] == 8
    tokens, lengths = eng.encode_queries(texts)
    emb, nr = eng.index.pub[:2]
    want = eng._fused.run(eng.params, emb, tokens, lengths, nr)
    assert _same(eng._fused(eng.params, emb, tokens, lengths, nr), want)
    assert eng.graph_counts()["graph_captures"] == 16
    ids = {h["targetId"] for hits in eng.query(texts) for h in hits}
    assert not ids & {"new", "d0", "d1"} and len(first) == 2


def test_k_growth_captures_before_publishing(cuda):
    """An index of 5 rows serves k=5; adding 10 documents raises k to 10,
    and the wider function's 8 graphs are captured before it is
    published."""
    eng = _engine(cuda, n=5)
    eng.warmup()
    old = eng._fused
    assert eng.k == 5 and eng.graph_counts()["graph_captures"] == 8
    eng.add_documents([f"n{i}" for i in range(10)], [f"w{i} w{i + 1}" for i in range(10)])
    assert eng.k == 10 and eng._fused is not old
    assert eng.graph_counts() == {"graph_captures": 16, "graph_replays": 0, "graph_eager": 0,
                                  "graphs_cached": 8}
    assert len(eng.query(["w3 w4"])[0]) == 10
    assert eng.graph_counts()["graph_captures"] == 16 == eng.graph_counts()["graph_replays"] + 15


def test_returned_tensors_survive_the_next_call(cuda):
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg, params = _model()
    emb = _index(cuda, "bf16")
    fused = build_fused_query_fn(cfg, 10, T)
    toks, lens = _tokens(cuda, 8, 16)
    a = fused(params, emb, toks, lens)
    keep = (a[0].clone(), a[1].clone())
    toks2, lens2 = _tokens(cuda, 8, 16)
    b = fused(params, emb, toks2, lens2)
    assert _same(a, keep) and not torch.equal(a[1], b[1])


def test_capture_while_another_thread_serves(cuda):
    eng = _engine(cuda)
    eng.warmup()
    want = eng.query(["w1 w2"])
    errors, stop = [], threading.Event()

    def serve():
        try:
            while not stop.is_set():
                assert eng.query(["w1 w2"]) == want
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    t = threading.Thread(target=serve)
    t.start()
    try:
        other = _engine(torch.Generator(device="cuda").manual_seed(0))  # the same rows
        other.warmup()  # eight captures while the first engine serves
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert other.graph_counts()["graph_captures"] == 8
    assert other.query(["w1 w2"]) == want


def test_replays_and_capture_sync_nothing(cuda):
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg, params = _model()
    emb = _index(cuda, "bf16")
    fused = build_fused_query_fn(cfg, 10, T)
    fused.run(params, emb, *_tokens(cuda, 4096, 8), T)  # build the kernels
    torch.cuda.synchronize()
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in (8, 4096):
            toks, lens = _tokens(cuda, b, 8)
            got.append((fused(params, emb, toks, lens), toks, lens))  # capture
            got.append((fused(params, emb, toks, lens, T - 7), toks, lens))  # replay
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i, (out, toks, lens) in enumerate(got):
        want = fused.run(params, emb, toks, lens, T if i % 2 == 0 else T - 7)
        assert _same(out, want)


def test_failed_capture_raises(cuda, monkeypatch):
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg, params = _model()
    emb = _index(cuda, "bf16")
    real = sse.encode_source

    def syncing(*args, **kw):
        q = real(*args, **kw)
        float(q.sum())  # a host read: no CUDA graph can hold it
        return q

    monkeypatch.setattr(sse, "encode_source", syncing)
    fused = build_fused_query_fn(cfg, 10, T)
    toks, lens = _tokens(cuda, 8, 8)
    for _ in range(2):  # no eager fallback the second time either
        with pytest.raises(RuntimeError):
            fused(params, emb, toks, lens)
    assert not fused.cache.graphs and fused.stats.counts()["graph_captures"] == 0
    monkeypatch.setattr(sse, "encode_source", real)
    assert _same(fused(params, emb, toks, lens), fused.run(params, emb, toks, lens, T))
