"""The Evaluator's and the index build's programs as CUDA graphs on a card
(marker ``gpu``; skips where torch sees no card).

- The Evaluator's replays (its target encode and its fused encode and
  top-k) equal the same programs run eagerly (``capture=False``) bit for
  bit: target embeddings and top rows, for GRU, LSTM and transformer
  towers, dual and shared; 2 captures on the first ``evaluate``, none on a
  second with other param values; source-encoder-only captures only the
  top-k.
- ``build_index``'s chunk graph: one capture a build, the rows equal the
  eager build's bit for bit (bf16, int8, float32; several chunks and a
  padded tail; GRU, LSTM, transformer), the reserve rows zero.
- A replay of either graph never syncs the host
  (``torch.cuda.set_sync_debug_mode("error")``).
- A query on the old buffer that lands between a delete's warmup
  captures runs eagerly, and the new buffer's graphs all stay.
Run on the card with ``python -m pytest --noconftest
tests/test_torch_gpu_eval_graph.py``."""

import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

T, N, BS = 3000, 700, 256  # neither a multiple of the batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _config(cell: str, mode: str = "dual-encoder", t: int = T):
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig

    width = dict(vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128)
    if cell == "lstm":  # the qna preset's tower
        tower = TowerConfig(cell="lstm", readout="attention", **width)
    elif cell == "transformer":
        tower = TowerConfig(cell="transformer", num_layers=4, readout="mean", **width)
    else:
        tower = TowerConfig(cell="gru", **width)
    extra = {"num_targets": t} if mode == "source-encoder-only" else {}
    return SSEConfig(mode=NetworkMode(mode), src_tower=tower, tgt_tower=tower, **extra)


def _model(cell: str, mode: str = "dual-encoder", seed: int = 0):
    from sse_tpu_torch.models import sse

    cfg = _config(cell, mode)
    return cfg, sse.init_params(cfg, torch.Generator().manual_seed(seed), "cuda")


def _tokens(rng, n: int, length: int):
    lens = rng.integers(1, length + 1, size=(n,)).astype(np.int32)
    toks = rng.integers(2, 8000, size=(n, length)).astype(np.int32)
    toks[np.arange(length)[None, :] >= lens[:, None]] = 0
    return toks, lens


def _data(t: int = T, n: int = N, seed: int = 1):
    from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace

    rng = np.random.default_rng(seed)
    toks, lens = _tokens(rng, t, 50)
    ids = [f"t{i}" for i in range(t)]
    tspace = TargetSpace(ids=ids, texts=ids, tokens=toks, lengths=lens,
                         id_to_row={x: i for i, x in enumerate(ids)})
    src, src_len = _tokens(rng, n, 16)
    labels = rng.integers(0, t, size=(n,)).astype(np.int32)
    pairs = EncodedPairs(src=src, src_len=src_len, labels=labels,
                         label_sets=[(int(x),) for x in labels])
    return tspace, pairs


def _other(params, seed: int):
    """Params of the same shapes with other values."""
    from sse_tpu_torch.train.loop import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=gen, device="cuda"),
                    params)


@pytest.mark.parametrize("cell,mode", [("gru", "dual-encoder"), ("gru", "shared-encoder"),
                                       ("lstm", "dual-encoder"),
                                       ("transformer", "dual-encoder")])
def test_evaluator_replays_equal_eager(cuda, cell, mode):
    from sse_tpu_torch.evals import Evaluator

    tspace, pairs = _data()
    cfg, params = _model(cell, mode)
    ev = Evaluator(cfg, pairs, tspace, ks=(1, 10))
    eager = Evaluator(cfg, pairs, tspace, ks=(1, 10), capture=False)
    for i, p in enumerate((params, _other(params, 1))):
        got_rows = ev.top_rows(p)
        got_emb = ev.encode_targets(p).clone()
        assert np.array_equal(got_rows, eager.top_rows(p)), i
        assert torch.equal(got_emb, eager.encode_targets(p)), i
        assert ev.graph_stats.counts()["graph_captures"] == 2, i
    assert eager.graph_stats.counts()["graph_captures"] == 0
    assert got_rows.shape == (N, 10) and got_emb.shape == (T, 128)


def test_evaluator_source_encoder_only_captures_the_topk(cuda):
    from sse_tpu_torch.evals import Evaluator

    tspace, pairs = _data()
    cfg, params = _model("gru", "source-encoder-only")
    ev = Evaluator(cfg, pairs, tspace, sample_targets=1000)
    eager = Evaluator(cfg, pairs, tspace, sample_targets=1000, capture=False)
    for p in (params, _other(params, 2)):
        assert np.array_equal(ev.top_rows(p), eager.top_rows(p))
    assert ev.graph_stats.counts()["graph_captures"] == 1


@contextlib.contextmanager
def _no_sync():
    """Any host sync inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


class _Recording:
    """Wraps ``utils.graphs.Program`` to keep every program made."""

    made = []

    def __new__(cls, *args, **kw):
        from sse_tpu_torch.utils.graphs import Program

        program = Program(*args, **kw)
        cls.made.append(program)
        return program


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("cell", ["gru", "lstm", "transformer"])
def test_build_index_replays_equal_eager(cuda, cell, dtype, monkeypatch):
    from sse_tpu_torch import ops
    from sse_tpu_torch.index import sharded_index
    from sse_tpu_torch.utils.graphs import GraphStats

    tspace, _ = _data()
    cfg, params = _model(cell)
    monkeypatch.setattr(sharded_index, "Program", _Recording)
    _Recording.made = []
    stats, calls = GraphStats(), []
    kw = dict(batch_size=BS, dtype=dtype, capacity=4096, chunk_batches=4)
    got = sharded_index.build_index(params, cfg, tspace, graph_stats=stats,
                                    progress=lambda *a: calls.append(a), **kw)
    want = sharded_index.build_index(params, cfg, tspace, capture=False, **kw)
    assert torch.equal(got.emb, want.emb) and not got.emb[T:].any()
    # 3 chunks of 1,024
    assert stats.counts() == {"graph_captures": 1, "graph_replays": 2, "graph_eager": 0}
    assert calls == [(1024, T), (2048, T), (T, T)]
    program = _Recording.made[0]
    ops.reset_launch_counts()
    with _no_sync():
        program()  # a replay
    torch.cuda.synchronize()
    if cell == "gru":
        assert ops.launch_counts()["gru_fwd"] == 4  # one a sub-batch
    elif cell == "lstm":
        assert ops.launch_counts()["lstm_fwd"] == 4


def test_evaluator_replays_never_sync(cuda):
    from sse_tpu_torch.evals import Evaluator

    tspace, pairs = _data()
    cfg, params = _model("gru")
    ev = Evaluator(cfg, pairs, tspace)
    ev.evaluate(params)
    programs = ev._programs
    with _no_sync():
        programs.encode()
        programs.topk()
    torch.cuda.synchronize()
    assert ev.graph_stats.counts()["graph_captures"] == 2


def test_delete_race_keeps_the_new_graphs(cuda, monkeypatch):
    from sse_tpu_torch.index import sharded_index
    from sse_tpu_torch.serve import QueryEngine
    from sse_tpu_torch.text.subword import SubwordVocab

    cfg, params = _model("gru", "shared-encoder")
    vocab = SubwordVocab.build_from_token_counts({f"w{i}": 10 for i in range(300)}, 2, 4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = torch.randn((5000, 128), generator=gen, device="cuda")
    rows = rows / rows.norm(dim=1, keepdim=True)
    index = sharded_index.from_embeddings(rows, [f"d{i}" for i in range(5000)],
                                          [f"doc {i}" for i in range(5000)], capacity=8192,
                                          dtype=torch.bfloat16, device="cuda")
    eng = QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=10,
                      bulk_batch=256)
    eng.warmup()
    fn, shapes = eng._fused, 8
    stale_emb, stale_nr = eng.index.pub[:2]
    tokens, lengths = eng.encode_queries(["w1 w2 w3"])
    real, stale = fn.replay, []

    def replay_then_stale_query(*args, **kw):
        out = real(*args, **kw)
        if not stale:  # a query that read the index before the delete (fn.__call__'s path)
            stale.append(real(params, stale_emb, tokens, lengths, stale_nr, adopt=False))
        return out

    monkeypatch.setattr(fn, "replay", replay_then_stale_query)
    eng.delete_documents(["d0", "d1"])
    monkeypatch.setattr(fn, "replay", real)
    new_emb, nr = eng.index.pub[:2]
    assert fn.cache.emb is new_emb and len(fn.cache.graphs) == shapes
    assert eng.graph_counts() == {"graph_captures": 2 * shapes, "graph_replays": 0,
                                  "graph_eager": 1, "graphs_cached": shapes}
    want = fn.run(params, stale_emb, tokens, lengths, stale_nr)
    assert torch.equal(stale[0][0], want[0]) and torch.equal(stale[0][1], want[1])
    got = fn(params, new_emb, tokens, lengths, nr)
    want = fn.run(params, new_emb, tokens, lengths, nr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert eng.graph_counts()["graph_replays"] == 1
