"""The Evaluator's and the index build's fixed-shape programs on the CPU,
and the served function's rule for a stale index buffer.

- The Evaluator pads its last source and target batches to ``batch_size``
  as the JAX Evaluator does; its top rows equal the JAX Evaluator's
  exactly where neither count is a multiple of ``batch_size`` (dual,
  shared and source-encoder-only, and a sampled target subset).
- Its graph policy, driven with a stand-in for the CUDA capture (no card
  here): 2 captures on the first ``evaluate`` (1 for
  source-encoder-only), none on a second with other param values, whose
  values are copied into the Evaluator's own buffers; a capture that
  raises caches nothing and takes a new pool next time.
- ``build_index`` takes ``chunk_batches`` and ``progress`` with JAX's
  meaning: at corpus sizes around a chunk boundary its rows match JAX's
  (atol 2e-3, rtol 1e-3, as ``tests/test_torch_serve.py`` holds them),
  the reserve rows are zero and the ``progress`` calls are JAX's; on a
  grid its rows equal the one-device build's exactly.
- ``CapturedQuery``: a call on a buffer other than the one its graphs
  belong to runs eagerly and drops nothing; the engine's warmup after a
  delete keeps the new buffer's graphs when a query on the old buffer
  lands between its captures.
"""

import jax
import numpy as np
import pytest
import torch

from sse_tpu.data.corpus import EncodedPairs, TargetSpace
from sse_tpu.evals import recall as jrecall
from sse_tpu.index import sharded_index as jindex
from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.evals import recall as trecall
from sse_tpu_torch.index import sharded_index as tindex
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.serve import QueryEngine, engine as tengine
from sse_tpu_torch.text.subword import SubwordVocab
from sse_tpu_torch.utils import graphs

VOCAB, L, BS = 300, 10, 8
TOWER = dict(vocab_size=VOCAB, embed_dim=16, hidden=16, encoding_dim=16)


def _tokens(rng, n: int):
    lens = rng.integers(1, L + 1, size=(n,)).astype(np.int32)
    toks = rng.integers(2, VOCAB, size=(n, L)).astype(np.int32)
    toks[np.arange(L)[None, :] >= lens[:, None]] = 0
    return toks, lens


def _data(t: int = 21, n: int = 19, seed: int = 5):
    """A target space of ``t`` rows and ``n`` eval pairs of random tokens,
    one to three labels each."""
    rng = np.random.default_rng(seed)
    toks, lens = _tokens(rng, t)
    ids = [f"t{i}" for i in range(t)]
    tspace = TargetSpace(ids=ids, texts=ids, tokens=toks, lengths=lens,
                         id_to_row={x: i for i, x in enumerate(ids)})
    src, src_len = _tokens(rng, n)
    sets = [tuple(int(r) for r in rng.choice(t, size=rng.integers(1, 4), replace=False))
            for _ in range(n)]
    pairs = EncodedPairs(src=src, src_len=src_len,
                         labels=np.int32([s[0] for s in sets]), label_sets=sets)
    return tspace, pairs


def _model(mode: str, t: int = 21, seed: int = 3):
    extra = {"num_targets": t} if mode == "source-encoder-only" else {}
    jm = jsse.SSEConfig(mode=jsse.NetworkMode(mode), src_tower=jtowers.TowerConfig(**TOWER),
                        tgt_tower=jtowers.TowerConfig(**TOWER), **extra)
    tm = tsse.SSEConfig(mode=tsse.NetworkMode(mode), src_tower=ttowers.TowerConfig(**TOWER),
                        tgt_tower=ttowers.TowerConfig(**TOWER), **extra)
    jp = jsse.init_params(jax.random.PRNGKey(seed), jm)
    return jm, tm, jp, params_from_jax(jax.tree.map(np.asarray, jp))


CASES = [("dual-encoder", None), ("shared-encoder", None), ("source-encoder-only", None),
         ("dual-encoder", 9)]


# ------------------------------------------------------ the Evaluator
@pytest.mark.parametrize("mode,sample", CASES)
def test_top_rows_equal_jax(mode, sample):
    """Padded last batches (19 sources, 21 targets or a sampled subset of
    them, batch 8): the same top rows as the JAX Evaluator, and the same
    metrics."""
    tspace, pairs = _data()
    assert pairs.num_examples % BS and tspace.num_targets % BS
    jm, tm, jp, tp = _model(mode)
    kw = dict(batch_size=BS, ks=(1, 3, 10), sample_targets=sample)
    jev, tev = jrecall.Evaluator(jm, pairs, tspace, **kw), trecall.Evaluator(tm, pairs, tspace, **kw)
    t = 21 if sample is None else len(jev._subset)
    assert t % BS and (sample is None or t < 21)
    want = jev.top_rows(jp)
    got = tev.top_rows(tp)
    assert got.shape == want.shape == (19, 10)
    np.testing.assert_array_equal(got, want)
    assert tev.evaluate(tp) == jev.evaluate(jp)
    # a caller's target embeddings are scored as given
    emb = tev.encode_targets(tp).clone()
    assert emb.shape == (t, 16)
    np.testing.assert_array_equal(tev.top_rows(tp, emb), want)
    assert tev.graph_stats.counts() == {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0}


class _Captured:
    """A stand-in for ``graphs.Captured``: its warm-up runs ``run`` once,
    and each replay runs it again on the same fixed buffers, as a replayed
    graph reads them. ``fail`` makes the next capture raise."""

    made = []
    fail = False

    def __init__(self, run, dev, pool, side, pack=None):
        if _Captured.fail:
            _Captured.fail = False
            raise RuntimeError("capture failed")
        self.run, self.pool, self.side = run, pool, side
        self.first = run()
        self.seconds, self.mib = 0.25, 1.5
        _Captured.made.append(self)

    def take_first(self):
        out, self.first = self.first, None
        return out

    def replay(self):
        return self.run()


@pytest.fixture
def stand_in(monkeypatch):
    pools = iter(range(100))
    monkeypatch.setattr(graphs, "Captured", _Captured)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(pools))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "side")
    monkeypatch.setattr(graphs, "pool_for",  # the CPU stands in for a card
                        lambda dev, capture=True: graphs.GraphPool(dev) if capture else None)
    _Captured.made, _Captured.fail = [], False
    return _Captured


def _other(tp, seed: int):
    """Params of the same shapes with other values."""
    gen = torch.Generator().manual_seed(seed)
    return jax.tree.map(lambda x: x + 0.05 * torch.randn(x.shape, generator=gen), tp)


@pytest.mark.parametrize("mode,sample", CASES)
def test_evaluator_graph_policy(stand_in, mode, sample):
    """Captures on the first evaluate only (the programs' warm-ups are
    the first batches' dispatches), one replay a further batch, params
    copied in, and the eager Evaluator's rows every time."""
    tspace, pairs = _data()
    _, tm, _, tp = _model(mode)
    kw = dict(batch_size=BS, ks=(1, 3, 10), sample_targets=sample)
    ev, eager = trecall.Evaluator(tm, pairs, tspace, **kw), trecall.Evaluator(
        tm, pairs, tspace, capture=False, **kw)
    seo = mode == "source-encoder-only"
    t = 21 if sample is None else len(ev._subset)
    want_captures = 1 if seo else 2
    batches = 3 + (0 if seo else -(-t // BS))  # 3 source batches, ceil(t / 8) target ones
    other = _other(tp, 1)
    for i, params in enumerate((tp, other, tp)):
        np.testing.assert_array_equal(ev.top_rows(params), eager.top_rows(params))
        assert ev.graph_stats.counts() == {"graph_captures": want_captures,
                                           "graph_replays": batches * (i + 1) - want_captures,
                                           "graph_eager": 0}
        own = ev._programs.own
        for name in own:  # the programs read copies of the caller's towers
            for mine, theirs in zip(jax.tree.leaves(own[name]), jax.tree.leaves(params[name])):
                assert mine is not theirs and torch.equal(mine, theirs)
    assert {c.pool for c in stand_in.made} == {0} and len(stand_in.made) == want_captures
    assert [r["shape"][0] for r in ev.graph_stats.log] == (["topk"] if seo else
                                                           ["encode", "topk"])
    assert eager.graph_stats.counts() == {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0}


def test_evaluator_capture_failure_caches_nothing(stand_in):
    tspace, pairs = _data()
    _, tm, _, tp = _model("dual-encoder")
    ev = trecall.Evaluator(tm, pairs, tspace, batch_size=BS)
    stand_in.fail = True
    with pytest.raises(RuntimeError, match="capture failed"):
        ev.evaluate(tp)
    assert ev.graph_stats.counts() == {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0}
    assert ev._programs.encode.graph is None and ev._programs.topk.graph is None
    want = trecall.Evaluator(tm, pairs, tspace, batch_size=BS, capture=False).top_rows(tp)
    np.testing.assert_array_equal(ev.top_rows(tp), want)
    assert ev.graph_stats.counts()["graph_captures"] == 2
    assert [c.pool for c in stand_in.made] == [1, 1]  # the failed capture's pool is not reused


# ------------------------------------------------------ the index build
@pytest.mark.parametrize("chunk_batches,t", [(1, 7), (1, 16), (1, 17), (2, 15), (2, 16),
                                             (2, 33), (64, 24), (64, 513)])
def test_build_index_chunks_match_jax(chunk_batches, t):
    """Rows within the encoders' tolerance, reserve rows zero, and JAX's
    progress calls, for each chunk size around a chunk boundary (batch 8;
    513 rows make a 512-row chunk and a padded tail of one row)."""
    tspace, _ = _data(t=t, n=1, seed=t)
    jm, tm, jp, tp = _model("shared-encoder")
    jcalls, tcalls = [], []
    kw = dict(batch_size=BS, capacity=t + 20, chunk_batches=chunk_batches)
    jidx = jindex.build_index(jp, jm, tspace, progress=lambda *a: jcalls.append(a), **kw)
    tidx = tindex.build_index(tp, tm, tspace, progress=lambda *a: tcalls.append(a), **kw)
    assert tcalls == jcalls and tcalls[-1] == (t, t)
    assert tidx.emb.shape == jidx.emb.shape and tidx.num_real == jidx.num_real == t
    np.testing.assert_allclose(tidx.emb.numpy(), np.asarray(jidx.emb), atol=2e-3, rtol=1e-3)
    assert not tidx.emb[t:].any()  # reserve and tail-padding rows are zero vectors


def test_build_index_grid_path_reports_jax_progress():
    """The grid path encodes in JAX's chunks, reports them as JAX does,
    and writes the one-device build's rows bit for bit."""
    from sse_tpu_torch.parallel import make_mesh

    tspace, _ = _data(t=40, n=1)
    jm, tm, jp, tp = _model("shared-encoder")
    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    jcalls, tcalls = [], []
    jindex.build_index(jp, jm, tspace, batch_size=BS, chunk_batches=2,
                       progress=lambda *a: jcalls.append(a))
    grid = tindex.build_index(tp, tm, tspace, batch_size=BS, chunk_batches=2, mesh=mesh,
                              progress=lambda *a: tcalls.append(a))
    one = tindex.build_index(tp, tm, tspace, batch_size=BS, chunk_batches=2)
    assert tcalls == jcalls == [(16, 40), (32, 40), (40, 40)]
    assert torch.equal(grid.emb[:][:40], one.emb[:40]) and not grid.emb[:][40:].any()


# --------------------------------------------- the served function's buffer
class _Graph:
    """A stand-in for ``engine.QueryGraph`` whose replay runs the eager
    path on the buffer it was captured over."""

    def __init__(self, run, params, emb, tokens, lengths, nr, pool, side):
        self.run, self.params, self.emb = run, params, emb
        self.first = run(params, emb, tokens, lengths, nr)
        self.seconds, self.mib = 0.25, 1.5

    def take_first(self):
        out, self.first = self.first, None
        return out

    def __call__(self, tokens, lengths, nr):
        return self.run(self.params, self.emb, tokens, lengths, nr)


@pytest.fixture
def query_stand_in(monkeypatch):
    pools = iter(range(100))
    monkeypatch.setattr(tengine, "QueryGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(pools))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "side")


def _same(a, b):
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_stale_buffer_runs_eagerly_and_drops_nothing(query_stand_in):
    _, tm, _, tp = _model("shared-encoder")
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    toks, lens = map(torch.from_numpy, _tokens(rng, 4))
    fused = tengine.build_fused_query_fn(tm, k=5, num_real=40)
    fused.replay(tp, emb, toks, lens, 40, adopt=False)  # the first call adopts its buffer
    assert fused.cache.emb is emb and len(fused.cache.graphs) == 1
    old = emb.clone()
    got = fused.replay(tp, old, toks, lens, 40, adopt=False)
    assert _same(got, fused.run(tp, old, toks, lens, 40))
    fused.replay(tp, old, toks[:, :6], lens, 40, adopt=False)  # a new shape: still eager
    assert fused.cache.emb is emb and len(fused.cache.graphs) == 1
    # each eager call on the stale buffer is counted
    assert fused.stats.counts() == {"graph_captures": 1, "graph_replays": 0, "graph_eager": 2}
    fused.replay(tp, emb, toks, lens, 40, adopt=False)  # the adopted buffer replays
    assert fused.stats.counts() == {"graph_captures": 1, "graph_replays": 1, "graph_eager": 2}


def test_delete_race_keeps_the_new_graphs(query_stand_in, monkeypatch):
    """A query on the index it read before a delete lands between the
    delete's warmup captures: it runs eagerly, the warmup's graphs all
    belong to the new buffer, and the next query replays."""
    _, tm, _, tp = _model("shared-encoder")
    rows = np.eye(6, 16, dtype=np.float32)
    ids = [f"d{i}" for i in range(6)]
    index = tindex.from_embeddings(rows, ids, list(ids), capacity=16, device="cpu")
    vocab = SubwordVocab(["a_", "b_"])
    monkeypatch.setattr(QueryEngine, "captures_graphs", property(lambda self: True))
    eng = QueryEngine(tp, tm, vocab, index, max_seq_length=L, max_batch=2, k=3)
    eng.warmup()
    fn, shapes = eng._fused, len(eng._bucket_widths())
    assert fn.cache.graphs and eng.graph_counts()["graph_captures"] == shapes
    stale_emb, stale_nr = eng.index.pub[:2]
    toks = torch.zeros((2, 8), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    real, stale = fn.replay, []

    def replay_then_stale_query(*args, **kw):
        out = real(*args, **kw)
        if not stale:  # after the first capture of the new buffer
            stale.append(real(tp, stale_emb, toks, lens, stale_nr, adopt=False))
        return out

    monkeypatch.setattr(fn, "replay", replay_then_stale_query)
    eng.delete_documents(["d1"])
    new_emb = eng.index.pub[0]
    assert new_emb is not stale_emb and fn.cache.emb is new_emb
    assert len(fn.cache.graphs) == shapes
    assert eng.graph_counts() == {"graph_captures": 2 * shapes, "graph_replays": 0,
                                  "graph_eager": 1, "graphs_cached": shapes}
    assert _same(stale[0], fn.run(tp, stale_emb, toks, lens, stale_nr))
    monkeypatch.setattr(fn, "replay", real)
    fn.replay(tp, new_emb, toks, lens, eng.index.num_real, adopt=False)
    assert eng.graph_counts()["graph_replays"] == 1
