"""The grid's query program and grid index build as CUDA graphs on cards
(marker ``gpu``; skips where torch sees no card, and the tests that need
two cards skip below two).

- ``build_fused_query_fn(..., mesh=)`` captures one graph a distinct card
  and shape; a replay equals the eager grid call (``fn.run``) bit for
  bit, rows and values, on (1, 2) and (2, 2) grids (every entry on
  cuda:0 with one card; with two, the (2, 2) grid names each card
  twice), bf16 and int8, B=8 streaming and B=4096 two-phase, packed and
  exact; launches a replay: data x model a top-k kernel, one GRU forward
  a (replica, distinct card).
- Back-to-back calls on different tokens each get their own rows; the
  graph reads num_real on the device, below, inside and past a block.
- Replays, and a capture, under ``torch.cuda.set_sync_debug_mode("error")``;
  a capture that fails raises, with no eager fallback.
- A grid engine: ``warmup`` captures every (tier, bucket) on every card,
  an add needs no capture, a delete recaptures only through ``warmup``,
  and a call on the replaced ``RowShards`` runs eagerly and drops
  nothing.
- ``build_index`` on a grid: one captured chunk program a card, rows equal
  to the one-card build's bit for bit (bf16, int8, float32).
Run on the card with ``python -m pytest --noconftest
tests/test_torch_gpu_grid_graph.py``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

T = 2048 * 48  # 12 two-phase blocks a shard on 4 shards: k=10 takes the two-phase route
NR = T - 3000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return cuda


def _mesh(shape, cards=None):
    """A grid of ``shape`` over ``cards`` cards in turn (every visible
    card by default): entry i is cuda:(i mod cards)."""
    from sse_tpu_torch.parallel import make_mesh

    n = cards or torch.cuda.device_count()
    return make_mesh(*shape, devices=[torch.device("cuda", i % n)
                                      for i in range(shape[0] * shape[1])])


def _model(seed: int = 0):
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig

    cfg = SSEConfig(mode=NetworkMode.SHARED_ENCODER, src_tower=TowerConfig(
        cell="gru", vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128))
    return cfg, sse.init_params(cfg, torch.Generator().manual_seed(seed), "cuda")


def _rows(gen, dtype: str, t: int = T):
    from sse_tpu_torch.index.sharded_index import quantize_rows

    x = torch.randn((t, 128), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    return quantize_rows(x, {"bf16": torch.bfloat16, "int8": torch.int8,
                             "f32": torch.float32}[dtype])


def _tokens(gen, b: int, w: int = 50):
    toks = torch.randint(2, 8000, (b, w), generator=gen, device="cuda", dtype=torch.int32)
    lens = torch.randint(1, w + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
    return toks, lens


def _same(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _grid_fn(gen, shape, dtype, variant="packed", k=10, cards=None):
    from sse_tpu_torch.parallel import RowShards, replicate
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    cfg, params = _model()
    mesh = _mesh(shape, cards)
    emb = RowShards.from_tensor(_rows(gen, dtype), mesh)
    fn = build_fused_query_fn(cfg, k, NR, variant, mesh=mesh)
    return fn, replicate(params, mesh), emb, mesh


@pytest.mark.parametrize("b,variant", [(8, "packed"), (4096, "packed"), (8, "exact")])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_grid_replay_equals_eager(cuda, shape, dtype, b, variant):
    from sse_tpu_torch import ops

    fn, params, emb, mesh = _grid_fn(cuda, shape, dtype, variant)
    cards = mesh.entries_by_device()
    toks, lens = _tokens(cuda, b)
    first = fn(params, emb, toks, lens)  # one capture a distinct card
    assert _same(first, fn.run(params, emb, toks, lens, NR))
    toks2, lens2 = _tokens(cuda, b)
    ops.reset_launch_counts()
    got = fn(params, emb, toks2, lens2)
    torch.cuda.synchronize()
    replayed = ops.launch_counts()
    assert _same(got, fn.run(params, emb, toks2, lens2, NR))
    data, model = shape
    route = ("twophase_p1", "twophase_p2") if (variant == "packed" and b // data >= 1024) else (
        ("topk_exact",) if variant == "exact" else ("topk_stream",))
    assert all(replayed[n] == data * model for n in route), replayed
    assert sum(replayed[n] for n in ops.topk.KERNELS) == len(route) * data * model
    assert replayed["gru_fwd"] == sum(len({d for d, _ in e}) for e in cards.values())
    assert fn.stats.counts() == {"graph_captures": len(cards), "graph_replays": len(cards),
                                 "graph_eager": 0}


def test_back_to_back_calls_get_their_own_rows(cuda):
    fn, params, emb, _ = _grid_fn(cuda, (2, 2), "bf16")
    batches = [_tokens(cuda, 8) for _ in range(6)]
    got = [fn(params, emb, t, l) for t, l in batches]  # no sync between the calls
    for (t, l), out in zip(batches, got):
        assert _same(out, fn.run(params, emb, t, l, NR))
    assert not torch.equal(got[1][1], got[2][1])


def test_num_real_on_the_device_below_inside_and_past_a_block(cuda):
    fn, params, emb, mesh = _grid_fn(cuda, (1, 4), "bf16")
    t_local = emb.rows_per_shard
    toks, lens = _tokens(cuda, 8)
    fn(params, emb, toks, lens)
    for nr in (0, 5, t_local - 1, t_local, t_local + 7, 3 * t_local - 2, T):
        want = fn.run(params, emb, toks, lens, nr)
        assert _same(fn(params, emb, toks, lens, nr), want), nr
        as_tensor = torch.full((), nr, dtype=torch.int32, device="cuda")
        assert _same(fn(params, emb, toks, lens, as_tensor), want), nr
    assert fn.stats.counts()["graph_captures"] == len(mesh.entries_by_device())


@pytest.mark.parametrize("variant", ["packed", "exact"])
def test_replays_and_capture_sync_nothing(cuda, variant):
    fn, params, emb, _ = _grid_fn(cuda, (2, 2), "bf16", variant)
    fn.run(params, emb, *_tokens(cuda, 4096), NR)  # build the kernels
    torch.cuda.synchronize()
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in (8, 4096):
            toks, lens = _tokens(cuda, b)
            got.append((fn(params, emb, toks, lens), toks, lens, NR))  # capture
            got.append((fn(params, emb, toks, lens, NR - 7), toks, lens, NR - 7))  # replay
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for out, toks, lens, nr in got:
        assert _same(out, fn.run(params, emb, toks, lens, nr))


def test_failed_capture_raises(cuda, monkeypatch):
    from sse_tpu_torch.models import sse

    fn, params, emb, _ = _grid_fn(cuda, (2, 2), "bf16")
    real = sse.encode_source

    def syncing(*args, **kw):
        q = real(*args, **kw)
        float(q.sum())  # a host read: no CUDA graph can hold it
        return q

    monkeypatch.setattr(sse, "encode_source", syncing)
    toks, lens = _tokens(cuda, 8)
    for _ in range(2):  # no eager fallback the second time either
        with pytest.raises(RuntimeError):
            fn(params, emb, toks, lens)
    assert not fn.cache.graphs and fn.stats.counts()["graph_captures"] == 0
    monkeypatch.setattr(sse, "encode_source", real)
    assert _same(fn(params, emb, toks, lens), fn.run(params, emb, toks, lens, NR))


def test_grid_on_two_cards(two_cards):
    """(1, 2) over two cards: one graph a card, each replayed."""
    fn, params, emb, mesh = _grid_fn(two_cards, (1, 2), "bf16", cards=2)
    assert len(mesh.entries_by_device()) == 2
    for b in (8, 4096):
        toks, lens = _tokens(two_cards, b)
        fn(params, emb, toks, lens)
        toks, lens = _tokens(two_cards, b)
        assert _same(fn(params, emb, toks, lens), fn.run(params, emb, toks, lens, NR))
    assert fn.stats.counts() == {"graph_captures": 4, "graph_replays": 4, "graph_eager": 0}


def _engine(gen, shape=(1, 2), n: int = 4090, capacity: int = 8192):
    from sse_tpu_torch.index import sharded_index
    from sse_tpu_torch.serve import QueryEngine
    from sse_tpu_torch.text.subword import SubwordVocab

    cfg, params = _model()
    vocab = SubwordVocab.build_from_token_counts({f"w{i}": 10 for i in range(300)}, 2, 4)
    rows = torch.randn((n, 128), generator=gen, device="cuda")
    rows = rows / rows.norm(dim=1, keepdim=True)
    index = sharded_index.from_embeddings(rows, [f"d{i}" for i in range(n)],
                                          [f"doc {i}" for i in range(n)], capacity=capacity,
                                          dtype=torch.bfloat16, mesh=_mesh(shape))
    return QueryEngine(params, cfg, vocab, index, max_seq_length=50, max_batch=8, k=10,
                       bulk_batch=256)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_engine_warmup_add_delete_on_a_grid(cuda, shape):
    eng = _engine(cuda, shape)
    cards = len(eng.mesh.entries_by_device())
    assert eng.captures_graphs
    eng.warmup()
    shapes = len(eng._batch_tiers()) * len(eng._bucket_widths())
    assert eng.graph_counts() == {"graph_captures": shapes * cards, "graph_replays": 0,
                                  "graph_eager": 0, "graphs_cached": shapes * cards}
    texts = ["w1 w2 w3", "w4 w5"]
    eng.query(texts)
    # an add across the blocks' boundary (rows 4090..4099, 4096) with k
    # unchanged: no capture, and each new document ranks first for its text
    new = [f"w{i} w{i + 50} w{i + 100} w{i + 150}" for i in range(10)]
    eng.add_documents([f"new{i}" for i in range(10)], new)
    assert eng.graph_counts()["graph_captures"] == shapes * cards
    assert [hits[0]["targetId"] for hits in eng.query(new)] == [f"new{i}" for i in range(10)]
    old_emb, old_nr = eng.index.pub[:2]
    eng.delete_documents(["new0", "new9", "d0", "d1"])
    after = eng.graph_counts()
    assert after["graph_captures"] == 2 * shapes * cards == 2 * after["graphs_cached"]
    fn = eng._fused
    tokens, lengths = eng.encode_queries(texts)
    # the replaced RowShards: eager, nothing captured or dropped
    stale = fn(eng.params, old_emb, tokens, lengths, old_nr)
    assert _same(stale, fn.run(eng.params, old_emb, tokens, lengths, old_nr))
    assert eng.graph_counts()["graph_captures"] == 2 * shapes * cards
    assert eng.graph_counts()["graphs_cached"] == shapes * cards
    emb, nr = eng.index.pub[:2]
    assert _same(fn(eng.params, emb, tokens, lengths, nr),
                 fn.run(eng.params, emb, tokens, lengths, nr))
    ids = {h["targetId"] for hits in eng.query(texts) for h in hits}
    assert not ids & {"new0", "new9", "d0", "d1"}


def _tspace(t: int, seed: int = 1):
    from sse_tpu_torch.data.corpus import TargetSpace

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 51, size=(t,)).astype(np.int32)
    toks = rng.integers(2, 8000, size=(t, 50)).astype(np.int32)
    toks[np.arange(50)[None, :] >= lens[:, None]] = 0
    ids = [f"t{i}" for i in range(t)]
    return TargetSpace(ids=ids, texts=ids, tokens=toks, lengths=lens,
                       id_to_row={x: i for i, x in enumerate(ids)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_grid_build_equals_one_card_build(cuda, shape, dtype):
    from sse_tpu_torch.index import build_index
    from sse_tpu_torch.utils.graphs import GraphStats

    cfg, params = _model()
    t = 9000  # 4 chunks of 4 x 512 and a padded tail
    tspace = _tspace(t)
    kw = dict(batch_size=512, dtype=dtype, chunk_batches=4)
    one = build_index(params, cfg, tspace, **kw)
    stats, calls = GraphStats(), []
    mesh = _mesh(shape)
    grid = build_index(params, cfg, tspace, mesh=mesh, graph_stats=stats,
                       progress=lambda *a: calls.append(a), **kw)
    rows = grid.emb[:]
    assert torch.equal(rows[:t], one.emb[:t]) and not rows[t:].any()
    assert calls == [(min(hi, t), t) for hi in range(2048, t + 2048, 2048)]
    used = {mesh.column_devices(lo // grid.emb.rows_per_shard)[0]
            for lo in range(0, t, 2048)}
    assert stats.counts() == {"graph_captures": len(used), "graph_replays": 5 - len(used),
                              "graph_eager": 0}
