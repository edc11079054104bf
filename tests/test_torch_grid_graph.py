"""The grid's query program and grid index build on the CPU: one body a
distinct device, captured a device and key (driven here with a stand-in
for the CUDA capture, as no card is here), every device's body replayed
before the merge.

- ``Mesh.entries_by_device`` groups a grid's entries by distinct device:
  (1, 2), (2, 2) and (1, 4) grids of distinct CPU labels, a (2, 2) grid
  naming each of two devices twice, and one naming one device four
  times.
- ``GridQuery.replay``: one capture a distinct device, then replays, with
  the same rows and values as the eager grid call and the unsharded
  call; an encode a (replica, distinct device) and a top-k a grid entry,
  a call; a replica whose blocks all lie on one device is merged in that
  device's body.
- Its per-device keys: another shape captures on every device, another
  params copy on one device recaptures only there; a reading a capture
  names its device.
- A capture that fails raises and leaves no stale warm-up behind; a
  call on a ``RowShards`` other than the adopted one runs eagerly and
  drops nothing; a grid engine's delete recaptures through its warmup
  only.
- ``num_real`` as an int or a 0-d tensor, with ``num_real - row0`` below,
  inside and past a block: identical rows.
- The grid function against JAX's sharded function on its eight fake CPU
  devices (the exact variant on float32 and int8 indexes, at
  ``tests/test_torch_parallel.py``'s tolerances: values to rtol 2e-4 /
  atol 2e-5, a differing row only where its two scores lie within 1e-5,
  90% of rows equal).
- ``build_index`` on a grid: JAX's chunks and ``progress`` calls, rows
  within the towers' tolerance of JAX's mesh build (atol 2e-3, rtol
  1e-3, as ``tests/test_torch_eval_graph.py`` holds the one-device build),
  and bit for bit the port's one-device build; one program a device.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu import parallel as jpar
from sse_tpu.data.corpus import TargetSpace
from sse_tpu.index import sharded_index as jindex
from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu.serve.engine import build_fused_query_fn as jax_fused_fn
from sse_tpu_torch import parallel as tpar
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.index import sharded_index as tindex
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.ops import topk
from sse_tpu_torch.serve import QueryEngine, engine as tengine
from sse_tpu_torch.utils import graphs

CPU = torch.device("cpu")
K = 4
_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _cpus(*idx):
    return [torch.device("cpu", i) for i in idx]


GRIDS = {  # name → (shape, devices, {device: entries})
    "(1, 2)": ((1, 2), _cpus(0, 1), {0: [(0, 0)], 1: [(0, 1)]}),
    "(2, 2)": ((2, 2), _cpus(0, 1, 2, 3), {0: [(0, 0)], 1: [(0, 1)], 2: [(1, 0)],
                                            3: [(1, 1)]}),
    "(1, 4)": ((1, 4), _cpus(0, 1, 2, 3), {0: [(0, 0)], 1: [(0, 1)], 2: [(0, 2)],
                                            3: [(0, 3)]}),
    "(2, 2) twice": ((2, 2), _cpus(0, 1, 0, 1), {0: [(0, 0), (1, 0)], 1: [(0, 1), (1, 1)]}),
    "(2, 2) one device": ((2, 2), [CPU] * 4, {None: [(0, 0), (0, 1), (1, 0), (1, 1)]}),
}


def _grid(name):
    shape, devs, _ = GRIDS[name]
    return tpar.make_mesh(*shape, devices=devs)


@pytest.fixture(scope="module")
def model():
    """The JAX package's GRU test model (tests/test_parallel.py) and its
    converted params."""
    tower = dict(vocab_size=64, embed_dim=16, hidden=16, encoding_dim=16)
    jcfg = jsse.SSEConfig(mode=jsse.NetworkMode.SHARED_ENCODER,
                          src_tower=jtowers.TowerConfig(**tower))
    tcfg = tsse.SSEConfig(mode=tsse.NetworkMode.SHARED_ENCODER,
                          src_tower=ttowers.TowerConfig(**tower))
    jparams = jsse.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams))


class _Captured:
    """A stand-in for ``graphs.Captured``: its warm-up runs ``run`` once,
    and each replay runs it again on the same fixed buffers, as a replayed
    graph reads them."""

    made = []
    fail = None  # a device whose next capture raises

    def __init__(self, run, dev, pool, side, pack=None):
        if dev == _Captured.fail:
            raise RuntimeError("capture failed")
        self.run, self.dev, self.pool = run, dev, pool
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
    """The CPU stands in for cards: captures are ``_Captured``."""
    pools = iter(range(1000))
    monkeypatch.setattr(graphs, "Captured", _Captured)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(pools))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "side")
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "pool_for",
                        lambda dev, capture=True: graphs.GraphPool(dev) if capture else None)
    _Captured.made, _Captured.fail = [], None
    return _Captured


@pytest.fixture
def spy(monkeypatch):
    """Counts the query path's encodes and top-k calls."""
    calls = {"encode": 0, "topk": 0}
    enc, stream, two = (tengine.sse.encode_source, tengine.fused_score_topk,
                        tengine.fused_score_topk_twophase)

    def encode(params, cfg, tokens, lengths):
        calls["encode"] += 1
        return enc(params, cfg, tokens, lengths)

    def counted(real):
        def call(*args, **kw):
            calls["topk"] += 1
            return real(*args, **kw)
        return call

    monkeypatch.setattr(tengine.sse, "encode_source", encode)
    monkeypatch.setattr(tengine, "fused_score_topk", counted(stream))
    monkeypatch.setattr(tengine, "fused_score_topk_twophase", counted(two))
    return calls


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _unit_rows(n, d=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tokens(b, seed=0, width=8):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(2, 64, size=(b, width)).astype(np.int32)),
            torch.from_numpy(rng.integers(1, width + 1, size=(b,)).astype(np.int32)))


def _indexes(mesh, nr=200, dtype="bf16", capacity=256):
    emb = _unit_rows(nr, seed=nr)
    ids = [f"t{i}" for i in range(nr)]
    return (tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], capacity=capacity,
                                   mesh=mesh),
            tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], capacity=capacity,
                                   device="cpu"))


# ------------------------------------------------------------------ grouping
@pytest.mark.parametrize("name", list(GRIDS))
def test_entries_grouped_by_distinct_device(name):
    shape, devs, want = GRIDS[name]
    mesh = _grid(name)
    got = mesh.entries_by_device()
    want = {CPU if i is None else torch.device("cpu", i): e for i, e in want.items()}
    assert got == want and list(got) == list(want)
    assert mesh.local_devices == list(want)
    assert sorted(e for es in got.values() for e in es) == [
        (d, s) for d in range(shape[0]) for s in range(shape[1])]


# ------------------------------------------------------------- the program
@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_replay_per_device_matches_eager_and_unsharded(model, stand_in, spy, name, variant):
    """A capture a distinct device on the first call (its result the
    warm-ups'), a replay a device on the next; each call's rows and values
    equal the eager grid call's and the unsharded call's; each call
    encodes once a (replica, distinct device) and runs a top-k a grid
    entry."""
    _, tcfg, _, tparams = model
    mesh = _grid(name)
    cards = mesh.entries_by_device()
    data, shards = mesh.shape["data"], mesh.shape["model"]
    sidx, uidx = _indexes(mesh)
    fn = tengine.build_fused_query_fn(tcfg, K, 200, variant, mesh=mesh)
    unsharded = tengine.build_fused_query_fn(tcfg, K, 200, variant)
    params = tpar.replicate(tparams, mesh)
    encodes = sum(len({d for d, _ in e}) for e in cards.values())
    assert fn.merged == {dev: [d for d in range(data) if all(
        mesh.devices[d, s] == dev for s in range(shards))] for dev in cards}
    for i in range(3):
        toks, lens = _tokens(8, seed=i)
        before_enc, before_topk = spy["encode"], spy["topk"]
        got = fn.replay(params, sidx.emb, toks, lens, 200)
        assert spy["encode"] - before_enc == encodes
        assert spy["topk"] - before_topk == data * shards
        assert _same(got, fn.run(params, sidx.emb, toks, lens, 200))
        assert _same(got, unsharded(tparams, uidx.emb, toks, lens))
    assert fn.stats.counts() == {"graph_captures": len(cards), "graph_replays": 2 * len(cards),
                                 "graph_eager": 0}
    assert [c.dev for c in stand_in.made] == list(cards)
    assert len({c.pool for c in stand_in.made}) == len(cards)  # a pool a device
    assert [r["card"] for r in fn.stats.log] == [str(dev) for dev in cards]
    assert all(r["shape"] == (8, 8) for r in fn.stats.log)


def test_per_device_keys(model, stand_in):
    """The key of a device's graph: the tokens' and lengths' shapes and
    types, the device, its params copy's tensors and its row blocks.
    Another width captures on every device; a new params copy on one
    device recaptures there only; the same tensors replay."""
    _, tcfg, _, tparams = model
    mesh = _grid("(2, 2) twice")
    sidx, _ = _indexes(mesh)
    fn = tengine.build_fused_query_fn(tcfg, K, 200, mesh=mesh)
    params = tpar.replicate(tparams, mesh)
    toks, lens = _tokens(8)
    fn.replay(params, sidx.emb, toks, lens, 200)
    fn.replay(params, sidx.emb, toks, lens, 200)
    assert fn.stats.counts() == {"graph_captures": 2, "graph_replays": 2, "graph_eager": 0}
    fn.replay(params, sidx.emb, toks[:, :6].contiguous(), lens, 200)  # another width
    assert fn.stats.counts()["graph_captures"] == 4
    dev1 = torch.device("cpu", 1)
    other = tpar.Replicated(params)
    other[dev1] = jax.tree.map(lambda x: x.clone(), params[dev1])  # same values, new tensors
    got = fn.replay(other, sidx.emb, toks, lens, 200)
    assert fn.stats.counts() == {"graph_captures": 5, "graph_replays": 3, "graph_eager": 0}
    assert stand_in.made[-1].dev == dev1
    assert _same(got, fn.run(params, sidx.emb, toks, lens, 200))
    cards = mesh.entries_by_device()
    for key in fn.cache.graphs:
        dev = key[1]
        assert key[0] in ((8, 8), (8, 6))
        assert key[-1] == tuple(id(sidx.emb.block(s, dev)) for s in {s for _, s in cards[dev]})
    fn.replay(other, sidx.emb, toks, lens, 200)
    assert fn.stats.counts() == {"graph_captures": 5, "graph_replays": 5, "graph_eager": 0}


def test_failed_capture_raises_and_keeps_no_warm_up(model, stand_in):
    """A capture that fails on the second device raises (no eager
    fallback); the first device's graph stays cached without the failed
    call's warm-up, so the next call replays it, captures the second in
    a new pool, and returns its own rows."""
    _, tcfg, _, tparams = model
    mesh = _grid("(1, 2)")
    sidx, _ = _indexes(mesh)
    fn = tengine.build_fused_query_fn(tcfg, K, 200, mesh=mesh)
    params = tpar.replicate(tparams, mesh)
    dev0, dev1 = _cpus(0, 1)
    stand_in.fail = dev1
    with pytest.raises(RuntimeError, match="capture failed"):
        fn.replay(params, sidx.emb, *_tokens(8, seed=1), 200)
    assert [key[1] for key in fn.cache.graphs] == [dev0]
    assert fn.stats.counts() == {"graph_captures": 1, "graph_replays": 0, "graph_eager": 0}
    stand_in.fail = None
    toks, lens = _tokens(8, seed=2)
    got = fn.replay(params, sidx.emb, toks, lens, 200)
    assert _same(got, fn.run(params, sidx.emb, toks, lens, 200))
    assert fn.stats.counts() == {"graph_captures": 2, "graph_replays": 1, "graph_eager": 0}
    assert [c.dev for c in stand_in.made] == [dev0, dev1]


def test_stale_row_shards_run_eagerly_and_drop_nothing(model, stand_in):
    _, tcfg, _, tparams = model
    mesh = _grid("(1, 2)")
    sidx, _ = _indexes(mesh)
    fn = tengine.build_fused_query_fn(tcfg, K, 200, mesh=mesh)
    params = tpar.replicate(tparams, mesh)
    toks, lens = _tokens(8)
    fn.replay(params, sidx.emb, toks, lens, 200, adopt=False)  # the first call adopts
    assert fn.cache.emb is sidx.emb and len(fn.cache.graphs) == 2
    sidx.delete(["t3"])  # row 199 moves to row 3: a copy of both blocks
    new = sidx.emb
    assert new is not fn.cache.emb
    got = fn.replay(params, new, toks, lens, 199, adopt=False)
    assert _same(got, fn.run(params, new, toks, lens, 199))
    assert fn.cache.emb is not new and len(fn.cache.graphs) == 2
    assert fn.stats.counts() == {"graph_captures": 2, "graph_replays": 0, "graph_eager": 1}
    fn.replay(params, new, toks, lens, 199)  # the engine's warmup adopts it
    assert fn.cache.emb is new and fn.stats.counts()["graph_captures"] == 4
    assert len(fn.cache.graphs) == 2
    assert len({c.pool for c in stand_in.made}) == 4  # new pools for the new graphs


@pytest.mark.parametrize("name", ["(1, 2)", "(2, 2) twice"])
def test_grid_engine_warmup_add_delete(model, stand_in, monkeypatch, name):
    """A grid engine that captures (as on cards): warmup captures every
    (tier, bucket) on every distinct device, an add captures nothing, a
    delete recaptures through its warmup only, and the engine answers as
    the one-device engine."""
    from sse_tpu_torch.text.subword import SubwordVocab

    _, tcfg, _, tparams = model
    monkeypatch.setattr(QueryEngine, "captures_graphs",  # the grid's engine, not the other
                        property(lambda self: self.mesh is not None))
    vocab = SubwordVocab(["a_", "b_", "c_"])
    engines = []
    for mesh in (_grid(name), None):
        rows = np.eye(6, 16, dtype=np.float32)
        ids = [f"d{i}" for i in range(6)]
        index = tindex.from_embeddings(rows, ids, list(ids), capacity=16, mesh=mesh,
                                       device="cpu")
        engines.append(QueryEngine(tparams, tcfg, vocab, index, max_seq_length=10,
                                   max_batch=2, k=3))
    grid, one = engines
    cards = len(grid.mesh.entries_by_device())
    shapes = len(grid._bucket_widths())
    grid.warmup()
    assert grid.graph_counts() == {"graph_captures": shapes * cards, "graph_replays": 0,
                                   "graph_eager": 0,
                                   "graphs_cached": shapes * cards}
    texts = ["a b", "c"]
    assert grid.query(texts) == one.query(texts)
    for e in engines:  # rows 6..9 cross the blocks' boundary at 8
        e.add_documents(["x", "y", "z", "w"], ["a", "b", "c", "a b c"])
    assert grid.graph_counts()["graph_captures"] == shapes * cards
    assert grid.query(texts) == one.query(texts)
    for e in engines:
        e.delete_documents(["d0", "y"])
    assert grid.graph_counts()["graph_captures"] == 2 * shapes * cards
    assert grid.graph_counts()["graphs_cached"] == shapes * cards
    assert grid.query(texts) == one.query(texts)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
def test_num_real_int_or_tensor_below_inside_and_past_a_block(model, stand_in, dtype):
    """(1, 4) of 64-row blocks: num_real below block 2's first row (100 <
    128), inside it (150) and past it (256), at block edges and 0: the
    int and the 0-d tensor give identical rows, eager and replayed, and
    the unsharded call's."""
    _, tcfg, _, tparams = model
    mesh = _grid("(1, 4)")
    sidx, uidx = _indexes(mesh, nr=256, dtype=dtype)
    fn = tengine.build_fused_query_fn(tcfg, K, 256, mesh=mesh)
    unsharded = tengine.build_fused_query_fn(tcfg, K, 256)
    params = tpar.replicate(tparams, mesh)
    toks, lens = _tokens(8)
    for nr in (0, 3, 63, 64, 100, 128, 150, 192, 256):
        as_tensor = torch.tensor(nr, dtype=torch.int32)
        want = unsharded(tparams, uidx.emb, toks, lens, nr)
        for got in (fn.run(params, sidx.emb, toks, lens, nr),
                    fn.run(params, sidx.emb, toks, lens, as_tensor),
                    fn.replay(params, sidx.emb, toks, lens, nr),
                    fn.replay(params, sidx.emb, toks, lens, as_tensor)):
            assert _same(got, want), nr
        if nr < K:
            assert (want[0][:, nr:] < -1e37).all()
    assert fn.stats.counts()["graph_captures"] == 4


# ------------------------------------------------------------------ vs JAX
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("shape,rows,batch", [((2, 4), 200, 8), ((8, 1), 60, 16)])
def test_grid_function_matches_jax(model, stand_in, shape, rows, batch, dtype):
    """The grid function (eager and replayed, over eight CPU labels)
    against JAX's ``build_fused_query_fn(mesh=...)`` on its eight fake
    devices, with the same params, index and tokens."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(rows)
    emb = _unit_rows(rows, seed=rows)
    ids = [f"t{i}" for i in range(rows)]
    jmesh = jpar.make_mesh(*shape)
    mesh = tpar.make_mesh(*shape, devices=_cpus(*range(8)))
    jidx = jindex.from_embeddings(emb, ids, ids, mesh=jmesh, dtype=_JD[dtype])
    tidx = tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], mesh=mesh)
    toks = rng.integers(2, 64, size=(batch, 10)).astype(np.int32)
    lens = rng.integers(3, 11, size=(batch,)).astype(np.int32)
    jv, ji = jax_fused_fn(jcfg, k=5, num_real=rows, mesh=jmesh, emb_dtype=_JD[dtype])(
        jparams, jidx.emb, jnp.asarray(toks), jnp.asarray(lens))
    fn = tengine.build_fused_query_fn(tcfg, k=5, num_real=rows, pallas_variant="exact",
                                      mesh=mesh)
    params = tpar.replicate(tparams, mesh)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(lens)
    eager = fn(params, tidx.emb, tt, tl)
    fn.replay(params, tidx.emb, tt, tl, rows)
    replayed = fn.replay(params, tidx.emb, tt, tl, rows)
    assert _same(replayed, eager) and fn.stats.counts()["graph_replays"] == 8
    ji, ti = np.asarray(ji), replayed[1].numpy()
    np.testing.assert_allclose(replayed[0].numpy(), np.asarray(jv), rtol=2e-4, atol=2e-5)
    q = tsse.encode_source(tparams, tcfg, tt, tl)
    full = tidx.emb[:].double()
    qq = torch.round(q * 127).double() if dtype == "int8" else q.double()
    scale = 1.0 / 127**2 if dtype == "int8" else 1.0
    for i, j in zip(*np.nonzero(ji != ti)):
        a, b = (float(qq[i] @ full[r]) * scale for r in (ji[i, j], ti[i, j]))
        assert abs(a - b) <= 1e-5, (i, j, a, b)
    assert (ji == ti).mean() > 0.9


# ------------------------------------------------------------- the build
def _tspace(t: int, seed: int = 5, length: int = 10):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, length + 1, size=(t,)).astype(np.int32)
    toks = rng.integers(2, 64, size=(t, length)).astype(np.int32)
    toks[np.arange(length)[None, :] >= lens[:, None]] = 0
    ids = [f"t{i}" for i in range(t)]
    return TargetSpace(ids=ids, texts=ids, tokens=toks, lengths=lens,
                       id_to_row={x: i for i, x in enumerate(ids)})


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape,t,chunk_batches", [((1, 2), 40, 2), ((1, 4), 70, 2),
                                                   ((2, 2), 33, 1), ((1, 4), 24, 64)])
def test_grid_build_matches_jax_and_the_one_device_build(model, stand_in, shape, t,
                                                         chunk_batches, dtype):
    """JAX's progress calls; rows within the towers' tolerance of JAX's
    mesh build; bit for bit the port's one-device build (reserve and
    tail-padding rows zero); one captured program a device that encodes
    a chunk, each later chunk there a replay."""
    jcfg, tcfg, jparams, tparams = model
    tspace = _tspace(t, seed=t)
    jmesh = jpar.make_mesh(*shape)
    mesh = tpar.make_mesh(*shape, devices=_cpus(*range(shape[0] * shape[1])))
    kw = dict(batch_size=8, chunk_batches=chunk_batches, capacity=t + 20)
    jcalls, tcalls = [], []
    jidx = jindex.build_index(jparams, jcfg, tspace, mesh=jmesh, dtype=_JD[dtype],
                              progress=lambda *a: jcalls.append(a), **kw)
    stats = graphs.GraphStats()
    grid = tindex.build_index(tparams, tcfg, tspace, mesh=mesh, dtype=_TD[dtype],
                              graph_stats=stats, progress=lambda *a: tcalls.append(a), **kw)
    one = tindex.build_index(tparams, tcfg, tspace, dtype=_TD[dtype], capture=False, **kw)
    assert tcalls == jcalls and tcalls[-1] == (t, t)
    rows = grid.emb[:]
    assert rows.shape == tuple(jidx.emb.shape) and grid.num_real == jidx.num_real == t
    assert torch.equal(rows[:t], one.emb[:t]) and not rows[t:].any()
    got, want = rows[:t].float().numpy(), np.asarray(jidx.emb[:t]).astype(np.float32)
    if dtype == "int8":  # one quantization step either way
        assert np.abs(got - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=2e-3 if dtype == "f32" else 1e-2,
                                   rtol=1e-3 if dtype == "f32" else 1e-2)
    chunk = chunk_batches * 8 if t >= chunk_batches * 8 else -(-t // 8) * 8
    t_local = grid.emb.rows_per_shard
    used = [mesh.column_devices(lo // t_local)[0] for lo in range(0, t, chunk)]
    assert [c.dev for c in stand_in.made] == list(dict.fromkeys(used))
    assert stats.counts() == {"graph_captures": len(set(used)),
                              "graph_replays": len(used) - len(set(used)), "graph_eager": 0}
