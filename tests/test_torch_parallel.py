"""The port's sharded serving on the CPU (``sse_tpu_torch.parallel``, the
grid half of the index, the engine and the eval through the index), held
against the JAX package on its eight fake CPU devices (tests/conftest.py)
and against the port's own unsharded path. The port's grids repeat one
CPU device (``make_mesh(devices=[cpu] * 8)``).

Tolerances:
* ``distributed_topk``: rows exact, values within 2e-5 of JAX's;
* the sharded query against JAX's sharded query: JAX's mesh path selects
  with ``lax.top_k`` on full float32 scores, so it is held against the
  port's ``exact`` variant on float32 and int8 indexes: values within
  rtol 2e-4 / atol 2e-5 (tests/test_parallel.py), and as the two encoders
  differ in their last bits, a differing row only where its two scores lie
  within 1e-5 of each other, with at least 90% of rows equal
  (tests/test_torch_serve.py);
* the port's sharded query and engine against its unsharded ones: rows
  and values equal (every case here gives the sharded path the same
  query encodings as the unsharded one);
* index rows, ids, texts, ``valid_mask`` and ``lookup`` against JAX's:
  bit for bit (the rows added are exact unit vectors).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sse_tpu import parallel as jpar
from sse_tpu.index import sharded_index as jindex
from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu.parallel.topk import distributed_topk as jax_distributed_topk
from sse_tpu.serve.engine import build_fused_query_fn as jax_fused_fn
from sse_tpu_torch import parallel as tpar
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.index import sharded_index as tindex
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.ops import topk
from sse_tpu_torch.serve import engine as tengine

CPU = torch.device("cpu")
_JD = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TD = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _grid(data, model):
    return tpar.make_mesh(data, model, devices=[CPU] * 8)


def _unit_rows(n, d=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bits(x):
    """Raw bits of a host array or tensor (bf16 as int16)."""
    if torch.is_tensor(x):
        x = x.cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.fixture(scope="module")
def model():
    """The JAX package's GRU test model (tests/test_parallel.py) and its
    converted params."""
    jcfg = jsse.SSEConfig(
        mode=jsse.NetworkMode.SHARED_ENCODER,
        src_tower=jtowers.TowerConfig(vocab_size=64, embed_dim=16, hidden=16, encoding_dim=16),
    )
    tcfg = tsse.SSEConfig(
        mode=tsse.NetworkMode.SHARED_ENCODER,
        src_tower=ttowers.TowerConfig(vocab_size=64, embed_dim=16, hidden=16, encoding_dim=16),
    )
    jparams = jsse.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams))


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("shape", [(-1, 1), (-1, 4), (1, 8), (2, 4), (8, 1), (-1, 2), (2, 2),
                                   (-1, 3), (3, 3)])
def test_make_mesh_matches_jax(shape):
    """Shapes, the devices kept (the first data x model) and the refusals
    ((-1, 3): 8 not divisible by 3; (3, 3): 9 of 8 devices)."""
    try:
        jm = jpar.make_mesh(*shape)
    except ValueError:
        with pytest.raises(ValueError):
            _grid(*shape)
        return
    tm = _grid(*shape)
    assert tm.shape == dict(jm.shape)
    assert tm.devices.shape == jm.devices.shape and tm.local_devices == [CPU]
    assert not tm.multi_process and tm.ranks.sum() == 0


def test_mesh_of_distinct_devices_and_placement():
    """A grid keeps its devices in order; ``replicate`` copies the params
    once a distinct device; ``RowShards`` puts block s on the devices of
    column s and gathers row slices across blocks."""
    devs = [torch.device("cpu", i) for i in range(4)]  # distinct labels, one memory
    mesh = tpar.make_mesh(2, 2, devices=devs)
    assert mesh.devices.tolist() == [devs[:2], devs[2:]]
    assert mesh.column_devices(1) == [devs[1], devs[3]] and mesh.local_devices == devs
    reps = tpar.replicate({"w": torch.ones(2)}, mesh)
    assert list(reps) == devs and tpar.replicate(reps, mesh) is reps
    x = torch.arange(24.0).view(12, 2)
    rs = tpar.RowShards.from_tensor(x, mesh)
    assert rs.rows_per_shard == 6 and list(rs.blocks[0]) == [devs[0], devs[2]]
    assert torch.equal(rs[:], x) and torch.equal(rs[4:9], x[4:9]) and rs[5:5].shape == (0, 2)
    with pytest.raises(ValueError):
        tpar.RowShards.from_tensor(x[:11], mesh)


# ------------------------------------------------------------ distributed top-k
@pytest.mark.parametrize("k,t", [(1, 64), (5, 64), (32, 64), (1, 1000), (5, 1000), (32, 1000),
                                 (8, 16)])
def test_distributed_topk_matches_jax(k, t):
    """The exact merge of a column-sharded score matrix over eight shards,
    (8, 16): k above the shard's 2 rows."""
    t_pad = -(-t // 8) * 8
    scores = np.random.default_rng(t + k).normal(size=(4, t_pad)).astype(np.float32)
    jmesh = jpar.make_mesh(data=1, model=8)
    sharded = jax.device_put(jnp.asarray(scores), NamedSharding(jmesh, P(None, "model")))
    jv, ji = jax_distributed_topk(sharded, k, jmesh)
    tv, ti = tpar.distributed_topk(torch.from_numpy(scores), k, _grid(1, 8))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=2e-5)


def test_lift_keeps_empty_slots_empty():
    """Lifting by a shard's first row moves real rows only: an empty slot
    lifted would decode as a real-looking row."""
    from sse_tpu_torch.parallel.topk import lift

    comp = topk._composite(torch.tensor([5, 7]), torch.tensor([0, 3]))
    comp = torch.cat([comp, torch.tensor([topk._EMPTY])])
    lifted = lift(comp, 100)
    vals, rows = topk.decode(lifted[None], False, exact=True)
    assert rows.tolist() == [[100, 103, 0]] and lifted[2] == topk._EMPTY
    assert vals[0, 2] == np.float32(topk.NEG)


# -------------------------------------------------------- sharded query vs JAX
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("shape,rows,batch", [((2, 4), 200, 8), ((8, 1), 60, 16)])
def test_sharded_query_matches_jax(model, shape, rows, batch, dtype):
    """The port's sharded fused query (exact variant) against JAX's
    ``build_fused_query_fn(mesh=...)`` on the same mesh shape, params,
    index and tokens: {data: 2, model: 4} (56 rows a shard) and
    {data: 8, model: 1} (64 rows)."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(rows)
    emb = _unit_rows(rows, seed=rows)
    ids = [f"t{i}" for i in range(rows)]
    jmesh = jpar.make_mesh(*shape)
    jidx = jindex.from_embeddings(emb, ids, ids, mesh=jmesh, dtype=_JD[dtype])
    tidx = tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], mesh=_grid(*shape))
    assert tidx.padded_size == jidx.padded_size
    toks = rng.integers(2, 64, size=(batch, 10)).astype(np.int32)
    lens = rng.integers(3, 11, size=(batch,)).astype(np.int32)
    jv, ji = jax_fused_fn(jcfg, k=5, num_real=rows, mesh=jmesh, emb_dtype=_JD[dtype])(
        jparams, jidx.emb, jnp.asarray(toks), jnp.asarray(lens))
    fused = tengine.build_fused_query_fn(tcfg, k=5, num_real=rows, pallas_variant="exact",
                                         mesh=tidx.mesh)
    tv, ti = fused(tparams, tidx.emb, torch.from_numpy(toks), torch.from_numpy(lens))
    ji, ti = np.asarray(ji), ti.numpy()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-4, atol=2e-5)
    q = tsse.encode_source(tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(lens))
    full = tidx.emb[:].double()
    qq = torch.round(q * 127).double() if dtype == "int8" else q.double()
    scale = 1.0 / 127**2 if dtype == "int8" else 1.0
    for i, j in zip(*np.nonzero(ji != ti)):
        a, b = (float(qq[i] @ full[r]) * scale for r in (ji[i, j], ti[i, j]))
        assert abs(a - b) <= 1e-5, (i, j, a, b)
    assert (ji == ti).mean() > 0.9


# ------------------------------------------- sharded against the port's unsharded
K = 4


@pytest.fixture
def spy_twophase(monkeypatch):
    """Two-phase blocks of 16 rows, so that a 64-row shard takes the
    two-phase route (its plain version on the CPU); counts the engine's
    two-phase calls."""
    monkeypatch.setattr(topk, "TWOPHASE_BLOCK_T", 16)
    calls = []
    real = tengine.fused_score_topk_twophase

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tengine, "fused_score_topk_twophase", counted)
    return calls


@pytest.mark.parametrize("nr", [2, 40, 128, 200])  # below k, inside shard 0, a boundary, across
@pytest.mark.parametrize("batch", [8, 1024])
@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_sharded_query_matches_unsharded(model, spy_twophase, shape, dtype, variant, batch, nr):
    """Rows and values of the sharded fused query == the unsharded one on
    a 256-row index (64 rows a shard on (1, 4)). The route follows the
    replica's batch: (1, 4) at B=1024 (packed) runs the two-phase route on
    each of its 4 shards; (2, 2) serves 512 queries a replica and streams."""
    _, tcfg, _, tparams = model
    rng = np.random.default_rng(nr + batch)
    emb = _unit_rows(nr, seed=nr)
    ids = [f"t{i}" for i in range(nr)]
    mesh = _grid(*shape)
    sidx = tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], capacity=256, mesh=mesh)
    uidx = tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], capacity=256, device="cpu")
    assert sidx.padded_size == uidx.padded_size == 256
    toks = torch.from_numpy(rng.integers(2, 64, size=(batch, 8)).astype(np.int32))
    lens = torch.from_numpy(rng.integers(1, 9, size=(batch,)).astype(np.int32))
    sv, sr = tengine.build_fused_query_fn(tcfg, K, nr, variant, mesh=mesh)(
        tparams, sidx.emb, toks, lens)
    n_sharded = len(spy_twophase)
    uv, ur = tengine.build_fused_query_fn(tcfg, K, nr, variant)(tparams, uidx.emb, toks, lens)
    assert torch.equal(sr, ur) and torch.equal(sv, uv)
    local = batch // shape[0]
    want = shape[1] if variant == "packed" and local >= topk.TWOPHASE_MIN_BATCH else 0
    assert n_sharded == want and all(b == local for b in spy_twophase[:n_sharded])
    if nr < K:
        assert (sr[:, nr:] == 0).all() and (sv[:, nr:] < -1e37).all()


# ------------------------------------------------------------- index vs JAX
def _sign_rows(n, seed):
    """Exact unit rows (±0.25 in 16 columns), so both packages normalize
    them to the same bits."""
    s = np.random.default_rng(seed).choice([-0.25, 0.25], size=(n, 16)).astype(np.float32)
    return s


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_add_delete_valid_mask_lookup_match_jax(dtype):
    """On a (1, 4) grid, 16 rows a shard: 20 rows, an add of 15 that
    crosses the shard boundary at row 32, then deletes that move rows
    between shards; rows, ids, texts, num_real, valid_mask and lookup ==
    JAX's sharded index after each step."""
    emb = _unit_rows(20, seed=3)
    ids = [f"d{i}" for i in range(20)]
    jidx = jindex.from_embeddings(emb, ids, ids, mesh=jpar.make_mesh(1, 4), dtype=_JD[dtype],
                                  capacity=64)
    tidx = tindex.from_embeddings(emb, ids, ids, dtype=_TD[dtype], capacity=64, mesh=_grid(1, 4))
    new = [f"n{i}" for i in range(15)]
    steps = [("add", _sign_rows(15, 4), new), ("delete", ["d1", "n14", "d17", "n2", "n13"]),
             ("delete", ["d0"]), ("add", _sign_rows(3, 5), ["x", "y", "z"])]
    for step in steps:
        if step[0] == "add":
            jidx.add(step[1], step[2], [t.upper() for t in step[2]])
            tidx.add(step[1], step[2], [t.upper() for t in step[2]])
        else:
            assert jidx.delete(step[1]) == tidx.delete(step[1])
        assert tidx.num_real == jidx.num_real and tidx.ids == jidx.ids
        assert tidx.texts == jidx.texts
        np.testing.assert_array_equal(_bits(tidx.emb[:]), _bits(jax.device_get(jidx.emb)))
        np.testing.assert_array_equal(tidx.valid_mask().numpy(), np.asarray(jidx.valid_mask()))
        rows = [0, 15, 16, tidx.num_real - 1]
        assert tidx.lookup(rows) == jidx.lookup(rows)
        assert tidx.pub[0] is tidx.emb and tidx.pub[1] == tidx.num_real


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_index_files_cross_packages(tmp_path, direction, dtype):
    """A 4-shard index saved by one package (one ``emb_r*.npy`` a shard)
    loads in the other, onto a grid, with equal rows, ids and texts."""
    emb = _unit_rows(50, seed=6)
    ids = [f"d{i}" for i in range(50)]
    texts = [f"text\t{i}\n" for i in range(50)]
    if direction == "jax_to_port":
        src = jindex.from_embeddings(emb, ids, texts, mesh=jpar.make_mesh(1, 4),
                                     dtype=_JD[dtype])
        src.save(str(tmp_path))
        want = _bits(jax.device_get(src.emb))
        got = tindex.ShardedIndex.load(str(tmp_path), _grid(2, 4))
        assert got.mesh.shape == {"data": 2, "model": 4}
        rows = _bits(got.emb[:])
    else:
        src = tindex.from_embeddings(emb, ids, texts, dtype=_TD[dtype], mesh=_grid(1, 4))
        src.save(str(tmp_path))
        want = _bits(src.emb[:])
        got = jindex.ShardedIndex.load(str(tmp_path), jpar.make_mesh(1, 4))
        rows = _bits(jax.device_get(got.emb))
    side = json.loads((tmp_path / "sidecar.json").read_text())
    assert [s["row0"] for s in side["shards"]] == [0, 16, 32, 48]
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("emb_")) == [
        s["file"] for s in side["shards"]]
    np.testing.assert_array_equal(rows, want)
    assert got.num_real == 50 and got.ids == ids and got.texts == texts


# ------------------------------------------------------------------ engine
def _corpus():
    from sse_tpu_torch.data import synthetic
    from sse_tpu_torch.data.corpus import build_vocab, encode_pairs, encode_target_space

    train, ev, targets = synthetic.make_corpus(task="ranking", num_targets=40,
                                               train_per_target=2, eval_per_target=2, seed=3)
    vocab = build_vocab(300, train, targets)
    tspace = encode_target_space(vocab, targets, 10)
    return vocab, tspace, encode_pairs(vocab, ev, tspace, 10), ev


@pytest.fixture(scope="module")
def served():
    vocab, tspace, pairs, ev = _corpus()
    cfg = tsse.SSEConfig(
        mode=tsse.NetworkMode.DUAL_ENCODER,
        src_tower=ttowers.TowerConfig(vocab_size=vocab.vocab_size, embed_dim=16, hidden=16,
                                      encoding_dim=16),
        tgt_tower=ttowers.TowerConfig(vocab_size=vocab.vocab_size, embed_dim=16, hidden=16,
                                      encoding_dim=16),
    )
    params = tsse.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return vocab, tspace, pairs, ev, cfg, params


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 2)])
def test_build_index_and_eval_on_a_grid(served, shape):
    """``build_index(mesh=)`` writes the unsharded index's rows into the
    grid's blocks, and ``evaluate_against_index`` through it gives the
    unsharded recall."""
    from sse_tpu_torch.evals import evaluate_against_index

    _, tspace, pairs, _, cfg, params = served
    mesh = _grid(*shape)
    sidx = tindex.build_index(params, cfg, tspace, batch_size=16, capacity=64, mesh=mesh)
    uidx = tindex.build_index(params, cfg, tspace, batch_size=16, capacity=64)
    assert sidx.mesh is mesh and torch.equal(sidx.emb[:], uidx.emb)
    got = evaluate_against_index(params, cfg, pairs, sidx, ks=(1, 5), batch_size=16)
    assert got == evaluate_against_index(params, cfg, pairs, uidx, ks=(1, 5), batch_size=16)


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_engine_on_a_grid_matches_one_device(served, shape, variant):
    """QueryEngine over a grid index answers as over one device: queries,
    then an add across a shard boundary and deletes that move rows across
    shards, each followed by the next query."""
    from sse_tpu_torch.serve import QueryEngine

    vocab, tspace, _, ev, cfg, params = served
    texts = [s for s, _ in ev[:12]]
    engines = []
    for mesh in (_grid(*shape), None):
        index = tindex.build_index(params, cfg, tspace, batch_size=16, capacity=64, mesh=mesh)
        engines.append(QueryEngine(params, cfg, vocab, index, max_seq_length=10, max_batch=8,
                                   k=5, pallas_variant=variant))
    sharded, single = engines
    assert isinstance(sharded.params, tpar.Replicated) and list(sharded.params) == [CPU]
    assert sharded.warmup() >= 0
    assert sharded.query(texts) == single.query(texts)
    added = [f"new{i}" for i in range(10)]  # rows 40..49 cross the boundary at 48 (1, 4)
    for e in engines:
        assert e.add_documents(added, [f"doc {i} of {t}" for i, t in enumerate(texts[:10])]) == 50
    assert sharded.query(texts) == single.query(texts)
    gone = [tspace.ids[0], "new9", tspace.ids[20], "new3"]
    assert sharded.delete_documents(gone) == single.delete_documents(gone) == 46
    assert sharded.query(texts) == single.query(texts)
    assert torch.equal(sharded.index.emb[:], single.index.emb)


def test_distributed_is_a_no_op_for_one_process():
    """``initialize`` does nothing for one process and wants every address
    part for more; ``process_info`` has the JAX package's keys."""
    from sse_tpu.parallel import distributed as jdist

    from sse_tpu_torch.parallel import distributed

    distributed.initialize("127.0.0.1:1", 1, 0)
    assert distributed.world_size() == 1 and distributed.backend() is None
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize(None, 2, 0)
    assert set(distributed.process_info()) == set(jdist.process_info())
    assert distributed.process_info()["process_count"] == 1
