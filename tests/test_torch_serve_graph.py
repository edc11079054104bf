"""The serving program per shape, on the CPU: ``num_real`` as an int or as
a 0-d int32 tensor through the top-k wrappers and ``build_fused_query_fn``
(the two give identical rows and values, and both are held against the
JAX package), the graph cache's policy driven with a stand-in for the
CUDA capture (no card here), and the engine's add / delete / k growth
against the JAX engine, with its capture counters (0 on the CPU, where the
plain versions run eagerly).

Tolerances: the wrappers against the JAX Pallas kernels (interpret mode)
on exact-dot inputs: rows and values identical (int8, and the exact
variant) or values to rtol 2e-2 (packed float keys, as
tests/test_torch_ops_topk.py holds them). The fused function and the
engines run two encoders (the JAX and the port's, within 2e-3): a
differing row's scores lie within one 11-bit key bucket (2^-11 relative)
of each other, or within 1e-5 for the exact variant, as
tests/test_torch_serve.py holds them; served scores agree to 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.data import synthetic
from sse_tpu.data.corpus import encode_target_space
from sse_tpu.index import sharded_index as jindex
from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu.ops import fused_topk as jtopk
from sse_tpu.serve import engine as jengine
from sse_tpu.text.subword import SubwordVocab, token_counts_from_lines
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.index import sharded_index as tindex
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.ops import topk as ttopk
from sse_tpu_torch.serve import QueryEngine, engine as tengine

L = 12
NO_GRAPHS = {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0, "graphs_cached": 0}


@pytest.fixture(scope="module")
def setup():
    tr, ev, tg = synthetic.make_corpus(task="ranking", num_targets=24, train_per_target=4,
                                       seed=9)
    vocab = SubwordVocab.build_to_target_size(
        300, token_counts_from_lines([s for s, _ in tr] + [t for _, t in tg]))
    kw = dict(vocab_size=vocab.vocab_size, embed_dim=24, hidden=24, encoding_dim=16)
    jcfg = jsse.SSEConfig(mode=jsse.NetworkMode.SHARED_ENCODER,
                          src_tower=jtowers.TowerConfig(**kw))
    tcfg = tsse.SSEConfig(mode=tsse.NetworkMode.SHARED_ENCODER,
                          src_tower=ttowers.TowerConfig(**kw))
    jparams = jsse.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return vocab, jcfg, tcfg, jparams, tparams, ev, encode_target_space(vocab, tg, L)


def _nr(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _same(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _exact_dot(seed, b, d, t):
    """Multiples of 1/16: every float32 sum is exact in any order."""
    rng = np.random.default_rng(seed)
    grid = lambda n: (rng.integers(-16, 17, size=(n, d)) / 16.0).astype(np.float32)  # noqa: E731
    return grid(b), grid(t)


def _index(dtype, emb):
    """The same index rows for both packages: (jax array, torch tensor)."""
    if dtype == "int8":
        e = np.clip(np.round(emb * 127), -127, 127).astype(np.int8)
        return jnp.asarray(e), torch.from_numpy(e)
    if dtype == "bf16":
        return jnp.asarray(emb).astype(jnp.bfloat16), torch.from_numpy(emb).bfloat16()
    return jnp.asarray(emb), torch.from_numpy(emb)


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_wrappers_take_num_real_as_int_or_tensor(dtype, variant):
    b, d, t = 8, 32, 512
    q, emb = _exact_dot(31, b, d, t)
    if dtype == "int8":  # unit rows, quantized at scale 127 (the sums are exact integers)
        q, emb = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (q, emb))
    je, te = _index(dtype, emb)
    tq = torch.from_numpy(q)
    for nr in (0, 5, 300, t):
        as_int = ttopk.fused_score_topk(tq, te, 10, nr, variant)
        as_tensor = ttopk.fused_score_topk(tq, te, 10, _nr(nr), variant)
        assert _same(as_int, as_tensor), nr
        ref = jtopk.fused_score_topk(jnp.asarray(q), je, 10, nr, block_t=256, interpret=True,
                                     variant=variant)
        pv, pi = (x.numpy() for x in as_tensor)
        rv, ri = (np.asarray(x) for x in ref)
        real = min(nr, 10)
        np.testing.assert_array_equal(pi[:, :real], ri[:, :real])
        if variant == "exact" or dtype == "int8":
            np.testing.assert_array_equal(pv[:, :real], rv[:, :real])
        else:
            np.testing.assert_allclose(pv[:, :real], rv[:, :real], rtol=2e-2)
        assert (pv[:, real:] < -1e37).all()
        if variant == "packed":  # the two-phase route takes the same two forms
            tp_int = ttopk.fused_score_topk_twophase(tq, te, 10, nr, block_t=32)
            tp_tensor = ttopk.fused_score_topk_twophase(tq, te, 10, _nr(nr), block_t=32)
            assert _same(tp_int, tp_tensor) and _same(tp_tensor, as_int), nr


def test_num_real_tensor_is_checked_on_the_card_path():
    """A tensor num_real must be a 0-d int32 tensor on the index's device
    before any launch (the check runs without a card)."""
    emb = torch.zeros((64, 16))
    for bad in (torch.tensor([3], dtype=torch.int32), torch.tensor(3, dtype=torch.int64)):
        with pytest.raises(ValueError, match="num_real"):
            ttopk._num_real_on(bad, emb, "test")
    assert ttopk._num_real_on(_nr(3), emb, "test").item() == 3
    assert ttopk._num_real_on(100, emb, "test").item() == 64  # clamped to T
    assert ttopk._num_real_on(-4, emb, "test").item() == 0


def _held_rows(q, temb, ji, ti, exact: bool):
    """Rows of two encoders' queries: a differing row's two scores (exact,
    in float64 on the port's q) within one key bucket, or 1e-5 (exact)."""
    for i, j in zip(*np.nonzero(ji != ti)):
        a, b = (float(q[i] @ temb[r].double()) for r in (ji[i, j], ti[i, j]))
        tol = 1e-5 if exact else 2.0**-11 * max(abs(a), abs(b))
        assert abs(a - b) <= tol, (i, j, a, b)
    assert (ji == ti).mean() > 0.9


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_fused_fn_num_real_int_or_tensor_matches_jax(setup, dtype, variant):
    """build_fused_query_fn with num_real as an int and as a 0-d tensor:
    identical; and held against the JAX engine's build_fused_query_fn
    (use_pallas=False) on the same converted params, tokens and rows."""
    _, jcfg, tcfg, jparams, tparams, _, _ = setup
    rng = np.random.default_rng(6)
    emb = (rng.integers(-16, 17, size=(512, 16)) / 16.0).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    jemb = jindex.quantize_rows(emb, jd)
    temb = torch.from_numpy(np.asarray(jemb).astype(np.float32)).to(
        {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[dtype])
    toks = rng.integers(2, tcfg.src_tower.vocab_size, size=(8, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=(8,)).astype(np.int32)
    tt, tl = torch.from_numpy(toks), torch.from_numpy(lens)
    fused = tengine.build_fused_query_fn(tcfg, k=5, pallas_variant=variant)
    for nr in (3, 500):
        as_int = fused(tparams, temb, tt, tl, nr)
        as_tensor = fused(tparams, temb, tt, tl, _nr(nr))
        assert _same(as_int, as_tensor)
        jv, ji = jengine.build_fused_query_fn(jcfg, k=5, use_pallas=False, emb_dtype=jd,
                                              pallas_variant=variant)(
            jparams, jemb, jnp.asarray(toks), jnp.asarray(lens), nr)
        q = tsse.encode_source(tparams, tcfg, tt, tl)
        qq = torch.round(q * 127).double() / 127 if dtype == "int8" else q.to(temb.dtype).double()
        scale = 1.0 / 127 if dtype == "int8" else 1.0
        ji, ti = np.asarray(ji)[:, :min(nr, 5)], as_int[1].numpy()[:, :min(nr, 5)]
        _held_rows(qq, temb.double() * scale, ji, ti, variant == "exact")
        np.testing.assert_allclose(as_int[0].numpy()[:, :min(nr, 5)],
                                   np.asarray(jv)[:, :min(nr, 5)], atol=5e-3)
    assert fused.stats.counts() == {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0}


# ------------------------------------------------------- the graph cache
class _Graph:
    """A stand-in for QueryGraph: what it was captured with, and a replay
    that runs the eager path on the inputs it is given."""

    made = []

    def __init__(self, run, params, emb, tokens, lengths, nr, pool, side):
        self.run, self.params, self.emb, self.pool = run, params, emb, pool
        self.first = run(params, emb, tokens, lengths, nr)  # the warm-up
        self.seconds, self.mib = 0.25, 1.5
        _Graph.made.append(self)

    def take_first(self):
        out, self.first = self.first, None
        return out

    def __call__(self, tokens, lengths, nr):
        return self.run(self.params, self.emb, tokens, lengths, nr)


def test_graph_cache_policy(monkeypatch):
    """One graph a key over one emb; another emb drops them all; past
    MAX_GRAPHS the least recently used goes; a failing capture caches
    nothing and raises; the counters and readings follow."""
    monkeypatch.setattr(tengine, "MAX_GRAPHS", 3)
    stats = tengine.GraphStats()
    cache = tengine.GraphCache(stats)
    made = []

    def make():
        g = type("G", (), {"seconds": 0.1, "mib": 2.0})()
        made.append(g)
        return g

    a, b = torch.zeros(4), torch.zeros(4)
    g1 = cache.get(a, ((8, 8),), make)
    assert cache.get(a, ((8, 8),), make) is g1 and stats.captures == 1
    for w in (16, 32, 50):
        cache.get(a, ((8, w),), make)
    assert list(cache.graphs) == [((8, 16),), ((8, 32),), ((8, 50),)]  # (8, 8) was oldest
    cache.get(a, ((8, 16),), make)  # a hit moves to the back
    cache.get(a, ((8, 8),), make)
    assert list(cache.graphs) == [((8, 50),), ((8, 16),), ((8, 8),)] and stats.captures == 5
    cache.get(b, ((8, 8),), make)  # a new buffer: every graph of the old one goes
    assert list(cache.graphs) == [((8, 8),)] and cache.emb is b and stats.captures == 6

    def broken():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get(b, ((256, 8),), broken)
    assert list(cache.graphs) == [((8, 8),)] and stats.captures == 6
    assert stats.log[-1] == {"shape": (8, 8), "seconds": 0.1, "mib": 2.0}
    assert stats.counts() == {"graph_captures": 6, "graph_replays": 0, "graph_eager": 0}


def test_captured_query_keys_with_a_stand_in(setup, monkeypatch):
    """CapturedQuery.replay with the capture replaced by _Graph: a key is
    (tokens shape and type, lengths shape and type, the params' tensors);
    the same key replays the same graph, another shape or params captures
    (the capturing call returns its warm-up's result and counts no
    replay), another index buffer replaces the graphs in a fresh pool; the
    results are the eager path's. A call on CPU tensors runs eagerly and
    counts nothing."""
    _, _, tcfg, _, tparams, _, _ = setup
    pools = iter(range(100))
    monkeypatch.setattr(tengine, "QueryGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(pools))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "side")
    _Graph.made = []
    fused = tengine.build_fused_query_fn(tcfg, k=5, num_real=40)
    rng = np.random.default_rng(8)
    emb = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(2, 200, size=(4, 8)).astype(np.int32))
    lens = torch.full((4,), 8, dtype=torch.int32)
    want = fused.run(tparams, emb, toks, lens, 40)
    assert _same(fused(tparams, emb, toks, lens), want)  # CPU: eager
    assert fused.stats.counts() == {"graph_captures": 0, "graph_replays": 0, "graph_eager": 0}

    assert _same(fused.replay(tparams, emb, toks, lens, 40), want)
    assert _same(fused.replay(tparams, emb, toks, lens, _nr(40)), want)
    assert len(_Graph.made) == 1 and fused.stats.counts()["graph_replays"] == 1
    fused.replay(tparams, emb, toks[:, :4], lens, 40)  # another width
    fused.replay(tparams, emb, toks.long(), lens, 40)  # another type
    other = {k: v for k, v in tparams.items()}
    other["src_tower"] = {**tparams["src_tower"], "proj_b": tparams["src_tower"]["proj_b"] + 0}
    fused.replay(other, emb, toks, lens, 40)  # other params' tensors
    fused.replay(dict(tparams), emb, toks, lens, 40)  # the same tensors: a hit
    assert len(_Graph.made) == 4 and {g.pool for g in _Graph.made} == {0}
    new_emb = emb.clone()
    assert _same(fused.replay(tparams, new_emb, toks, lens, 40), want)
    assert len(fused.cache.graphs) == 1 and _Graph.made[-1].pool == 1
    assert fused.stats.counts() == {"graph_captures": 5, "graph_replays": 2, "graph_eager": 0}


# ------------------------------------------------------------ the engine
def _engines(setup):
    vocab, jcfg, tcfg, jparams, tparams, _, _ = setup
    rows = np.eye(3, 16, dtype=np.float32)
    ids, texts = ["a", "b", "c"], ["x", "y", "z"]
    jidx = jindex.from_embeddings(rows, ids, texts, capacity=16)
    tidx = tindex.from_embeddings(rows, list(ids), list(texts), capacity=16, device="cpu")
    jeng = jengine.QueryEngine(jparams, jcfg, vocab, jidx, max_seq_length=L, max_batch=2, k=5)
    teng = QueryEngine(tparams, tcfg, vocab, tidx, max_seq_length=L, max_batch=2, k=5)
    return jeng, teng


def _served_alike(jeng, teng, texts):
    for jh, th in zip(jeng.query(texts), teng.query(texts)):
        assert len(jh) == len(th)
        js, ts = [h["score"] for h in jh], [h["score"] for h in th]
        np.testing.assert_allclose(ts, js, atol=5e-3)
        for a, b, s in zip(jh, th, js):
            assert a["targetId"] == b["targetId"] or abs(
                s - next(h["score"] for h in jh if h["targetId"] == b["targetId"])) <= 5e-3


def test_engine_add_delete_and_k_growth_match_jax(setup):
    """The same index and params in both engines: k grows with the index,
    adds and deletes serve the same targets (within the two encoders'
    tolerance), and the port's engine captures nothing on the CPU."""
    ev = setup[5]
    jeng, teng = _engines(setup)
    texts = [s for s, _ in ev[:3]]
    assert jeng.k == teng.k == 3
    _served_alike(jeng, teng, texts)
    docs = (["d", "e", "f"], ["one two", "three four", "five"])
    assert jeng.add_documents(*docs) == teng.add_documents(*docs) == 6
    assert jeng.k == teng.k == 5
    _served_alike(jeng, teng, texts + ["one two"])
    assert teng.query(["one two"])[0][0]["targetId"] == "d"
    assert jeng.delete_documents(["d", "b"]) == teng.delete_documents(["d", "b"]) == 4
    assert jeng.index.ids[:4] == teng.index.ids[:4]
    _served_alike(jeng, teng, texts + ["one two"])
    assert teng.warmup() >= 0.0 and teng.last_warmup["captures"] == 0
    assert teng.graph_counts() == NO_GRAPHS and not teng.captures_graphs
