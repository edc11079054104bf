"""The served slice on the CPU: index build, fused query function, engine,
HTTP front end of the PyTorch port, held against the JAX package on the
same converted params; and the port's isolation from JAX.

Tolerances: index rows to atol 2e-3 / rtol 1e-3 (encoder tolerance,
tests/test_ops_rnn.py). Query rows from the same tokens: identical, or —
where the two encoders' last-bit differences move a score across an
11-bit key bucket — the two rows' scores lie within one bucket (2^-11
relative) of each other.
"""

import json
import socket
import subprocess
import sys
import urllib.error
import urllib.request

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
from sse_tpu.serve.engine import build_fused_query_fn as jax_fused_fn
from sse_tpu.text.subword import SubwordVocab, token_counts_from_lines
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.index import sharded_index as tindex
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.serve import QueryEngine, engine as tengine, serve_http

L = 12


@pytest.fixture(scope="module")
def setup():
    tr, ev, tg = synthetic.make_corpus(
        task="ranking", num_targets=24, train_per_target=4, seed=9
    )
    vocab = SubwordVocab.build_to_target_size(
        300, token_counts_from_lines([s for s, _ in tr] + [t for _, t in tg])
    )
    tspace = encode_target_space(vocab, tg, L)
    kw = dict(vocab_size=vocab.vocab_size, embed_dim=24, hidden=24, encoding_dim=16)
    jcfg = jsse.SSEConfig(
        mode=jsse.NetworkMode.SHARED_ENCODER, src_tower=jtowers.TowerConfig(**kw)
    )
    tcfg = tsse.SSEConfig(
        mode=tsse.NetworkMode.SHARED_ENCODER, src_tower=ttowers.TowerConfig(**kw)
    )
    jparams = jsse.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return vocab, tspace, jcfg, tcfg, jparams, tparams, ev


def _engine(setup, **kw):
    vocab, tspace, _, tcfg, _, tparams, _ = setup
    index = tindex.build_index(tparams, tcfg, tspace, batch_size=16, **kw)
    return QueryEngine(tparams, tcfg, vocab, index, max_seq_length=L, max_batch=4, k=5)


def test_build_index_matches_jax(setup):
    _, tspace, jcfg, tcfg, jparams, tparams, _ = setup
    jidx = jindex.build_index(jparams, jcfg, tspace, batch_size=16, capacity=40)
    tidx = tindex.build_index(tparams, tcfg, tspace, batch_size=16, capacity=40)
    assert tidx.emb.shape == jidx.emb.shape and tidx.num_real == jidx.num_real == 24
    np.testing.assert_allclose(tidx.emb.numpy(), np.asarray(jidx.emb), atol=2e-3, rtol=1e-3)
    assert not tidx.emb[24:].any()  # reserve rows are zero vectors
    assert tidx.ids == jidx.ids and tidx.texts == jidx.texts
    bidx = tindex.build_index(tparams, tcfg, tspace, batch_size=16, dtype=torch.bfloat16)
    assert bidx.emb.dtype == torch.bfloat16


def test_index_geometry_and_quantization_match_jax():
    for t, cap in ((1, None), (24, 40), (70000, None), (100, 1_249_280)):
        assert tindex._padded_rows(t, cap) == jindex._padded_rows(t, cap, 1)
    x = np.float32([[0.5 / 127, 1.5 / 127, -2.5 / 127, 1.0, -1.0, 0.01]])
    for dtype, jd in ((torch.int8, jnp.int8), (torch.bfloat16, jnp.bfloat16)):
        got = tindex.quantize_rows(torch.from_numpy(x), dtype).float().numpy()
        want = np.asarray(jindex.quantize_rows(x, jd), np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_fused_query_fn_matches_pallas(setup, dtype):
    """Same index array, same tokens: the port's fused function returns
    the rows of the JAX Pallas program (interpret mode)."""
    _, _, jcfg, tcfg, jparams, tparams, _ = setup
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(512, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.int8
    jemb = jindex.quantize_rows(emb, jd)
    temb = torch.from_numpy(np.asarray(jemb).astype(np.float32)).to(
        torch.bfloat16 if dtype == "bf16" else torch.int8
    )
    toks = rng.integers(2, tcfg.src_tower.vocab_size, size=(8, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=(8,)).astype(np.int32)
    jv, ji = jax_fused_fn(
        jcfg, k=5, num_real=500, use_pallas=True, interpret=True, emb_dtype=jd
    )(jparams, jemb, jnp.asarray(toks), jnp.asarray(lens))
    fused = tengine.build_fused_query_fn(tcfg, k=5, num_real=500)
    tv, ti = fused(tparams, temb, torch.from_numpy(toks), torch.from_numpy(lens))
    ji, ti = np.asarray(ji), ti.numpy()
    q = tsse.encode_source(tparams, tcfg, torch.from_numpy(toks), torch.from_numpy(lens))
    qq = q.bfloat16().double() if dtype == "bf16" else torch.round(q * 127).double()
    for i, j in zip(*np.nonzero(ji != ti)):
        a, b = (float(qq[i] @ temb[r].double()) for r in (ji[i, j], ti[i, j]))
        assert abs(a - b) <= 2.0**-11 * max(abs(a), abs(b)), (i, j, a, b)
    assert (ji == ti).mean() > 0.9


def test_twophase_route_equals_streaming(setup, monkeypatch):
    """Batches at the two-phase threshold take the two-phase path and
    return the streaming path's rows."""
    _, _, _, tcfg, _, tparams, _ = setup
    rng = np.random.default_rng(3)
    emb = torch.from_numpy(rng.normal(size=(1024, 16)).astype(np.float32)).bfloat16()
    toks = torch.from_numpy(rng.integers(2, tcfg.src_tower.vocab_size, size=(16, L)))
    lens = torch.full((16,), L)
    stream = tengine.build_fused_query_fn(tcfg, k=5, num_real=1000)(tparams, emb, toks, lens)
    calls = []
    real_tp = tengine.fused_score_topk_twophase
    monkeypatch.setattr(tengine, "TWOPHASE_MIN_BATCH", 16)
    monkeypatch.setattr(tengine, "twophase_block_t", lambda t, k: 64)
    monkeypatch.setattr(
        tengine, "fused_score_topk_twophase",
        lambda *a, **kw: calls.append(1) or real_tp(*a, **kw),
    )
    tp = tengine.build_fused_query_fn(tcfg, k=5, num_real=1000)(tparams, emb, toks, lens)
    assert calls and torch.equal(tp[1], stream[1]) and torch.equal(tp[0], stream[0])


def test_engine_query_add_delete(setup):
    eng = _engine(setup, capacity=40)
    _, tspace, _, tcfg, _, tparams, ev = setup
    res = eng.query([s for s, _ in ev[:6]])  # > max_batch: split dispatch
    assert len(res) == 6 and all(len(h) == 5 for h in res)
    for hits in res:
        assert all(eng.index.ids[h["row"]] == h["targetId"] for h in hits)
        assert [h["score"] for h in hits] == sorted((h["score"] for h in hits), reverse=True)
    assert eng.add_documents(["new1"], ["a brand new document"]) == 25
    hits = eng.query(["a brand new document"])[0]
    assert hits[0]["targetId"] == "new1"
    assert eng.delete_documents(["new1", tspace.ids[0]]) == 23
    assert not eng.index.emb[23:].any()
    ids = {h["targetId"] for hits in eng.query([s for s, _ in ev[:4]]) for h in hits}
    assert "new1" not in ids and tspace.ids[0] not in ids
    assert eng.warmup() >= 0.0


def test_engine_k_grows_with_the_index(setup):
    vocab, tspace, _, tcfg, _, tparams, _ = setup
    idx = tindex.from_embeddings(np.eye(3, 16, dtype=np.float32), ["a", "b", "c"],
                                 ["x", "y", "z"], capacity=16)
    eng = QueryEngine(tparams, tcfg, vocab, idx, max_seq_length=L, max_batch=2, k=5)
    assert eng.k == 3 and len(eng.query(["x"])[0]) == 3
    eng.add_documents(["d", "e", "f"], ["one", "two", "three"])
    assert eng.k == 5 and len(eng.query(["x"])[0]) == 5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_api(setup):
    eng = _engine(setup, capacity=40)
    ev = setup[6]
    server = serve_http(eng, port=_free_port(), block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _call(base + "/healthz") == (200, b'{"status": "ok"}')
        code, body = _call(base + "/api/query?keywords=" + urllib.request.quote(ev[0][0]))
        hits = json.loads(body)["results"]
        assert code == 200 and len(hits) == 5
        assert hits == eng.query([ev[0][0]])[0]
        code, body = _call(base + "/api/query", {"queries": [s for s, _ in ev[:9]]})
        assert code == 200 and len(json.loads(body)["results"]) == 9
        code, body = _call(base + "/api/add", [{"targetId": "n1", "targetText": "fresh words"}])
        assert code == 200 and json.loads(body)["num_targets"] == 25
        code, body = _call(base + "/api/delete", ["n1"])
        assert code == 200 and json.loads(body)["num_targets"] == 24
        assert _call(base + "/api/delete", ["missing"])[0] == 400
        assert _call(base + "/api/save", {})[0] == 501
        assert _call(base + "/api/query?keywords=")[0] == 400
        stats = json.loads(_call(base + "/api/stats")[1])
        assert stats["queries"] == 10 and stats["index_num_targets"] == 24
        assert b"sse_queries 10" in _call(base + "/metrics")[1]
    finally:
        server.shutdown()
        server.server_close()


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys, sse_tpu_torch\n"
        "for m in pkgutil.walk_packages(sse_tpu_torch.__path__, 'sse_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('sse_tpu_torch.')]))\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10
