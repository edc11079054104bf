"""Model parity: JAX params → ``sse_tpu_torch.convert`` → the port's
encoders equal the JAX ``encode_raw`` (lax.scan path on the CPU) within
atol 2e-3 / rtol 1e-3, the tolerance of tests/test_ops_rnn.py. Config
mirrors keep the JAX field names and defaults."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu_torch.convert import array_from_jax, params_from_jax
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers


def _tower_pair(**kw):
    return jtowers.TowerConfig(**kw), ttowers.TowerConfig(**kw)


def _model_pair(mode, num_targets=0, **kw):
    jt, tt = _tower_pair(**kw)
    jm = jsse.SSEConfig(
        mode=jsse.NetworkMode(mode), src_tower=jt,
        tgt_tower=jt if mode == "dual-encoder" else None, num_targets=num_targets,
    )
    tm = tsse.SSEConfig(
        mode=tsse.NetworkMode(mode), src_tower=tt,
        tgt_tower=tt if mode == "dual-encoder" else None, num_targets=num_targets,
    )
    return jm, tm


def _tokens(seed, b=8, l=12, vocab=50):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, vocab, size=(b, l)).astype(np.int32)
    lens = rng.integers(1, l + 1, size=(b,)).astype(np.int32)
    return toks, lens


def test_config_mirrors_match_jax():
    for jcls, tcls in ((jtowers.TowerConfig, ttowers.TowerConfig),
                       (jsse.SSEConfig, tsse.SSEConfig)):
        jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
        tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
        assert jf == tf
    assert [m.value for m in jsse.NetworkMode] == [m.value for m in tsse.NetworkMode]


@pytest.mark.parametrize(
    "num_layers,residual", [(1, False), (2, False), (2, True)]
)
def test_encode_source_matches_jax(num_layers, residual):
    jm, tm = _model_pair(
        "shared-encoder", vocab_size=50, embed_dim=32, hidden=32,
        num_layers=num_layers, encoding_dim=16, residual=residual,
    )
    jp = jsse.init_params(jax.random.PRNGKey(num_layers), jm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks, lens = _tokens(num_layers + 10 * residual)
    want = np.asarray(jsse.encode_source(jp, jm, jnp.asarray(toks), jnp.asarray(lens)))
    got = tsse.encode_source(tp, tm, torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_dual_encoder_target_side_matches_jax():
    jm, tm = _model_pair(
        "dual-encoder", vocab_size=50, embed_dim=16, hidden=16, encoding_dim=8
    )
    jp = jsse.init_params(jax.random.PRNGKey(7), jm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks, lens = _tokens(7)
    want = np.asarray(
        jsse.target_embeddings(jp, jm, tokens=jnp.asarray(toks), lengths=jnp.asarray(lens))
    )
    got = tsse.target_embeddings(
        tp, tm, tokens=torch.from_numpy(toks), lengths=torch.from_numpy(lens)
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-3)


def test_source_encoder_only_table_matches_jax():
    jm, tm = _model_pair(
        "source-encoder-only", num_targets=30, vocab_size=50, embed_dim=16,
        hidden=16, encoding_dim=8,
    )
    jp = jsse.init_params(jax.random.PRNGKey(8), jm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rows = np.array([3, 0, 29], np.int32)
    want = np.asarray(jsse.target_embeddings(jp, jm, rows=jnp.asarray(rows)))
    got = tsse.target_embeddings(tp, tm, rows=torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        tsse.encode_target(tp, tm, None, None)


def test_init_params_layout_matches_jax():
    """Seeded torch init has the JAX checkpoint layout (names, shapes)."""
    jm, tm = _model_pair(
        "dual-encoder", vocab_size=40, embed_dim=24, hidden=16, num_layers=2,
        encoding_dim=8,
    )
    jp = jax.tree.map(np.asarray, jsse.init_params(jax.random.PRNGKey(0), jm))
    tp = tsse.init_params(tm, torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [(jax.tree_util.keystr(p), v.shape) for p, v in jflat] == [
        (jax.tree_util.keystr(p), tuple(v.shape)) for p, v in tflat
    ]


def test_converter_keeps_bf16_bits():
    x = jnp.asarray(np.linspace(-2, 2, 7, dtype=np.float32)).astype(jnp.bfloat16)
    t = array_from_jax(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_unported_towers_raise():
    for kw in ({"cell": "lstm"}, {"readout": "mean"}):
        cfg = ttowers.TowerConfig(vocab_size=10, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttowers.init_tower(cfg)
