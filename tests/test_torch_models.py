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


@pytest.mark.parametrize("cell,readout", [("gru", "final"), ("lstm", "attention")])
def test_init_params_layout_matches_jax(cell, readout):
    """Seeded torch init has the JAX checkpoint layout (names, shapes),
    the LSTM's 4-gate fused layers and the attention params included."""
    jm, tm = _model_pair(
        "dual-encoder", vocab_size=40, embed_dim=24, hidden=16, num_layers=2,
        encoding_dim=8, cell=cell, readout=readout,
    )
    jp = jax.tree.map(np.asarray, jsse.init_params(jax.random.PRNGKey(0), jm))
    tp = tsse.init_params(tm, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [(jax.tree_util.keystr(p), v.shape) for p, v in jflat] == [
        (jax.tree_util.keystr(p), tuple(v.shape)) for p, v in tflat
    ]


@pytest.mark.parametrize(
    "cell,readout,num_layers",
    [("lstm", "final", 1), ("lstm", "mean", 1), ("lstm", "attention", 1),
     ("lstm", "attention", 3), ("gru", "attention", 2), ("gru", "mean", 1)],
)
def test_lstm_and_readouts_match_jax(cell, readout, num_layers):
    """encode_source and target_embeddings of a dual-encoder with the
    given cell and readout (3 layers: the residual ``compositional``
    stack) against ``sse_tpu.models.sse``, atol 2e-3 / rtol 1e-3."""
    jm, tm = _model_pair(
        "dual-encoder", vocab_size=50, embed_dim=32, hidden=32, encoding_dim=16,
        cell=cell, readout=readout, num_layers=num_layers, residual=num_layers > 1,
    )
    jp = jsse.init_params(jax.random.PRNGKey(num_layers + 3), jm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    for seed, side in ((1, "source"), (2, "target")):
        toks, lens = _tokens(seed + 10 * num_layers)
        lens[0] = 1  # a one-token row: the attention softmax over one step
        jt, jl, tt, tl = (jnp.asarray(toks), jnp.asarray(lens),
                          torch.from_numpy(toks), torch.from_numpy(lens))
        if side == "source":
            want = jsse.encode_source(jp, jm, jt, jl)
            got = tsse.encode_source(tp, tm, tt, tl)
        else:
            want = jsse.target_embeddings(jp, jm, tokens=jt, lengths=jl)
            got = tsse.target_embeddings(tp, tm, tokens=tt, lengths=tl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)


def test_readouts_match_jax_helpers():
    """The masked mean and the attention readout alone, on the same float32
    states (atol 1e-5 / rtol 1e-5: one bf16-operand product and fp32
    sums in another order)."""
    rng = np.random.default_rng(4)
    states = rng.normal(size=(5, 7, 16)).astype(np.float32)
    lens = np.array([7, 1, 3, 0, 5])
    valid = (np.arange(7)[None, :] < lens[:, None]).astype(np.float32)
    p = {"attn_w": rng.normal(size=(16, 16)).astype(np.float32) * 0.3,
         "attn_b": rng.normal(size=(16,)).astype(np.float32) * 0.1,
         "attn_v": rng.normal(size=(16,)).astype(np.float32)}
    res = rng.normal(size=(5, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    s_j, v_j = jnp.asarray(states), jnp.asarray(valid)
    s_t, v_t = torch.from_numpy(states), torch.from_numpy(valid)
    np.testing.assert_allclose(ttowers._masked_mean(s_t, v_t).numpy(),
                               np.asarray(jtowers._masked_mean(s_j, v_j)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        ttowers._attention_readout(tp, s_t, v_t, torch.from_numpy(res)).numpy(),
        np.asarray(jtowers._attention_readout(jp, s_j, v_j, jnp.asarray(res))),
        atol=1e-5, rtol=1e-5)


def test_converter_keeps_bf16_bits():
    x = jnp.asarray(np.linspace(-2, 2, 7, dtype=np.float32)).astype(jnp.bfloat16)
    t = array_from_jax(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_unported_towers_raise():
    for kw in ({"cell": "transformer"}, {"cell": "bow", "embed_dim": 16, "hidden": 16}):
        cfg = ttowers.TowerConfig(vocab_size=10, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttowers.init_tower(cfg)
    with pytest.raises(ValueError, match="readout"):
        ttowers.init_tower(ttowers.TowerConfig(vocab_size=10, readout="max"), device="cpu")


def test_entry_points_default_to_the_card():
    """init_params, init_tower, init_train_state, train and
    from_embeddings place their tensors on the card unless the caller asks
    for the CPU: where torch sees no card, leaving device out raises
    instead of running on the CPU."""
    from sse_tpu_torch.index import sharded_index as tindex
    from sse_tpu_torch.train import loop as tloop

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places the tensors there")
    _, tm = _model_pair("shared-encoder", vocab_size=20, embed_dim=16, hidden=16,
                        encoding_dim=8)
    calls = [
        lambda: tsse.init_params(tm, torch.Generator().manual_seed(0)),
        lambda: ttowers.init_tower(tm.src_tower),
        lambda: tloop.init_train_state(tm, tloop.TrainConfig()),
        lambda: tloop.train(tm, tloop.TrainConfig(), None, None),
        lambda: tindex.from_embeddings(np.eye(3, 8, dtype=np.float32), ["a", "b", "c"],
                                       ["x", "y", "z"]),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
