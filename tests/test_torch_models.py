"""Model parity: JAX params → ``sse_tpu_torch.convert`` → the port's
encoders equal the JAX ``encode_raw`` (lax.scan path on the CPU) within
atol 2e-3 / rtol 1e-3, the tolerance of tests/test_ops_rnn.py, for every
cell (GRU, LSTM, transformer, bag-of-subwords) and readout. Config
mirrors keep the JAX field names and defaults. The transformer's pieces
(LayerNorm, the position tables, RoPE, a pre-LN block) and the embedding
lookup's table gradient are held against the JAX functions of the same
name on the same float32 inputs."""

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


@pytest.mark.parametrize("cell,readout,pos_encoding", [
    pytest.param("gru", "final", "rope", id="gru-final"),
    pytest.param("lstm", "attention", "rope", id="lstm-attention"),
    ("transformer", "mean", "rope"), ("transformer", "attention", "learned"),
    ("bow", "attention", "rope"),
])
def test_init_params_layout_matches_jax(cell, readout, pos_encoding):
    """Seeded torch init has the JAX checkpoint layout (names, shapes, leaf
    order): the LSTM's 4-gate fused layers, the attention params, the
    transformer's blocks (with the learned position table) and the
    bag-of-subwords tower's flat dict included."""
    width = (dict(embed_dim=24, hidden=16) if cell in ("gru", "lstm")
             else dict(embed_dim=16, hidden=16))
    jm, tm = _model_pair(
        "dual-encoder", vocab_size=40, num_layers=2, encoding_dim=8, cell=cell,
        readout=readout, pos_encoding=pos_encoding, max_len=24, **width,
    )
    jp = jax.tree.map(np.asarray, jsse.init_params(jax.random.PRNGKey(0), jm))
    tp = tsse.init_params(tm, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [(jax.tree_util.keystr(p), v.shape) for p, v in jflat] == [
        (jax.tree_util.keystr(p), tuple(v.shape)) for p, v in tflat
    ]
    # the converter carries the same tree across unchanged
    back = params_from_jax(jp)
    assert [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(back)[0]] \
        == [jax.tree_util.keystr(p) for p, _ in jflat]


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


# ---------------------------------------------- transformer and bow towers
TOWER_CASES = [("transformer", pos, readout) for pos in ("rope", "learned", "sinusoid")
               for readout in ("mean", "attention")] + [("bow", "rope", "mean"),
                                                        ("bow", "rope", "attention")]


@pytest.mark.parametrize("cell,pos_encoding,readout", TOWER_CASES)
def test_transformer_and_bow_towers_match_jax(cell, pos_encoding, readout):
    """encode_source and target_embeddings of a dual-encoder of 2-block
    transformer towers (d=32, 2 heads, each position encoding) or
    bag-of-subwords towers, with the mean or the attention readout,
    against ``sse_tpu.models.sse``: atol 2e-3 / rtol 1e-3. Every batch
    holds a row of length 0 (uniform attention, finite) and one of
    length 1."""
    jm, tm = _model_pair(
        "dual-encoder", vocab_size=50, embed_dim=32, hidden=32, encoding_dim=16,
        cell=cell, readout=readout, pos_encoding=pos_encoding, num_layers=2, num_heads=2,
        max_len=16,
    )
    jp = jsse.init_params(jax.random.PRNGKey(len(pos_encoding) + len(readout)), jm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    for seed, side in ((1, "source"), (2, "target")):
        toks, lens = _tokens(seed + 7 * len(readout), l=12)
        lens[0], lens[1] = 0, 1
        jt, jl, tt, tl = (jnp.asarray(toks), jnp.asarray(lens),
                          torch.from_numpy(toks), torch.from_numpy(lens))
        if side == "source":
            want = jsse.encode_source(jp, jm, jt, jl)
            got = tsse.encode_source(tp, tm, tt, tl)
        else:
            want = jsse.target_embeddings(jp, jm, tokens=jt, lengths=jl)
            got = tsse.target_embeddings(tp, tm, tokens=tt, lengths=tl)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)


def test_layer_norm_matches_jax():
    """_layer_norm (biased variance, eps 1e-6) on the same float32 inputs,
    one of them a constant row where eps decides: 1e-6 relative."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3.0
    x[0, 0] = 0.25  # zero variance: the result is the bias
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    want = jtowers._layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = ttowers._layer_norm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


def test_position_tables_match_jax():
    """The sinusoid table bit for bit (numpy float64, stored float32);
    the RoPE cos/sin tables to 1e-6 (float32 powers and products)."""
    np.testing.assert_array_equal(ttowers._sinusoid_table(37, 16),
                                  jtowers._sinusoid_table(37, 16))
    pos = np.arange(23, dtype=np.int32)
    for hd, (c, s) in ((8, ttowers._rope_tables(torch.from_numpy(pos), 8)),
                       (16, ttowers._rope_tables(torch.from_numpy(pos), 16))):
        jc, js = jtowers._rope_tables(jnp.asarray(pos), hd)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


def test_rope_rotate_matches_jax():
    """_rope_rotate on the same head vectors and tables: 1e-6."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
    jc, js = jtowers._rope_tables(jnp.arange(7, dtype=jnp.int32), 8)
    want = jtowers._rope_rotate(jnp.asarray(x), jc, js)
    got = ttowers._rope_rotate(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                               torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("pos_encoding", ["rope", "learned", "sinusoid"])
def test_pre_ln_block_matches_jax(pos_encoding):
    """One pre-LN block and the final LN (``_transformer_encode`` with one
    block) on the same float32 embeddings, a length-0 and a length-1 row
    among them: atol 2e-3 / rtol 1e-3 (bf16-rounded operands, float32
    sums in another order)."""
    jcfg, tcfg = _tower_pair(vocab_size=10, embed_dim=32, hidden=32, num_layers=1,
                             num_heads=4, max_len=16, cell="transformer",
                             pos_encoding=pos_encoding)
    jp = jtowers.init_tower(jax.random.PRNGKey(5), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4, 9, 32)).astype(np.float32)
    valid = (np.arange(9)[None, :] < np.array([9, 0, 1, 5])[:, None]).astype(np.float32)
    want = jtowers._transformer_encode(jp, jcfg, jnp.asarray(x), jnp.asarray(valid))
    got = ttowers._transformer_encode(tp, tcfg, torch.from_numpy(x), torch.from_numpy(valid))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)


def _invariance_model(cell):
    _, tm = _model_pair("shared-encoder", vocab_size=64, embed_dim=24, hidden=24, num_layers=2,
                        encoding_dim=16, cell=cell, num_heads=4, max_len=32)
    params = tsse.init_params(tm, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    lens = torch.from_numpy(rng.integers(2, 13, 4).astype(np.int32))
    toks = torch.from_numpy(rng.integers(2, 64, (4, 12)).astype(np.int32))
    toks = torch.where(torch.arange(12)[None, :] < lens[:, None], toks, 0)
    return tm, params, toks, lens


@pytest.mark.parametrize("cell", ["transformer", "bow"])
def test_pad_width_invariance(cell):
    """Encoding at a wider all-padding width gives the same embeddings
    (tests/test_models.py's property, which the merged train pass and the
    corpus' pad trimming rely on), to that test's tolerances: 1e-5 for
    bow; 2e-2 for the transformer, whose masked keys add exact zeros to
    the softmax but whose float32 sums over another width may flip an
    activation's bf16 rounding (1.3e-3 measured here)."""
    tm, params, toks, lens = _invariance_model(cell)
    wide = torch.cat([toks, torch.zeros((4, 7), dtype=toks.dtype)], dim=1)
    np.testing.assert_allclose(tsse.encode_source(params, tm, wide, lens).numpy(),
                               tsse.encode_source(params, tm, toks, lens).numpy(),
                               atol=2e-2 if cell == "transformer" else 1e-5)


@pytest.mark.parametrize("cell", ["transformer", "bow"])
def test_padding_invariance(cell):
    """Tokens past each row's length do not affect the embedding (the
    widths are equal, so every sum runs in the same order: 1e-5)."""
    tm, params, toks, lens = _invariance_model(cell)
    garbage = torch.where(torch.arange(12)[None, :] < lens[:, None], toks, 63)
    np.testing.assert_allclose(tsse.encode_source(params, tm, garbage, lens).numpy(),
                               tsse.encode_source(params, tm, toks, lens).numpy(), atol=1e-5)


def test_learned_positions_past_max_len_raise():
    """A learned position table sliced past max_len raises (JAX fails on
    the shape there)."""
    _, tm = _model_pair("shared-encoder", vocab_size=20, embed_dim=16, hidden=16,
                        encoding_dim=8, cell="transformer", pos_encoding="learned", max_len=6)
    params = tsse.init_params(tm, torch.Generator().manual_seed(0), device="cpu")
    ok = tsse.encode_source(params, tm, torch.ones((2, 6), dtype=torch.int32),
                            torch.tensor([6, 2], dtype=torch.int32))
    assert ok.shape == (2, 8)
    with pytest.raises(ValueError, match="max_len"):
        tsse.encode_source(params, tm, torch.ones((2, 7), dtype=torch.int32),
                           torch.tensor([7, 2], dtype=torch.int32))


# ------------------------------------------------------ embedding gradient
@pytest.mark.parametrize("impl", ["take", "segment", "sort_segment", "onehot", "take_bf16",
                                  "spread8", "zero_debug"])
def test_embed_grad_matches_jax(impl):
    """The embedding table's gradient for each ``embed_grad`` value against
    JAX's (``jnp.take``'s for 'take', ``_embed_lookup``'s otherwise) on the
    same table, tokens (with repeats) and cotangent: 1e-6 relative to the
    largest entry, where only the float32 sums' order differs; 'take_bf16'
    sums in bfloat16, in another order than JAX's, so there four bf16
    ulps (2^-6) of the largest entry. The forward is the gather in every
    case."""
    rng = np.random.default_rng(14)
    table = rng.normal(size=(20, 8)).astype(np.float32)
    toks = rng.integers(0, 20, (6, 9)).astype(np.int32)
    dy = rng.normal(size=(6, 9, 8)).astype(np.float32)
    if impl == "take":
        lookup = lambda t: jnp.take(t, jnp.asarray(toks), axis=0)  # noqa: E731
    else:
        lookup = lambda t: jtowers._embed_lookup(t, jnp.asarray(toks), impl)  # noqa: E731
    out, vjp = jax.vjp(lookup, jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    t = torch.from_numpy(table).requires_grad_()
    got_out = ttowers._embed(t, torch.from_numpy(toks).long(), impl)
    np.testing.assert_array_equal(got_out.detach().numpy(), np.asarray(out))
    got_out.backward(torch.from_numpy(dy))
    scale = np.abs(want).max() if impl != "zero_debug" else 1.0
    tol = 2.0**-6 if impl == "take_bf16" else 1e-6
    np.testing.assert_allclose(t.grad.numpy(), want, atol=tol * scale, rtol=0)
    if impl == "zero_debug":
        assert not t.grad.any()


def test_embed_grad_presorted_cost_refuses_a_gradient():
    """'presorted_cost' (a JAX measurement whose cotangent is deliberately
    wrong) serves, but a gradient through it raises; an unknown value
    raises at init."""
    cfg = ttowers.TowerConfig(vocab_size=20, embed_dim=8, hidden=8, encoding_dim=4,
                              cell="bow", embed_grad="presorted_cost")
    params = ttowers.init_tower(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks, lens = torch.ones((2, 3), dtype=torch.int32), torch.tensor([3, 1], dtype=torch.int32)
    with torch.no_grad():
        assert ttowers.encode_raw(params, cfg, toks, lens).shape == (2, 4)
    params["embed"].requires_grad_()
    with pytest.raises(ValueError, match="presorted_cost"):
        ttowers.encode_raw(params, cfg, toks, lens)
    with pytest.raises(ValueError, match="embed_grad"):
        ttowers.init_tower(dataclasses.replace(cfg, embed_grad="dense"), device="cpu")


def test_converter_keeps_bf16_bits():
    x = jnp.asarray(np.linspace(-2, 2, 7, dtype=np.float32)).astype(jnp.bfloat16)
    t = array_from_jax(np.asarray(x))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_unported_towers_raise():
    """The errors that remain: an unknown cell, readout or pos_encoding,
    and a transformer or bag-of-subwords tower whose embed_dim is not its
    hidden, is a ValueError from the port's init, as from the JAX
    package's init (cell, pos_encoding, widths) or encode (readout)."""
    tiny = dict(vocab_size=10, embed_dim=16, encoding_dim=8)
    for kw, what in (({"cell": "conv"}, "cell"), ({"readout": "max"}, "readout"),
                     ({"cell": "transformer", "pos_encoding": "alibi"}, "pos_encoding"),
                     ({"cell": "transformer", "hidden": 24}, "embed_dim == hidden"),
                     ({"cell": "bow", "hidden": 24}, "embed_dim == hidden")):
        kw = {"hidden": 16, **kw}
        jcfg, tcfg = _tower_pair(**tiny, **kw)
        with pytest.raises(ValueError, match=what):
            ttowers.init_tower(tcfg, device="cpu")
        with pytest.raises(ValueError, match=what):
            toks = jnp.ones((2, 3), jnp.int32)
            jtowers.encode_raw(jtowers.init_tower(jax.random.PRNGKey(0), jcfg), jcfg, toks,
                               jnp.array([3, 1], jnp.int32))


def test_entry_points_default_to_the_card():
    """init_params, init_tower, init_train_state, train,
    from_embeddings, make_mesh and cp_mesh place their tensors on the card unless
    the caller asks for the CPU: where torch sees no card, leaving device
    out raises instead of running on the CPU."""
    from sse_tpu_torch.index import sharded_index as tindex
    from sse_tpu_torch.parallel import cp_mesh, make_mesh
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
        lambda: make_mesh(),
        lambda: make_mesh(1, 1),
        lambda: cp_mesh(2),
    ]
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
