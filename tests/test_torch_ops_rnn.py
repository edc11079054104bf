"""Recurrent layer forward parity, GRU and LSTM: the PyTorch port's
plain versions (what ``rnn_layer``, ``scan_layer`` and ``rnn_encode`` run
on CPU tensors) against the JAX package's Pallas kernels in interpret
mode (``_layer_fwd_pallas``, ``scan_layer``, ``rnn_encode``).

Tolerances: ``fin`` (float32) to atol 2e-3 / rtol 1e-3, the tolerance of
tests/test_ops_rnn.py; ``ys`` and the LSTM's ``cs`` are bfloat16, so a
float32 carry that differs in its last bits by the order of the sums may
round to the neighbouring bf16 value: one bf16 ulp (rtol 2^-7) on top of
atol 2e-3. The cells alone: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.models import towers as jtowers
from sse_tpu.ops import pallas_rnn
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.ops import rnn

FIN = dict(atol=2e-3, rtol=1e-3)
BF16 = dict(atol=2e-3, rtol=2.0**-7)


def _layer_inputs(seed, T, B, E, H, G=3):
    rng = np.random.default_rng(seed)
    wx = (rng.normal(size=(E, G * H)) * 0.05).astype(np.float32)
    wh = (rng.normal(size=(H, G * H)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(G * H,)) * 0.01).astype(np.float32)
    xs = rng.normal(size=(T, B, E)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)[:, None, :]
    return xs, mask, wx, wh, b


@pytest.mark.parametrize("T,B", [(7, 8), (8, 16)])
def test_rnn_layer_matches_pallas(T, B):
    E = H = 128  # the Pallas kernel's lane alignment
    args = _layer_inputs(T + B, T, B, E, H)
    ys_j, fin_j = pallas_rnn.rnn_layer(*(jnp.asarray(a) for a in args), "gru", True)
    ys_t, fin_t = rnn.rnn_layer(*(torch.from_numpy(a) for a in args))
    assert ys_t.dtype == torch.bfloat16 and ys_t.shape == (T, B, H)
    np.testing.assert_allclose(fin_t.numpy(), np.asarray(fin_j), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(
        ys_t.float().numpy(), np.asarray(ys_j, np.float32), atol=2e-3, rtol=2.0**-7
    )


@pytest.mark.parametrize("T,B", [(7, 8), (8, 16)])
def test_rnn_layer_function_matches_pallas(T, B):
    """The GRU layer through ``RNNLayer`` (what the towers call: it builds
    the fused weight and saves it) against ``_layer_fwd_pallas`` in
    interpret mode, to the same bounds as ``rnn_layer``."""
    E = H = 128
    args = _layer_inputs(2 * T + B, T, B, E, H)
    ys_j, fin_j, _ = pallas_rnn._layer_fwd_pallas(*(jnp.asarray(a) for a in args), "gru",
                                                  interpret=True)
    xs, mask, wx, wh, b = (torch.from_numpy(a) for a in args)
    ys_t, fin_t = rnn.RNNLayer.apply(xs, mask, wx.requires_grad_(True), wh, b)
    np.testing.assert_allclose(fin_t.detach().numpy(), _np(fin_j), **FIN)
    np.testing.assert_allclose(ys_t.detach().float().numpy(), _np(ys_j), **BF16)


def test_fused_weight_layout():
    """[Wx;Wh]ᵀ, the weight the GRU forward kernel copies into shared
    memory row by row: row n is column n of Wx followed by column n of Wh."""
    E, H = 16, 32
    rng = np.random.default_rng(11)
    wx = torch.from_numpy(rng.normal(size=(E, 3 * H)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(size=(H, 3 * H)).astype(np.float32))
    wt = rnn.fused_weight_t(wx, wh)
    assert wt.shape == (3 * H, E + H) and wt.is_contiguous()
    assert torch.equal(wt, torch.cat([wx, wh]).t())
    for n in (0, 7, 3 * H - 1):
        assert torch.equal(wt[n, :E], wx[:, n]) and torch.equal(wt[n, E:], wh[:, n])


@pytest.mark.parametrize("cell,G", [("gru", 3), ("lstm", 4)])
def test_rnn_layer_hands_the_fused_weight_to_the_forward(monkeypatch, cell, G):
    """RNNLayer hands the layer forward (on the card, the GRU kernel, or
    the LSTM's x-product and scan) the bf16 [Wx;Wh]ᵀ of the weights it
    casts: torch.cat([wx, wh]).t()."""
    seen = {}
    layer_fwd = rnn._layer_fwd

    def spy(xs, mask, wx, wh, b, cell, wt=None):
        seen.update(wx=wx, wh=wh, wt=wt, cell=cell)
        return layer_fwd(xs, mask, wx, wh, b, cell, wt)

    monkeypatch.setattr(rnn, "_layer_fwd", spy)
    xs, mask, wx, wh, b = (torch.from_numpy(a) for a in _layer_inputs(12, 4, 3, 16, 16, G))
    rnn.RNNLayer.apply(xs, mask, wx, wh, b, cell)
    assert seen["cell"] == cell and seen["wt"].shape == (G * 16, 32)
    assert seen["wt"].dtype == torch.bfloat16 and seen["wt"].is_contiguous()
    assert torch.equal(seen["wt"], torch.cat([seen["wx"], seen["wh"]]).t())
    assert torch.equal(seen["wt"], torch.cat([wx, wh]).t().bfloat16())


def test_rnn_layer_cpu_runs_the_plain_version():
    args = [torch.from_numpy(a) for a in _layer_inputs(3, 5, 4, 16, 16)]
    before = dict(rnn.launches)
    ys, fin = rnn.rnn_layer(*args)
    rys, rfin = rnn.rnn_layer_reference(*args)
    assert torch.equal(ys, rys) and torch.equal(fin, rfin)
    assert rnn.launches == before


def test_padding_steps_freeze_the_carry():
    """Past a row's length its state stays put, so fin is the state at
    each row's own length (the final-state readout needs no gather)."""
    xs, mask, wx, wh, b = (torch.from_numpy(a) for a in _layer_inputs(4, 6, 5, 16, 16))
    ys, fin = rnn.rnn_layer(xs, mask, wx, wh, b)
    lens = mask[:, 0].sum(0).long()
    for i, n in enumerate(lens.tolist()):
        assert torch.equal(ys[n - 1, i], ys[-1, i])
        assert torch.equal(fin[i].bfloat16(), ys[-1, i])


def test_gru_cell_matches_jax():
    rng = np.random.default_rng(6)
    gates = rng.normal(size=(4, 3 * 24)).astype(np.float32) * 3
    h = rng.normal(size=(4, 24)).astype(np.float32)
    np.testing.assert_allclose(
        ttowers.gru_cell(torch.from_numpy(gates), torch.from_numpy(h)).numpy(),
        np.asarray(jtowers.gru_cell(jnp.asarray(gates), jnp.asarray(h))),
        atol=1e-6, rtol=1e-6,
    )


def test_other_cells_are_not_ported():
    """The transformer and bag-of-subwords towers build, and need
    embed_dim == hidden (a ValueError, as in JAX); an unknown cell name is
    an error at the tower and at the layer."""
    for cell in ("transformer", "bow"):
        params = ttowers.init_tower(ttowers.TowerConfig(vocab_size=10, cell=cell), device="cpu")
        assert "layers" not in params and ("blocks" in params) == (cell == "transformer")
        with pytest.raises(ValueError, match="embed_dim == hidden"):
            ttowers.init_tower(ttowers.TowerConfig(vocab_size=10, cell=cell, embed_dim=64),
                               device="cpu")
    with pytest.raises(ValueError, match="unknown cell"):
        ttowers.init_tower(ttowers.TowerConfig(vocab_size=10, cell="rnn"), device="cpu")
    args = [torch.from_numpy(a) for a in _layer_inputs(5, 3, 2, 16, 16)]
    with pytest.raises(ValueError, match="unknown recurrent cell"):
        rnn.rnn_layer(*args, cell="rnn")


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("T,B", [(7, 8), (8, 16)])
def test_lstm_layer_matches_pallas(T, B):
    """ys, fin and cs of the plain LSTM layer against ``_layer_fwd_pallas``
    (fin to FIN, ys and cs to one bf16 ulp on top of it)."""
    E = H = 128
    args = _layer_inputs(T * B, T, B, E, H, G=4)
    ys_j, fin_j, cs_j = pallas_rnn._layer_fwd_pallas(
        *(jnp.asarray(a) for a in args), "lstm", interpret=True
    )
    ys_t, fin_t, cs_t = rnn.rnn_layer_reference(*(torch.from_numpy(a) for a in args), "lstm")
    assert ys_t.dtype == cs_t.dtype == torch.bfloat16 and cs_t.shape == (T, B, H)
    np.testing.assert_allclose(fin_t.numpy(), _np(fin_j), **FIN)
    np.testing.assert_allclose(ys_t.float().numpy(), _np(ys_j), **BF16)
    np.testing.assert_allclose(cs_t.float().numpy(), _np(cs_j), **BF16)
    # rnn_layer (what RNNLayer runs) is the same plain version on the CPU
    ys2, fin2 = rnn.rnn_layer(*(torch.from_numpy(a) for a in args), cell="lstm")
    assert torch.equal(ys2, ys_t) and torch.equal(fin2, fin_t)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_layer_matches_pallas(cell):
    """Kernel 1's plain version against ``pallas_rnn.scan_layer`` on the
    same precomputed ax (fin to FIN, ys to one bf16 ulp)."""
    T, B, H = 6, 8, 128
    G = 3 if cell == "gru" else 4
    rng = np.random.default_rng(G)
    ax = rng.normal(size=(T, B, G * H)).astype(np.float32)
    wh = (rng.normal(size=(H, G * H)) * 0.05).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)[:, None, :]
    ys_j, fin_j = pallas_rnn.scan_layer(
        jnp.asarray(ax), jnp.asarray(mask), jnp.asarray(wh), cell, interpret=True
    )
    before = dict(rnn.launches)
    ys_t, fin_t = rnn.scan_layer(torch.from_numpy(ax), torch.from_numpy(mask),
                                 torch.from_numpy(wh), cell)
    assert rnn.launches == before
    np.testing.assert_allclose(fin_t.numpy(), _np(fin_j), **FIN)
    np.testing.assert_allclose(ys_t.float().numpy(), _np(ys_j), **BF16)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_rnn_encode_matches_pallas(cell, num_layers):
    """The forward-only encode (x-product + scan per layer, residual
    between stacked layers) against ``pallas_rnn.rnn_encode`` (FIN)."""
    B, L = 8, 8
    jcfg = jtowers.TowerConfig(vocab_size=50, embed_dim=128, hidden=128, encoding_dim=16,
                               cell=cell, num_layers=num_layers, residual=num_layers > 1)
    tcfg = ttowers.TowerConfig(**dataclasses.asdict(jcfg))
    params = jtowers.init_tower(jax.random.PRNGKey(num_layers), jcfg)
    rng = np.random.default_rng(num_layers)
    emb = rng.normal(size=(B, L, 128)).astype(np.float32)
    lens = rng.integers(1, L + 1, B)
    valid = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    want = pallas_rnn.rnn_encode(params, jcfg, jnp.asarray(emb), jnp.asarray(valid),
                                 interpret=True)
    got = rnn.rnn_encode(params_from_jax(jax.tree.map(np.asarray, params)), tcfg,
                         torch.from_numpy(emb), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), _np(want), **FIN)


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(7)
    gates = rng.normal(size=(4, 4 * 24)).astype(np.float32) * 3
    h, c = (rng.normal(size=(4, 24)).astype(np.float32) for _ in range(2))
    got = rnn.lstm_cell(*(torch.from_numpy(a) for a in (gates, h, c)))
    want = jtowers.lstm_cell(*(jnp.asarray(a) for a in (gates, h, c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_lstm_padding_steps_freeze_both_carries():
    """Past a row's length neither h nor c moves, so fin and cs[-1] are
    the row's values at its own length."""
    xs, mask, wx, wh, b = (torch.from_numpy(a) for a in _layer_inputs(8, 6, 5, 16, 16, G=4))
    ys, fin, cs = rnn.rnn_layer_reference(xs, mask, wx, wh, b, "lstm")
    lens = mask[:, 0].sum(0).long()
    for i, n in enumerate(lens.tolist()):
        assert torch.equal(ys[n - 1, i], ys[-1, i]) and torch.equal(cs[n - 1, i], cs[-1, i])
        assert torch.equal(fin[i].bfloat16(), ys[-1, i])
