"""GRU layer parity: the PyTorch port's plain version (what
``rnn_layer`` runs on CPU tensors) against the JAX package's fused
Pallas layer in interpret mode.

Tolerances: ``fin`` (float32) to atol 2e-3 / rtol 1e-3, the tolerance of
tests/test_ops_rnn.py; ``ys`` is bfloat16, so a float32 carry that
differs in its last bits by the order of the sums may round to the
neighbouring bf16 value: one bf16 ulp (rtol 2^-7) on top of atol 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.models import towers as jtowers
from sse_tpu.ops import pallas_rnn
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.ops import rnn


def _layer_inputs(seed, T, B, E, H):
    rng = np.random.default_rng(seed)
    wx = (rng.normal(size=(E, 3 * H)) * 0.05).astype(np.float32)
    wh = (rng.normal(size=(H, 3 * H)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(3 * H,)) * 0.01).astype(np.float32)
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
    args = [torch.from_numpy(a) for a in _layer_inputs(5, 3, 2, 16, 16)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rnn.rnn_layer(*args, cell="lstm")
