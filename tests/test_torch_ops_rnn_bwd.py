"""Layer backward parity, GRU and LSTM: the PyTorch port's plain backward (what
``rnn_layer_bwd`` and ``RNNLayer`` run on CPU tensors) against the JAX
package's fused Pallas backward in interpret mode, and autograd through
the port against ``jax.grad`` of the Pallas layer.

Tolerances (each test says which it uses):
- ``dxs`` is bf16: one bf16 ulp (rtol 2^-7, atol 1e-6). The two versions
  sum the same bf16 products in float32 in another order.
- ``dWx``, ``dWh``, ``db`` (float32): rtol 1e-4, atol 1e-5. The runs
  show at most ~1e-6 absolute on values up to ~10.
- Autograd through whole stacks: max |port - jax| / max |jax| < 3e-2 per
  gradient, the pin of tests/test_ops_rnn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.ops import pallas_rnn
from sse_tpu_torch.convert import array_from_jax
from sse_tpu_torch.ops import rnn

ULP = dict(atol=1e-6, rtol=2.0**-7)


def _inputs(seed, T, B, E, H, all_masked_rows=(), G=3):
    rng = np.random.default_rng(seed)
    wx = (rng.normal(size=(E, G * H)) * 0.05).astype(np.float32)
    wh = (rng.normal(size=(H, G * H)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(G * H,)) * 0.01).astype(np.float32)
    xs = rng.normal(size=(T, B, E)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)[:, None, :]
    mask[:, :, list(all_masked_rows)] = 0.0
    dys = rng.normal(size=(T, B, H)).astype(np.float32)
    dfin = rng.normal(size=(B, H)).astype(np.float32)
    return xs, mask, wx, wh, b, dys, dfin


@pytest.mark.parametrize("T,B,masked", [(6, 8, ()), (8, 16, (3, 7))])
def test_bwd_reference_matches_pallas(T, B, masked):
    """dxs to one bf16 ulp; dW, db to rtol 1e-4 / atol 1e-5."""
    E = H = 128  # the Pallas kernel's lane alignment
    xs, mask, wx, wh, b, dys, dfin = _inputs(T * B, T, B, E, H, masked)
    ys, _, _ = pallas_rnn._layer_fwd_pallas(
        jnp.asarray(xs), jnp.asarray(mask), jnp.asarray(wx), jnp.asarray(wh),
        jnp.asarray(b), "gru", interpret=True,
    )
    dys_b = jnp.asarray(dys).astype(jnp.bfloat16)
    want = pallas_rnn._layer_bwd_pallas(
        jnp.asarray(xs), ys, None, jnp.asarray(mask), jnp.asarray(wx), jnp.asarray(wh),
        jnp.asarray(b), dys_b, jnp.asarray(dfin), "gru", interpret=True,
    )
    got = rnn.rnn_layer_bwd(
        torch.from_numpy(xs).bfloat16(), array_from_jax(np.asarray(ys)),
        torch.from_numpy(mask), torch.from_numpy(wx), torch.from_numpy(wh),
        torch.from_numpy(b), array_from_jax(np.asarray(dys_b)), torch.from_numpy(dfin),
    )
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (T, B, E)
    np.testing.assert_allclose(
        got[0].float().numpy(), np.asarray(want[0], np.float32), **ULP
    )
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    # a row masked at every step gets no gradient into its inputs
    for r in masked:
        assert not got[0][:, r].float().abs().any()


def test_driven_chain_follows_the_drive():
    """gru_bwd_chain driven by its own dgates_b is bit-identical to the
    undriven chain; driven by a dgates_b changed at one step s, only the
    steps before s change (the drive enters dh after step s's rounding)."""
    T, B, E, H = 6, 5, 16, 16
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(7, T, B, E, H))
    xs, dys = xs.bfloat16(), dys.bfloat16()
    ys, _ = rnn.rnn_layer(xs, mask, wx, wh, b)
    h_prev = rnn._h_prev(ys)
    gates = rnn.layer_gates(xs, h_prev, wx, wh, b)
    dgb, db = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin)
    again, db_again = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin, drive=dgb)
    assert torch.equal(again, dgb) and torch.equal(db_again, db)
    s = 3
    drive = dgb.clone()
    drive[s] = (drive[s].float() * 1.5).bfloat16()
    moved, _ = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin, drive=drive)
    assert torch.equal(moved[s:], dgb[s:])
    assert not torch.equal(moved[:s], dgb[:s])
    want = rnn.rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys, dfin)
    assert all(torch.equal(g, w) for g, w in
               zip((*rnn.bwd_products(xs, h_prev, wx, dgb), db), want))


def _jax_stack_loss(xs, mask, layers, residual, cell="gru"):
    x, final = xs.astype(jnp.bfloat16), None
    for li, (wx, wh, b) in enumerate(layers):
        ys, fin = pallas_rnn.rnn_layer(x, mask, wx, wh, b, cell, True)
        if residual and li > 0:
            final, x = fin + x[-1].astype(jnp.float32), x + ys
        else:
            final, x = fin, ys
    # touch BOTH outputs so the dys and dfin paths are exercised
    return (final ** 2).sum() + (x.astype(jnp.float32) ** 3).sum()


def _torch_stack_loss(xs, mask, layers, residual, cell="gru"):
    x, final = xs.to(torch.bfloat16), None
    for li, (wx, wh, b) in enumerate(layers):
        ys, fin = rnn.RNNLayer.apply(x, mask, wx, wh, b, cell)
        if residual and li > 0:
            final, x = fin + x[-1].float(), x + ys
        else:
            final, x = fin, ys
    return (final ** 2).sum() + (x.float() ** 3).sum()


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_autograd_matches_jax_grad(num_layers, cell):
    """Gradients of a loss on ys and fin through 1 layer and through 2
    stacked layers with the identity residual: max |port - jax| /
    max |jax| < 3e-2 for dxs and every weight."""
    T, B, E = 6, 8, 128
    G = 3 if cell == "gru" else 4
    rng = np.random.default_rng(num_layers)
    xs, mask = _inputs(5, T, B, E, E)[:2]
    layers = [
        tuple(a.astype(np.float32) for a in (
            rng.normal(size=(E, G * E)) * 0.05,
            rng.normal(size=(E, G * E)) * 0.05,
            rng.normal(size=(G * E,)) * 0.01,
        ))
        for _ in range(num_layers)
    ]
    residual = num_layers > 1
    jm = jnp.asarray(mask)
    gj = jax.grad(lambda x, ls: _jax_stack_loss(x, jm, ls, residual, cell), (0, 1))(
        jnp.asarray(xs), [tuple(jnp.asarray(a) for a in l) for l in layers]
    )
    xt = torch.from_numpy(xs).requires_grad_(True)
    lt = [tuple(torch.from_numpy(a).requires_grad_(True) for a in l) for l in layers]
    before = dict(rnn.launches)
    _torch_stack_loss(xt, torch.from_numpy(mask), lt, residual, cell).backward()
    assert rnn.launches == before  # CPU tensors never reach a kernel
    pairs = [("dxs", xt.grad, gj[0])]
    for li, (tl, jl) in enumerate(zip(lt, gj[1])):
        pairs += [(f"l{li}.{n}", t.grad, j) for n, t, j in zip(("wx", "wh", "b"), tl, jl)]
    for name, g, want in pairs:
        assert g.dtype == torch.float32, name
        want = np.asarray(want, np.float64)
        rel = np.abs(g.double().numpy() - want).max() / (np.abs(want).max() + 1e-6)
        assert rel < 3e-2, (name, rel)


def test_weight_grads_are_float32_and_unrounded():
    """The bf16 cast sits inside RNNLayer: dWx comes back as the float32
    sum, not rounded to bf16 (the trap of casting outside the Function)."""
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(9, 4, 5, 16, 16))
    wx, wh, b = (t.requires_grad_(True) for t in (wx, wh, b))
    ys, fin = rnn.RNNLayer.apply(xs.bfloat16(), mask, wx, wh, b)
    (ys.float() * dys).sum().backward(retain_graph=True)
    want = rnn.rnn_layer_bwd_reference(
        xs.bfloat16(), ys, mask, wx.detach(), wh.detach(), b.detach(),
        dys.bfloat16(), torch.zeros_like(dfin),
    )
    assert wx.grad.dtype == torch.float32
    assert not torch.equal(wx.grad, wx.grad.bfloat16().float())
    torch.testing.assert_close(wx.grad, want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b.grad, want[3], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_layer_saves_one_fused_weight(monkeypatch, cell):
    """RNNLayer saves one transposed weight, bf16 [Wx;Wh]ᵀ, and hands that
    same tensor to the backward (whose gate recompute reads it), so the
    transpose is built once per layer forward."""
    G = 3 if cell == "gru" else 4
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(13, 4, 3, 16, 16, G=G))
    w = [t.clone().requires_grad_(True) for t in (wx, wh, b)]
    ys, fin = rnn.RNNLayer.apply(xs, mask, *w, cell)
    want = torch.cat([wx, wh]).t().bfloat16()
    saved = [t for t in ys.grad_fn.saved_tensors if t is not None and t.shape == want.shape]
    assert len(saved) == 1 and torch.equal(saved[0], want)
    seen = {}
    layer_bwd = rnn.rnn_layer_bwd

    def spy(*args, **kwargs):
        seen["wt"] = args[-1] if len(args) == 11 else kwargs.get("wt")
        return layer_bwd(*args, **kwargs)

    monkeypatch.setattr(rnn, "rnn_layer_bwd", spy)
    (ys.float() * dys).sum().add((fin * dfin).sum()).backward()
    assert seen["wt"] is not None and seen["wt"].data_ptr() == saved[0].data_ptr()


def test_fin_only_loss_gets_zero_dys():
    """A lone final-readout layer: autograd leaves dys undefined, which
    the backward takes as zeros."""
    xs, mask, wx, wh, b, _, dfin = (torch.from_numpy(a) for a in _inputs(4, 5, 3, 16, 16))
    x = xs.clone().requires_grad_(True)
    ys, fin = rnn.RNNLayer.apply(x, mask, wx, wh, b)
    (fin * dfin).sum().backward()
    want = rnn.rnn_layer_bwd_reference(
        xs.bfloat16(), ys, mask, wx, wh, b, torch.zeros_like(ys), dfin
    )
    assert x.grad.dtype == torch.float32  # cast back to the dtype xs came in
    torch.testing.assert_close(x.grad, want[0].float(), rtol=0, atol=0)


@pytest.mark.parametrize("T,B", [(0, 4), (5, 0)])
def test_empty_shapes_give_zero_grads(T, B):
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(1, max(T, 1), max(B, 1), 16, 16))
    xs, mask, dys, dfin = xs[:T, :B], mask[:T, :, :B], dys[:T, :B], dfin[:B]
    ys = torch.zeros((T, B, 16), dtype=torch.bfloat16)
    dxs, dwx, dwh, db = rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin)
    assert dxs.shape == (T, B, 16) and dwx.shape == (16, 48) and dwh.shape == (16, 48)
    assert not (dwx.any() or dwh.any() or db.any())


# ------------------------------------------------------------ LSTM
def _lstm_fwd_bwd_inputs(T, B, masked):
    E = H = 128  # the Pallas kernel's lane alignment
    xs, mask, wx, wh, b, dys, dfin = _inputs(T * B + 1, T, B, E, H, masked, G=4)
    ys, _, cs = pallas_rnn._layer_fwd_pallas(
        jnp.asarray(xs), jnp.asarray(mask), jnp.asarray(wx), jnp.asarray(wh),
        jnp.asarray(b), "lstm", interpret=True,
    )
    return xs, ys, cs, mask, wx, wh, b, jnp.asarray(dys).astype(jnp.bfloat16), dfin


@pytest.mark.parametrize("T,B,masked", [(6, 8, ()), (8, 16, (3, 7))])
def test_lstm_bwd_reference_matches_pallas(T, B, masked):
    """The plain LSTM backward against ``_layer_bwd_pallas(..., "lstm")``
    on the Pallas forward's own ys and cs. The two sum the same products
    in float32 in another order, so a dgates value at a bf16 rounding edge
    can round the other way, and the dh and dc chains carry that flip to
    every earlier step (at (6, 8) one such flip moves 14 of 6,144 dxs
    values, by at most 2.4e-3 of max-abs, and dWx by 7e-5 of max-abs; at
    (8, 16) none happens and everything agrees within 2e-7 of max-abs).
    Bounds: dxs at the first reverse step (t = T-1, before any chain) to
    one bf16 ulp; over all steps at most 1% of the values beyond one ulp
    and every value within 1e-2 of max-abs; dWx, dWh, db within 2e-4 of
    each one's max-abs."""
    xs, ys, cs, mask, wx, wh, b, dys_b, dfin = _lstm_fwd_bwd_inputs(T, B, masked)
    want = pallas_rnn._layer_bwd_pallas(
        jnp.asarray(xs), ys, cs, jnp.asarray(mask), jnp.asarray(wx), jnp.asarray(wh),
        jnp.asarray(b), dys_b, jnp.asarray(dfin), "lstm", interpret=True,
    )
    before = dict(rnn.launches)
    got = rnn.rnn_layer_bwd(
        torch.from_numpy(xs).bfloat16(), array_from_jax(np.asarray(ys)),
        torch.from_numpy(mask), torch.from_numpy(wx), torch.from_numpy(wh),
        torch.from_numpy(b), array_from_jax(np.asarray(dys_b)), torch.from_numpy(dfin),
        cs=array_from_jax(np.asarray(cs)), cell="lstm",
    )
    assert rnn.launches == before
    assert got[0].dtype == torch.bfloat16 and got[0].shape == xs.shape
    g0, w0 = got[0].float().numpy(), np.asarray(want[0], np.float32)
    np.testing.assert_allclose(g0[-1], w0[-1], **ULP)
    beyond_ulp = np.abs(g0 - w0) > ULP["atol"] + ULP["rtol"] * np.abs(w0)
    assert beyond_ulp.mean() <= 1e-2
    assert np.abs(g0 - w0).max() <= 1e-2 * np.abs(w0).max()
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 2e-4 * np.abs(w).max()
    for r in masked:
        assert not got[0][:, r].float().abs().any()


def test_lstm_driven_chain_follows_the_drive():
    """lstm_bwd_chain driven by its own dgates_b is bit-identical to the
    undriven chain; driven by a dgates_b changed at step s, only the steps
    before s change; gates + chain + products are rnn_layer_bwd_reference."""
    T, B, E, H = 6, 5, 16, 16
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(11, T, B, E, H, G=4))
    xs, dys = xs.bfloat16(), dys.bfloat16()
    ys, _, cs = rnn.rnn_layer_reference(xs, mask, wx, wh, b, "lstm")
    h_prev, c_prev = rnn._h_prev(ys), rnn._h_prev(cs)
    gates = rnn.layer_gates(xs, h_prev, wx, wh, b)
    dgb, db = rnn.lstm_bwd_chain(gates, c_prev, mask, wh, dys, dfin)
    again, db_again = rnn.lstm_bwd_chain(gates, c_prev, mask, wh, dys, dfin, drive=dgb)
    assert torch.equal(again, dgb) and torch.equal(db_again, db)
    s = 3
    drive = dgb.clone()
    drive[s] = (drive[s].float() * 1.5).bfloat16()
    moved, _ = rnn.lstm_bwd_chain(gates, c_prev, mask, wh, dys, dfin, drive=drive)
    assert torch.equal(moved[s:], dgb[s:])
    assert not torch.equal(moved[:s], dgb[:s])
    want = rnn.rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys, dfin, cs, "lstm")
    assert all(torch.equal(g, w) for g, w in
               zip((*rnn.bwd_products(xs, h_prev, wx, dgb), db), want))


def test_lstm_layer_saves_its_c_stream():
    """RNNLayer with cell="lstm" hands the forward's bf16 cs to the
    backward: the autograd gradients equal rnn_layer_bwd_reference on
    that cs bit for bit."""
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(12, 5, 4, 16, 16, G=4))
    x = xs.clone().requires_grad_(True)
    w = [t.clone().requires_grad_(True) for t in (wx, wh, b)]
    ys, fin = rnn.RNNLayer.apply(x, mask, *w, "lstm")
    (ys.float() * dys).sum().add((fin * dfin).sum()).backward()
    _, _, cs = rnn.rnn_layer_reference(xs, mask, wx, wh, b, "lstm")
    want = rnn.rnn_layer_bwd_reference(xs.bfloat16(), ys, mask, wx, wh, b,
                                       dys.bfloat16(), dfin, cs, "lstm")
    for g, wv in zip((x.grad, *(t.grad for t in w)), (want[0].float(), *want[1:])):
        torch.testing.assert_close(g, wv, rtol=0, atol=0)


def test_lstm_bwd_needs_cs():
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in _inputs(2, 3, 2, 16, 16, G=4))
    ys, _, _ = rnn.rnn_layer_reference(xs, mask, wx, wh, b, "lstm")
    with pytest.raises(ValueError, match="needs cs"):
        rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cell="lstm")


# ------------------------------------------------------------ the products' plan
# (T, B, E, H, G): the main path's towers (T=50, B = 128..4096), the GPU
# tests' ragged M (T·B = 1, 99, 105,650) and their other widths
PLAN_SHAPES = [
    (1, 1, 128, 128, 3), (3, 33, 128, 128, 4), (50, 2113, 128, 128, 3),
    (50, 128, 128, 128, 3), (50, 256, 128, 128, 4), (50, 384, 128, 128, 3),
    (50, 2304, 128, 128, 3), (50, 2304, 128, 128, 4), (50, 4096, 128, 128, 4),
    (20, 40, 16, 176, 3), (20, 40, 272, 96, 3), (20, 40, 64, 96, 4),
    (50, 2113, 128, 144, 4), (1, 8192, 16, 16, 3), (7, 65, 16, 16, 4),
]


@pytest.mark.parametrize("T,B,E,H,G", PLAN_SHAPES)
def test_dw_plan_slices_cover_the_rows(T, B, E, H, G):
    """Every slice is a whole number of 64-row stages, the slices cover the
    T·B rows exactly (none empty, none past the last but the ragged end),
    the count is within its cap, a slice within DW_MAX_ROWS rows unless
    the cap binds, and csrc/products.cuh's dw_slice_rows
    (⌈⌈M / splits⌉ / 64⌉·64) gives back the plan's rows a slice."""
    M = T * B
    splits, per = rnn.dw_plan(M, E, H, G * H)
    assert 1 <= splits <= rnn.DW_MAX_SPLITS
    assert per % rnn.DW_ROW_TILE == 0 and per > 0
    assert per <= rnn.DW_MAX_ROWS or splits == rnn.DW_MAX_SPLITS
    bounds = [(z * per, min(M, (z + 1) * per)) for z in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == M
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert -(-(-(-M // splits)) // 64) * 64 == per


def test_dw_plan_reads_shapes_only(monkeypatch):
    """The plan never asks the card: with every torch.cuda query broken it
    gives what it gave, and at the main path's shapes (E=H=128, T=50, B =
    128 to 2304) its slices times the output tiles fill the 132 SMs."""
    want = {s: rnn.dw_plan(s[0] * s[1], s[2], s[3], s[4] * s[3]) for s in PLAN_SHAPES}

    def refuse(*a, **k):
        raise AssertionError("dw_plan asked the card")

    for name in ("device_count", "get_device_properties", "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert {s: rnn.dw_plan(s[0] * s[1], s[2], s[3], s[4] * s[3]) for s in PLAN_SHAPES} == want
    for B in (128, 256, 384, 2304):
        for G in (3, 4):
            splits, _ = rnn.dw_plan(50 * B, 128, 128, G * 128)
            assert splits * 2 * G >= rnn.DW_BLOCKS, (B, G, splits)


@pytest.mark.parametrize("E,H", [(128, 128), (16, 176), (272, 96), (64, 96), (128, 144),
                                 (16, 16)])
def test_check_widths_takes_the_abi_widths(E, H):
    rnn.check_widths("lstm_bwd", E, H)


@pytest.mark.parametrize("E,H", [(8, 128), (128, 24), (0, 16), (16, 0), (136, 128)])
def test_check_widths_refuses_other_widths(E, H):
    with pytest.raises(ValueError, match="multiples of 16"):
        rnn.check_widths("gru_bwd", E, H)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_launch_wrappers_check_widths(monkeypatch, cell):
    """The CUDA wrappers refuse a width the kernels do not take before
    they build or launch anything (the device checks stubbed, so CPU
    tensors reach the width check)."""
    monkeypatch.setattr(rnn, "_check_args", lambda kernel, args: None)
    monkeypatch.setattr(rnn._build, "library", lambda: pytest.fail("library built"))
    G, T, B, E, H = rnn._GATES[cell], 2, 3, 24, 16
    xs = torch.zeros((T, B, E), dtype=torch.bfloat16)
    ys = torch.zeros((T, B, H), dtype=torch.bfloat16)
    wx = torch.zeros((E, G * H), dtype=torch.bfloat16)
    wh = torch.zeros((H, G * H), dtype=torch.bfloat16)
    b = torch.zeros((G * H,))
    mask = torch.ones((T, 1, B))
    with pytest.raises(ValueError, match="multiples of 16"):
        rnn._bwd_launch(cell, xs, ys, ys, mask, wx, wh, b, ys, torch.zeros((B, H)))
    if cell == "lstm":
        with pytest.raises(ValueError, match="multiples of 16"):
            rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
