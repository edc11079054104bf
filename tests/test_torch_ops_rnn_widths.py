"""Every recurrent width the JAX package trains, on the port's CPU route and
on the route the card takes.

- ``layer_plan``: the instances and padded widths it picks, the widths it
  refuses, and that it reads the shapes only.
- Zero-padding is exact: the plain layer on ``pad_layer``'s operands, cut
  back, equals the plain layer at the layer's widths to 1e-6 (bf16
  outputs: the same values, one bf16 ulp where a float32 sum taken over
  the longer padded row lands on the other side of a rounding edge), and
  every padded unit's outputs and gradients are exactly 0.
- The card's route on the CPU: the wrappers with ``_on_card`` forced and
  the launches replaced by their plain versions receive the plan's padded
  widths and cluster sizes, and cut back what the plain route computes.
- Against JAX: at H=256 the Pallas layer in interpret mode (JAX runs it
  there on a TPU), at H=100 and 176 ``towers._rnn_layer`` (lax.scan, what
  JAX runs at widths Pallas does not take), and whole towers at hidden 256
  through ``encode_raw``. Tolerances as tests/test_torch_ops_rnn.py
  states them: fin atol 2e-3 / rtol 1e-3; bf16 ys one ulp on top (rtol
  2^-7); gradients max |port - jax| / max |jax| < 3e-2 (whole layers, as
  tests/test_ops_rnn.py pins them; the precision policy's ~1e-2 relative
  for a bf16 chain).
"""

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
GRAD = 3e-2


def _inputs(seed, T, B, E, H, G, scale=0.05):
    rng = np.random.default_rng(seed)
    wx = (rng.normal(size=(E, G * H)) * scale).astype(np.float32)
    wh = (rng.normal(size=(H, G * H)) * scale).astype(np.float32)
    b = (rng.normal(size=(G * H,)) * 0.01).astype(np.float32)
    xs = rng.normal(size=(T, B, E)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)[:, None, :]
    mask[:, :, 1] = 0.0  # a row masked at every step
    dys = rng.normal(size=(T, B, H)).astype(np.float32)
    dfin = rng.normal(size=(B, H)).astype(np.float32)
    return xs, mask, wx, wh, b, dys, dfin


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


# ------------------------------------------------------------ the plan
# (cell, E, H) → (E_p, H_p, forward route, scan C, dh C)
PLANS = [
    ("gru", 128, 128, (128, 128, "fused", 1, 1)),  # the fixed instances
    ("lstm", 128, 128, (128, 128, "split", 1, 1)),
    ("gru", 256, 128, (256, 128, "split", 1, 1)),  # [Wx;Wh]ᵀ needs 305,408 B
    ("gru", 128, 144, (128, 144, "split", 1, 1)),  # ... 246,784 B
    ("gru", 16, 176, (16, 176, "fused", 1, 1)),
    ("lstm", 128, 176, (128, 192, "split", 2, 2)),
    ("gru", 256, 256, (256, 256, "split", 2, 4)),
    ("lstm", 256, 256, (256, 256, "split", 4, 4)),
    ("gru", 384, 384, (384, 384, "split", 8, 8)),
    ("lstm", 384, 384, (384, 384, "split", 8, 8)),
    ("gru", 100, 100, (112, 112, "fused", 1, 1)),
    ("lstm", 100, 100, (112, 112, "split", 1, 1)),
    ("lstm", 300, 160, (304, 160, "split", 1, 2)),
]


@pytest.mark.parametrize("cell,E,H,want", PLANS)
def test_layer_plan_picks(cell, E, H, want):
    plan = rnn.layer_plan(cell, E, H)
    assert (plan.E_p, plan.H_p, plan.fwd, plan.scan_cluster, plan.dh_cluster) == want
    G = 3 if cell == "gru" else 4
    for kind, C in (("scan", plan.scan_cluster), ("dh", plan.dh_cluster)):
        smem = rnn.scan_smem if kind == "scan" else rnn.dh_smem
        assert plan.H_p % (16 * C) == 0 and smem(G, plan.H_p, C) <= 232_448
        # the smallest cluster that holds it
        assert all(smem(G, plan.H_p, c) > 232_448 or plan.H_p % (16 * c)
                   for c in rnn.CLUSTERS if c < C)
    if plan.fwd == "fused":
        assert rnn.gru_fwd_smem(plan.E_p, plan.H_p) <= 232_448


def test_layouts_give_the_sources_figures():
    """The mirrors at the widths whose bytes the kernels' sources and the
    old refusals name."""
    assert rnn.scan_smem(4, 176) == 270_848  # LSTM scan, one block
    assert rnn.gru_fwd_smem(128, 144) == 246_784
    assert rnn.gru_fwd_smem(256, 128) == 305_408
    assert rnn.dh_smem(3, 256) == 455_808
    assert rnn.dh_smem(4, 160) == 254_400
    assert rnn.scan_smem(3, 256, 2) - 2 * 8 * 264 * 2 == 202_752  # the Whᵀ rows
    assert rnn.scan_smem(4, 256, 4) - 2 * 8 * 264 * 2 - 2 * 8 * 72 * 2 == 135_168


@pytest.mark.parametrize("cell,H", [("gru", 400), ("lstm", 512), ("lstm", 1000)])
def test_layer_plan_refuses_beyond_its_reach(cell, H):
    assert rnn.widest_hidden(cell) == 384
    with pytest.raises(ValueError, match="widest hidden width they take is 384"):
        rnn.layer_plan(cell, 128, H)


def test_layer_plan_reads_shapes_only(monkeypatch):
    shapes = [(c, e, h) for c, e, h, _ in PLANS]
    want = {s: rnn.layer_plan.__wrapped__(*s) for s in shapes}

    def refuse(*a, **k):
        raise AssertionError("layer_plan asked the card")

    for name in ("device_count", "get_device_properties", "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(rnn._build, "library", refuse)
    assert {s: rnn.layer_plan.__wrapped__(*s) for s in shapes} == want


# ------------------------------------------------------------ exact padding
@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("E,H,E_p,H_p", [(20, 24, 32, 32), (36, 40, 48, 64)])
def test_zero_padding_is_exact(cell, E, H, E_p, H_p):
    G = 3 if cell == "gru" else 4
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in
                                      _inputs(E + H, 5, 8, E, H, G, scale=0.2))
    want = rnn.rnn_layer_reference(xs, mask, wx, wh, b, cell)
    xs_p, wx_p, wh_p, b_p = rnn.pad_layer(xs, wx, wh, b, G, E_p, H_p)
    assert wx_p.shape == (E_p, G * H_p) and wh_p.shape == (H_p, G * H_p)
    got = rnn.rnn_layer_reference(xs_p, mask, wx_p, wh_p, b_p, cell)
    for g, w in zip(got, want):
        assert not g[..., H:].float().any()  # padded units stay exactly 0
        torch.testing.assert_close(g[..., :H].float(), w.float(), atol=1e-6,
                                   rtol=1e-6 if g.dtype == torch.float32 else 2.0**-7)
    cs, cs_p = (want[2], got[2]) if cell == "lstm" else (None, None)
    grads = rnn.rnn_layer_bwd_reference(xs, want[0], mask, wx, wh, b, dys, dfin, cs, cell)
    grads_p = rnn.rnn_layer_bwd_reference(
        xs_p, got[0], mask, wx_p, wh_p, b_p, rnn.pad_units(dys, H_p), rnn.pad_units(dfin, H_p),
        cs_p, cell)
    dxs_p, dwx_p, dwh_p, db_p = grads_p
    assert not dxs_p[..., E:].float().any() and not dwx_p[E:].any() and not dwh_p[H:].any()
    for t in (dwx_p, dwh_p, db_p):
        assert not t.reshape(-1, G, H_p)[..., H:].any()
    for g, w in zip(rnn.unpad_grads(*grads_p, G, E, H), grads):
        assert g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=1e-6,
                                   rtol=1e-6 if g.dtype == torch.float32 else 2.0**-7)


def test_pad_gates_round_trip():
    t = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 15)
    p = rnn.pad_gates(t, 3, 8)
    assert p.shape == (2, 24)
    assert torch.equal(p.reshape(2, 3, 8)[..., :5], t.reshape(2, 3, 5))
    assert not p.reshape(2, 3, 8)[..., 5:].any()
    assert torch.equal(rnn.unpad_gates(p, 3, 5), t)
    assert rnn.pad_gates(t, 3, 5) is t and rnn.pad_units(t, 15) is t


# ------------------------------------------------------------ the card's route
class _Card:
    """The CUDA route of ``ops.rnn`` on CPU tensors: ``_on_card`` forced,
    each launch wrapper replaced by its plain version after checking the
    widths the plan promised it (multiples of 16, H of 16·C)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(rnn, "_on_card", lambda t: True)
        monkeypatch.setattr(rnn, "gru_fwd_launch", self.gru_fwd)
        monkeypatch.setattr(rnn, "rnn_fwd_launch", self.rnn_fwd)
        monkeypatch.setattr(rnn, "rnn_scan_launch", self.scan)
        monkeypatch.setattr(rnn, "_bwd_launch", self.bwd)

    def _widths(self, name, E, H, C):
        assert E % 16 == 0 and H % (16 * C) == 0, (name, E, H, C)
        self.calls.append((name, E, H, C))

    def gru_fwd(self, xs, mask, wx, wh, b, wt=None):
        self._widths("gru_fwd", xs.shape[2], wh.shape[0], 1)
        assert wt is None or torch.equal(wt, rnn.fused_weight_t(wx, wh))
        return rnn.rnn_layer_reference(xs, mask, wx, wh, b, "gru")

    def rnn_fwd(self, xs, mask, wx, wh, b, cell="lstm", wt=None, cluster=None):
        self._widths("rnn_fwd", xs.shape[2], wh.shape[0], cluster)
        ax = rnn._x_product(xs, wx, b)
        return (*rnn._scan_reference(ax, mask, wh, cell), ax)

    def scan(self, ax, mask, wh, cell="gru", cluster=None):
        self._widths("rnn_scan", wh.shape[0], wh.shape[0], cluster)
        return rnn.scan_layer_reference(ax, mask, wh, cell)

    def bwd(self, cell, xs, ys, cs, mask, wx, wh, b, dys, dfin, wt=None, cluster=None):
        self._widths("bwd", xs.shape[2], wh.shape[0], cluster)
        assert ys.shape[2] == dys.shape[2] == dfin.shape[1] == wh.shape[0]
        return (*rnn.rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell),
                None, None)


@pytest.mark.parametrize("cell,E,H", [("gru", 100, 100), ("gru", 40, 144), ("lstm", 40, 176),
                                      ("gru", 24, 256), ("lstm", 24, 256),
                                      ("gru", 256, 128)])
def test_card_route_pads_and_cuts_back(monkeypatch, cell, E, H):
    """RNNLayer forward and backward, rnn_layer, rnn_layer_bwd and
    scan_layer on the card's route equal the plain route at the layer's
    widths, with the plan's widths and clusters: outputs to 1e-6 (bf16 one
    ulp), gradients to 1e-3 of each one's max-abs. CPU products over a
    longer padded row sum in another order, and a bf16 dgates value at a
    rounding edge then goes the other way; a misplaced gate column would
    miss by the whole value."""
    G = 3 if cell == "gru" else 4
    arrays = _inputs(H, 3, 8, E, H, G, scale=0.2)
    xs, mask, wx, wh, b, dys, dfin = (torch.from_numpy(a) for a in arrays)
    close = dict(atol=1e-6, rtol=2.0**-7)
    plain = [t.clone().requires_grad_(True) for t in (xs, wx, wh, b)]
    ys_w, fin_w = rnn.RNNLayer.apply(plain[0], mask, *plain[1:], cell)
    ((ys_w.float() * dys).sum() + (fin_w * dfin).sum()).backward()
    want_fwd = rnn.rnn_layer(xs, mask, wx, wh, b, cell)
    want_scan = rnn.scan_layer(rnn._x_product(xs, wx, b), mask, wh, cell)
    ref = rnn.rnn_layer_reference(xs, mask, wx, wh, b, cell)
    cs = ref[2] if cell == "lstm" else None
    want_bwd = rnn.rnn_layer_bwd(xs.bfloat16(), ys_w.detach(), mask, wx, wh, b,
                                 dys.bfloat16(), dfin, cs, cell)

    card = _Card(monkeypatch)
    plan = rnn.layer_plan(cell, E, H)
    on = [t.clone().requires_grad_(True) for t in (xs, wx, wh, b)]
    ys, fin = rnn.RNNLayer.apply(on[0], mask, *on[1:], cell)
    assert ys.shape == (3, 8, H) and fin.shape == (8, H)
    torch.testing.assert_close(ys.float(), ys_w.float(), **close)
    torch.testing.assert_close(fin, fin_w, atol=1e-6, rtol=1e-6)
    ((ys.float() * dys).sum() + (fin * dfin).sum()).backward()
    for t, w in zip(on, plain):
        assert t.grad.shape == w.grad.shape
        assert _rel(t.grad.numpy(), w.grad.numpy()) < 1e-3
    for g, w in zip(rnn.rnn_layer(xs, mask, wx, wh, b, cell), want_fwd):
        torch.testing.assert_close(g.float(), w.float(), **close)
    for g, w in zip(rnn.scan_layer(rnn._x_product(xs, wx, b), mask, wh, cell), want_scan):
        torch.testing.assert_close(g.float(), w.float(), **close)
    got_bwd = rnn.rnn_layer_bwd(xs.bfloat16(), ys_w.detach(), mask, wx, wh, b,
                                dys.bfloat16(), dfin, cs, cell)
    for g, w in zip(got_bwd, want_bwd):
        assert g.shape == w.shape
        assert _rel(g.float().numpy(), w.float().numpy()) < 1e-3
    fwd = ("gru_fwd", plan.E_p, plan.H_p, 1) if plan.fwd == "fused" else \
        ("rnn_fwd", plan.E_p, plan.H_p, plan.scan_cluster)
    bwd = ("bwd", plan.E_p, plan.H_p, plan.dh_cluster)
    scan = ("rnn_scan", plan.H_p, plan.H_p, plan.scan_cluster)
    assert card.calls == [fwd, bwd, fwd, scan, bwd]


# ------------------------------------------------------------ against JAX
def _jax_layer_loss(fn, xs, mask, wx, wh, b, dys, dfin):
    ys, fin = fn(xs.astype(jnp.bfloat16), mask, wx, wh, b)
    return (ys.astype(jnp.float32) * dys).sum() + (fin * dfin).sum()


def _port_layer(xs, mask, wx, wh, b, dys, dfin, cell):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (xs, wx, wh, b)]
    ys, fin = rnn.RNNLayer.apply(ts[0], torch.from_numpy(mask), *ts[1:], cell)
    ((ys.float() * torch.from_numpy(dys)).sum() + (fin * torch.from_numpy(dfin)).sum()).backward()
    return ys.detach(), fin.detach(), [t.grad for t in ts]


def _held(port, jax_out, jax_grads):
    ys, fin, grads = port
    np.testing.assert_allclose(fin.numpy(), np.asarray(jax_out[1]), **FIN)
    np.testing.assert_allclose(ys.float().numpy(), np.asarray(jax_out[0], np.float32), **BF16)
    for name, g, w in zip(("dxs", "dwx", "dwh", "db"), grads, jax_grads):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) < GRAD, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("E", [128, 256])
def test_layer_matches_pallas_at_256(cell, E):
    """H=256, which JAX runs on its Pallas kernels (interpret mode here)."""
    T, B, H = 4, 8, 256
    G = 3 if cell == "gru" else 4
    xs, mask, wx, wh, b, dys, dfin = _inputs(E + G, T, B, E, H, G)

    def layer(x, m, a, c, d):
        return pallas_rnn.rnn_layer(x, m, a, c, d, cell, True)

    args = [jnp.asarray(a) for a in (xs, mask, wx, wh, b, dys, dfin)]
    out = layer(args[0].astype(jnp.bfloat16), *args[1:5])
    grads = jax.grad(lambda x, a, c, d: _jax_layer_loss(layer, x, args[1], a, c, d, *args[5:]),
                     (0, 1, 2, 3))(args[0], *args[2:5])
    _held(_port_layer(xs, mask, wx, wh, b, dys, dfin, cell), out, grads)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("E,H", [(100, 100), (128, 176)])
def test_layer_matches_lax_scan(cell, E, H):
    """H=100 and 176: JAX's lax.scan layer (``towers._rnn_layer``, the
    route its encode_raw takes where Pallas does not)."""
    T, B = 5, 8
    G = 3 if cell == "gru" else 4
    xs, mask, wx, wh, b, dys, dfin = _inputs(E + H + G, T, B, E, H, G)
    jmask = jnp.asarray(mask[:, 0, :, None])  # [T, B, 1]

    def layer(x, m, a, c, d):
        return jtowers._rnn_layer({"w": jnp.concatenate([a, c]), "b": d}, x, jmask, cell)

    args = [jnp.asarray(a) for a in (xs, mask, wx, wh, b, dys, dfin)]
    out = layer(args[0].astype(jnp.bfloat16), None, *args[2:5])
    grads = jax.grad(lambda x, a, c, d: _jax_layer_loss(layer, x, None, a, c, d, *args[5:]),
                     (0, 1, 2, 3))(args[0], *args[2:5])
    _held(_port_layer(xs, mask, wx, wh, b, dys, dfin, cell), out, grads)


@pytest.mark.parametrize("cell,num_layers,residual", [("gru", 2, False), ("lstm", 3, True)])
def test_towers_match_jax_at_hidden_256(cell, num_layers, residual):
    """A 2-layer GRU tower and the compositional recipe's 3-layer residual
    LSTM at hidden 256 through ``encode_raw``, JAX params carried across
    by ``convert.params_from_jax``: the embeddings, and the gradients of
    a loss on them."""
    kw = dict(cell=cell, vocab_size=40, embed_dim=256 if cell == "gru" else 128, hidden=256,
              num_layers=num_layers, residual=residual, encoding_dim=16)
    jcfg, tcfg = jtowers.TowerConfig(**kw), ttowers.TowerConfig(**kw)
    jp = jtowers.init_tower(jax.random.PRNGKey(num_layers), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(num_layers)
    toks = rng.integers(2, 40, size=(8, 6)).astype(np.int32)
    lens = rng.integers(1, 7, size=(8,)).astype(np.int32)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    want, jgrads = jax.value_and_grad(
        lambda p: (jtowers.encode_raw(p, jcfg, jnp.asarray(toks), jnp.asarray(lens))
                   * w).sum())(jp)
    jemb = np.asarray(jtowers.encode_raw(jp, jcfg, jnp.asarray(toks), jnp.asarray(lens)))
    leaves = {k: v.requires_grad_(True) for k, v in _flat(tp).items()}
    emb = ttowers.encode_raw(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(lens))
    np.testing.assert_allclose(emb.detach().numpy(), jemb, **FIN)
    (emb * torch.from_numpy(w)).sum().backward()
    jflat = {k: np.asarray(v) for k, v in _flat(jgrads).items()}
    assert jflat.keys() == leaves.keys()
    for k, t in leaves.items():
        assert _rel(t.grad.numpy(), jflat[k]) < GRAD, (k, _rel(t.grad.numpy(), jflat[k]))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict/list of arrays or tensors."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
