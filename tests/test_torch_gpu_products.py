"""The recurrent layers' product engine (``csrc/products.cu``: the LSTM
forward's x-product, and the backward's gate recompute, dxs and split-K
dW, on wgmma with TMA) against the plain products on a CUDA card (marker
``gpu``; each test skips where torch sees no card, the every-card test
below two cards). Run on the card with
``python -m pytest --noconftest tests/test_torch_gpu_products.py``.

Tolerances: the fp32 products (ax, gates, dWx, dWh) to 1e-5 of each
tensor's max-abs (fp32 sums of the same bf16 products in another order);
dxs to one bf16 ulp (``chip_smoke.held_to_one_ulp``). The backward's
products are held against the plain products of the kernels' own
dgates_b (``rnn.bwd_products``) and ys (``rnn.layer_gates``), so the dh
chain's drift does not enter. Two launches on the same inputs give the
same bits.
"""

import pytest
import torch

import test_torch_gpu_kernels as k
from test_torch_gpu_kernels import cuda  # noqa: F401  (the fixture)

pytestmark = pytest.mark.gpu

# ragged M = T·B: one row, 3·33 = 99, 50·2113 = 105,650 (not a multiple of
# the 128-row tile or the 64-row stage)
RAGGED = [(1, 1), (3, 33), (50, 2113)]
# the widths the tests of the layers take (E, H multiples of 16); the LSTM
# forward's scan stops at H=160, the backward's dh loops at H=176 (GRU)
# and H=144 (LSTM)
LSTM_FWD_WIDTHS = [(128, 128), (64, 96), (16, 160), (272, 96), (128, 144)]
GRU_BWD_WIDTHS = [(128, 128), (64, 96), (16, 176), (272, 96)]
LSTM_BWD_WIDTHS = [(128, 128), (64, 96), (16, 144), (128, 144), (272, 96)]


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _hold_x_product(gen, T, B, E, H):
    """The LSTM forward's ax against rnn._x_product, twice the same bits."""
    from sse_tpu_torch.ops import rnn

    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    mask = k._ragged_mask(gen, T, B)
    wx = (torch.randn((E, 4 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 4 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((4 * H,), generator=gen, device="cuda") * 0.05
    ax = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)[3]
    again = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)[3]
    torch.cuda.synchronize()
    assert torch.equal(ax, again)
    assert _rel(ax, rnn._x_product(xs, wx, b)) <= 1e-5


def _hold_bwd_products(gen, cell, T, B, E, H):
    """The backward's gates, dxs, dWx and dWh against the plain products
    of its own ys and dgates_b; every output twice the same bits."""
    from chip_smoke import held_to_one_ulp
    from sse_tpu_torch.ops import rnn

    if cell == "gru":
        args, cs = k._gru_bwd_args(gen, T, B, E, H), None
        run = lambda: rnn.gru_bwd_launch(*args)  # noqa: E731
    else:
        args, cs = k._lstm_bwd_args(gen, T, B, E, H)
        run = lambda: rnn.lstm_bwd_launch(args[0], args[1], cs, *args[2:])  # noqa: E731
    xs, ys, mask, wx, wh, b, dys, dfin = args
    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    dxs, dwx, dwh, _, gates, dgb = got
    h_prev = rnn._h_prev(ys)
    assert _rel(gates, rnn.layer_gates(xs, h_prev, wx, wh, b)) <= 1e-5
    dxs_r, dwx_r, dwh_r = rnn.bwd_products(xs, h_prev, wx, dgb)
    held_to_one_ulp(f"{cell} dxs T={T} B={B} E={E} H={H}", dxs, dxs_r)
    assert _rel(dwx, dwx_r) <= 1e-5
    assert _rel(dwh, dwh_r) <= 1e-5


@pytest.mark.parametrize("E,H", LSTM_FWD_WIDTHS)
@pytest.mark.parametrize("T,B", RAGGED)
def test_x_product_matches_plain(cuda, T, B, E, H):
    _hold_x_product(cuda, T, B, E, H)


@pytest.mark.parametrize("E,H", GRU_BWD_WIDTHS)
@pytest.mark.parametrize("T,B", RAGGED)
def test_gru_bwd_products_match_plain(cuda, T, B, E, H):
    _hold_bwd_products(cuda, "gru", T, B, E, H)


@pytest.mark.parametrize("E,H", LSTM_BWD_WIDTHS)
@pytest.mark.parametrize("T,B", RAGGED)
def test_lstm_bwd_products_match_plain(cuda, T, B, E, H):
    _hold_bwd_products(cuda, "lstm", T, B, E, H)


@pytest.mark.parametrize("cell,E,H", [("gru", 128, 128), ("lstm", 128, 128), ("gru", 16, 16),
                                      ("gru", 16, 176), ("lstm", 272, 96)])
def test_dw_every_slice_count(cuda, cell, E, H):
    """Every slice count that rnn.dw_plan picks for these widths (T=3 and
    the least B that reaches it, up to the cap or the tiles' fill): the
    dW partials summed in order against the plain product."""
    from sse_tpu_torch.ops import rnn

    G = rnn._GATES[cell]
    first = {}
    for B in range(1, 2700):
        first.setdefault(rnn.dw_plan(3 * B, E, H, G * H)[0], B)
    assert sorted(first) == list(range(1, max(first) + 1))
    for B in first.values():
        _hold_bwd_products(cuda, cell, 3, B, E, H)


def test_products_on_every_card(cuda):
    """The engine's shared-memory allowance belongs to a (kernel, card):
    the products launch on every card of a process, each on its own card's
    tensors, against the plain products there."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    for i in range(n):
        with torch.cuda.device(i):
            gen = torch.Generator(device="cuda").manual_seed(i)
            _hold_x_product(gen, 50, 300, 128, 128)
            _hold_bwd_products(gen, "gru", 50, 300, 128, 128)
            _hold_bwd_products(gen, "lstm", 50, 300, 128, 128)
