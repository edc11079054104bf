"""The work models against hand counts at small shapes."""

import pytest

from benchmark import work

TOWER = {"cell": "lstm", "readout": "attention", "embed_dim": 4, "hidden": 2, "encoding_dim": 3,
         "num_layers": 1}


def test_rnn_layer_forward_hand_count():
    # 5 valid steps over 2 rows, E=4, H=2: a step's [x; h] (6) times W (6 x 8 for 4 gates)
    got = work.rnn_layer_fwd("lstm", tokens=5, rows=2, embed=4, hidden=2)
    assert got["flops"] == 5 * 2 * 6 * 8
    # bf16 x and y of the valid steps, float32 weight and bias once, float32 final state a row
    assert got["bytes"] == 5 * 4 * 2 + 5 * 2 * 2 + 6 * 8 * 4 + 8 * 4 + 2 * 2 * 4
    assert work.rnn_layer_fwd("gru", 5, 2, 4, 2)["flops"] == 5 * 2 * 6 * 6


def test_backward_is_twice_the_forward_products():
    f = work.rnn_layer_fwd("gru", 7, 3, 16, 8)["flops"]
    assert work.rnn_layer_bwd("gru", 7, 3, 16, 8)["flops"] == 2 * f


def test_four_gate_lstm_against_the_old_three_gate_count():
    rows, length, e, h, d = 3, 5, 4, 2, 3
    old = work.legacy_tower_flops(rows, length, e, h, d)
    new = work.tower_fwd_flops("lstm", "final", rows * length, rows, e, h, d)
    gru = work.tower_fwd_flops("gru", "final", rows * length, rows, e, h, d)
    assert gru == old  # the old count is the GRU's
    assert new - old == rows * length * 2 * (e + h) * h  # the LSTM's fourth gate
    attn = work.tower_fwd_flops("lstm", "attention", rows * length, rows, e, h, d)
    assert attn - new == rows * length * (2 * h * h + 4 * h)


def test_score_topk_hand_count():
    got = work.score_topk(batch=2, rows=10, dim=4, k=3, row_bytes=2)
    assert got["flops"] == 2 * 2 * 10 * 4
    assert got["bytes"] == 10 * 4 * 2 + 2 * 4 * 2 + 2 * 3 * 8


def test_train_step_counts_backward_twice_and_mining_once():
    t = dict(TOWER)
    fwd = (work.tower_fwd_flops("lstm", "attention", 10, 2, 4, 2, 3)
           + work.tower_fwd_flops("lstm", "attention", 30, 6, 4, 2, 3) + 2 * 2 * 6 * 3)
    assert work.train_step_flops(t, 10, 2, 30, 6, 100, True) == 3 * fwd + 2 * 2 * 100 * 3
    assert work.train_step_flops(t, 10, 2, 30, 6, 100, False) == 3 * fwd


def test_bound_and_peaks():
    kind = "NVIDIA H100 80GB HBM3"
    assert work.chip_spec(kind) == (989.0, 3350.0)
    assert work.chip_spec("NVIDIA H100 PCIe") == (756.0, 2000.0)
    assert work.chip_spec("cpu") is None and work.bound_seconds(1, 1, "cpu") is None
    # operations-bound and bytes-bound cases
    assert work.bound_seconds(989e12, 0, kind) == pytest.approx(1.0)
    assert work.bound_seconds(0, 3.35e12, kind) == pytest.approx(1.0)
    assert work.bound_seconds(989e12, 6.7e12, kind) == pytest.approx(2.0)
