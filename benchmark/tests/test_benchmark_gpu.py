"""On the card (marker ``gpu``; skips where torch sees none), at sizes a
test run holds (training at its own): each cell's program is judged
correct and its control (the reference with float8 products in the
program's place) is not.
The same comparison at each cell's own size is ``benchmark/calibrate.py``.

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_benchmark_gpu.py
"""

import pytest
import torch

from benchmark import harness

SIZES = {
    "gru-query-bulk": {"config": {"serve": {"index_rows": 1249280}}, "traffic": {"pool": 2}},
    "gru-query-interactive": {"config": {"serve": {"index_rows": 1249280}},
                              "traffic": {"pool": 64, "check": {"answers": 64}}},
    # training at its own 1,249,280 targets, the size its limits were set at
    "qna-train": {"traffic": {"pool": 2}},
    "qna-index-build": {"config": {"num_targets": 65536}},
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_program_is_correct_and_control_is_not(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(cell, 2**31 + 99, 1.0, False, "cuda", SIZES[cell])
    assert out["correct"], out["checks"]
    ctl = harness.run_cell(cell, 2**31 + 98, 1.0, False, "cuda", SIZES[cell], mode="control")
    assert not ctl["correct"], ctl["checks"]
