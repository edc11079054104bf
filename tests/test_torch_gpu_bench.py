"""The port's query bench on a CUDA card at the headline shape (marker
``gpu``; skips where torch sees no card): exact top-10 of the bench tower
at B=4096 over the 1,249,280-row bf16 index. Its rate is positive, it
launched the GRU forward and both two-phase kernels, and its first batch
(the timed setup's) holds against topk_reference on the same encodings
(``bench.first_batch``): the kernels and the reference sum in different
orders, so a differing position is allowed only where the two rows'
scores lie within one key bucket (2^-11 relative;
``ops.topk.rows_off_reference``).
Run on the card with ``python -m pytest --noconftest tests/test_torch_gpu_bench.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def test_query_bench_headline(cuda):
    from sse_tpu_torch import bench, ops

    s = bench.query_setup(num_targets=bench.HEADLINE_ROWS, encoding_dim=128, batch=4096, k=10,
                          max_seq_length=50, index_dtype=torch.bfloat16)
    ops.reset_launch_counts()
    result = bench.time_query(s, seconds=0.5)
    counts = ops.launch_counts()
    assert result["value"] > 0 and result["num_targets"] == bench.HEADLINE_ROWS
    assert result["device"] == torch.cuda.get_device_name(0)
    if bench._chip_spec(result["device"]) is not None:
        assert result["mfu_pct"] > 0 and result["hbm_pct_of_spec"] > 0
    assert all(counts[n] > 0 for n in ("gru_fwd", "twophase_p1", "twophase_p2")), counts
    assert counts["topk_stream"] == 0

    vals, rows, _, bad = bench.first_batch(s)  # the timed setup's first dispatch
    assert torch.isfinite(vals).all() and rows.shape == (4096, 10)
    assert not bad, bad[:5]
