"""The port's Hopper kernels against their plain PyTorch versions on a
CUDA card (marker ``gpu``; each test skips where torch sees no card).
Run on the card with ``python -m pytest tests/test_torch_gpu_kernels.py``;
``chip_smoke.py`` makes the same comparisons at the serving shapes.

Tolerances: top-k rows and values bit-identical (exact-dot inputs make
every float32 sum exact, int8 sums are exact integers); GRU fin to atol
2e-3 / rtol 1e-3, bf16 ys to one bf16 ulp (rtol 2^-7).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


def _exact(shape, gen):
    return (torch.randint(-16, 17, shape, generator=gen, device="cuda") / 16).bfloat16()


@pytest.mark.parametrize("B", [8, 300])
def test_gru_kernel_matches_plain(cuda, B):
    from sse_tpu_torch.ops import rnn

    T, E, H = 20, 128, 128
    xs = torch.randn((T, B, E), generator=cuda, device="cuda").bfloat16()
    lens = torch.randint(1, T + 1, (B,), generator=cuda, device="cuda")
    mask = (torch.arange(T, device="cuda")[:, None] < lens).float()[:, None, :].contiguous()
    wx = (torch.randn((E, 3 * H), generator=cuda, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 3 * H), generator=cuda, device="cuda") * 0.08).bfloat16()
    b = torch.randn((3 * H,), generator=cuda, device="cuda") * 0.05
    n = rnn.launches["gru_fwd"]
    ys, fin = rnn.rnn_layer(xs, mask, wx, wh, b)
    assert rnn.launches["gru_fwd"] == n + 1
    rys, rfin = rnn.rnn_layer_reference(xs, mask, wx, wh, b)
    torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(ys.float(), rys.float(), atol=2e-3, rtol=2.0**-7)


@pytest.mark.parametrize("dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("B,num_real", [(8, 20000), (100, 19000), (64, 5)])
def test_topk_kernels_match_plain(cuda, dtype, B, num_real):
    _check_topk(cuda, dtype, B, num_real, 128)


# the other row width of each narrow type: 128-byte bf16 rows (D=64, the
# default encoding_dim) and 256-byte int8 rows (D=256)
@pytest.mark.parametrize("dtype,d", [("bf16", 64), ("int8", 256)])
@pytest.mark.parametrize("B", [8, 100])
def test_topk_kernels_other_row_width(cuda, dtype, d, B):
    _check_topk(cuda, dtype, B, 19000, d)


def _check_topk(cuda, dtype, B, num_real, d):
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    t, k = 20480, 10
    if dtype == "int8":
        x = torch.randn((t, d), generator=cuda, device="cuda")
        emb = quantize_rows(x / x.norm(dim=1, keepdim=True), torch.int8)
        q = torch.randn((B, d), generator=cuda, device="cuda")
        q = q / q.norm(dim=1, keepdim=True)
    else:
        emb, q = _exact((t, d), cuda), _exact((B, d), cuda)
        if dtype == "f32":
            emb, q = emb.float(), q.float()
    want = topk.topk_reference(q, emb, k, num_real)
    for got in (
        topk.fused_score_topk(q, emb, k, num_real),
        topk.fused_score_topk_twophase(q, emb, k, num_real, block_t=2048),
    ):
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    qk, _ = topk._prep_queries(q, emb)
    p1 = topk.twophase_phase1(qk, emb, k, num_real, 2048)
    assert torch.equal(p1, topk.twophase_phase1_reference(qk, emb, k, num_real, 2048))
    tq, tb, _ = topk.pair_schedule(p1, t // 2048)
    assert torch.equal(
        topk.twophase_phase2(qk, emb, k, num_real, 2048, tq, tb),
        topk.twophase_phase2_reference(qk, emb, k, num_real, 2048, tq, tb),
    )


def test_cuda_wrappers_raise_on_bad_input(cuda):
    from sse_tpu_torch.ops import topk

    q = torch.zeros((4, 96), device="cuda", dtype=torch.bfloat16)  # 192-byte rows
    emb = torch.zeros((256, 96), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128 or 256 bytes"):
        topk.fused_score_topk(q, emb, 5, 256)
    with pytest.raises(ValueError, match="k <= 128"):
        topk.fused_score_topk(q[:, :64].contiguous(), emb[:, :64].contiguous(), 200, 256)
