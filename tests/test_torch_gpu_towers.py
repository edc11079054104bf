"""The transformer tower's products on a CUDA card (marker ``gpu``; skips
where torch sees no card). ``towers._dot`` runs there on the bf16 tensor
cores with a float32 result (``_TensorCoreDot``); on operands whose every
float32 partial sum is exact (multiples of 1/16 in [-1, 1], so partial
sums are multiples of 1/256 below 2^9) it must equal ``bf16_matmul`` bit
for bit, forward and backward, whatever order either sums in. The backward's cotangents are rounded to bf16, as
``bf16_matmul``'s autograd rounds them. Then a transformer train step on
the card: finite loss and gradients, no recurrent kernel launched.
Run on the card with ``python -m pytest --noconftest tests/test_torch_gpu_towers.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _exact(shape, gen, dtype=torch.float32):
    return (torch.randint(-16, 17, shape, generator=gen, device="cuda") / 16.0).to(dtype)


@pytest.mark.parametrize("a_shape,b_shape", [
    ((3, 50, 128), (128, 384)),  # activations x a weight
    ((2, 4, 50, 32), (2, 4, 32, 50)),  # q @ kᵀ, batched
    ((2, 4, 50, 50), (2, 4, 50, 32)),  # attn @ v
    ((7, 128), (128, 16)),
])
@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_dot_equals_bf16_matmul(cuda, a_shape, b_shape, a_dtype):
    from sse_tpu_torch.models import towers
    from sse_tpu_torch.ops.rnn import bf16_matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = _exact(a_shape, gen, a_dtype), _exact(b_shape, gen)
    g = _exact(a_shape[:-1] + b_shape[-1:], gen)
    outs = []
    for dot in (towers._dot, bf16_matmul):
        x, w = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = dot(x, w)
        y.backward(g)
        outs.append((y.detach(), x.grad, w.grad))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_transformer_train_step_on_the_card(cuda):
    from sse_tpu_torch import ops
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.train import LossConfig, TrainConfig, init_train_state, make_train_step
    from sse_tpu_torch.train.loop import tree_leaves

    tower = TowerConfig(vocab_size=500, embed_dim=64, hidden=64, encoding_dim=32, num_layers=2,
                        cell="transformer", num_heads=4)
    cfg = SSEConfig(mode=NetworkMode.DUAL_ENCODER, src_tower=tower, tgt_tower=tower)
    tc = TrainConfig(batch_size=16, loss=LossConfig(kind="sampled", num_negatives=8))
    state = init_train_state(cfg, tc, torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tok = lambda n: torch.randint(2, 500, (n, 12), generator=gen, device="cuda",  # noqa: E731
                                  dtype=torch.int32)
    lens = lambda n: torch.randint(1, 13, (n,), generator=gen, device="cuda",  # noqa: E731
                                   dtype=torch.int32)
    step = make_train_step(cfg, tc)
    ops.reset_launch_counts()
    before = [t.clone() for t in tree_leaves(state.params)]
    state, metrics = step(state, tok(16), lens(16), torch.arange(16, device="cuda"),
                          torch.ones(16, device="cuda"), tok(64), lens(64))
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    after = tree_leaves(state.params)
    assert all(torch.isfinite(t).all() for t in after)
    assert sum(int(not torch.equal(x, y)) for x, y in zip(before, after)) == len(after)
    assert not any(ops.launch_counts()[k] for k in ("gru_fwd", "gru_bwd", "lstm_fwd",
                                                    "lstm_bwd", "rnn_scan"))
