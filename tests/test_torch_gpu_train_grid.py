"""Training on a grid of cards (marker ``gpu``; each test skips where
torch sees no card, the distinct-card ones below two cards). Run on the
card with ``python -m pytest --noconftest tests/test_torch_gpu_train_grid.py``.

A grid spanning cards runs the recurrent kernels, forward and backward,
on every data replica's card. Their shared-memory allowance is set once
a (kernel, card) (the backward's dh loops through ``hopper.cuh``
``allow_smem``) and they launch on the current stream of the tensor's own
card; these tests pin that on each card: the GRU and LSTM layer forwards
(kernels 2 and 3, the LSTM's through the scan, kernel 1) and both
backwards (kernel 4) against their plain versions there, at
``tests/test_torch_gpu_kernels.py``'s tolerances (its helpers, on the
card made current). Then one train step on a (2, 1) grid of two cards
against the step on one card: loss and grad_norm rtol 2e-4, params rtol
3e-3 / atol 3e-5 after an SGD step (an Adam step would turn the last-bit
differences of near-zero gradients into whole steps), every copy
identical, the recurrent kernels launched twice as often (once a
replica).
"""

import pytest
import torch

import test_torch_gpu_kernels as k

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.cuda.device_count()


def test_recurrent_kernels_on_every_card(cuda):
    """Kernels 2, 3 (with 1) and 4 on each card against their plain
    versions on that card."""
    from sse_tpu_torch.ops import rnn

    for i in range(cuda):
        with torch.cuda.device(i):
            gen = torch.Generator(device="cuda").manual_seed(i)
            k._check_gru_fwd(gen, 50, 128, 128, 128)
            k._check_lstm_fwd(gen, 50, 128, 128, 128)
            args = k._gru_bwd_args(gen, 50, 128)
            assert args[0].device == torch.device("cuda", i)
            got = rnn.rnn_layer_bwd(*args)
            assert got[1].device == torch.device("cuda", i)
            k._check_bwd(got, rnn.rnn_layer_bwd_reference(*args), 50)
            args, cs = k._lstm_bwd_args(gen, 50, 128)
            got = rnn.rnn_layer_bwd(*args, cs=cs, cell="lstm")
            k._check_bwd(got, rnn.rnn_layer_bwd_reference(*args, cs, "lstm"), 50)


def test_grid_step_across_two_cards(cuda):
    """One SGD step of the ranking preset's loss (GRU dual encoder, sampled
    softmax with mined hard negatives, E=H=D=128, B=64) on a (2, 1) grid
    of cuda:0 and cuda:1 against the step on cuda:0."""
    if cuda < 2:
        pytest.skip("needs two CUDA cards")
    import numpy as np

    from sse_tpu_torch import ops
    from sse_tpu_torch.data.batching import Batch
    from sse_tpu_torch.models import sse, towers
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.parallel.mesh import gather
    from sse_tpu_torch.train import LossConfig, TrainConfig, grid, init_train_state, loop

    tower = towers.TowerConfig(vocab_size=1000, embed_dim=128, hidden=128, encoding_dim=128)
    cfg = sse.SSEConfig(mode=sse.NetworkMode.DUAL_ENCODER, src_tower=tower, tgt_tower=tower)
    tc = TrainConfig(batch_size=64, learning_rate=0.5, optimizer="sgd", max_gradient_norm=1e9,
                     loss=LossConfig(kind="sampled", num_negatives=32, num_hard_negatives=4))
    rng = np.random.default_rng(0)
    t = 512
    src = rng.integers(2, 1000, size=(64, 20)).astype(np.int32)
    batch = Batch(src, rng.integers(1, 21, size=64).astype(np.int32),
                  rng.integers(0, t, size=64).astype(np.int32), np.ones(64, np.float32))
    packed = torch.from_numpy(loop.pack_batch(batch))
    tt = torch.from_numpy(rng.integers(2, 1000, size=(t, 20)).astype(np.int32)).cuda()
    tl = torch.from_numpy(rng.integers(1, 21, size=t).astype(np.int32)).cuda()
    state = init_train_state(cfg, tc, device="cuda:0")
    with torch.no_grad():
        cache = sse.target_embeddings(state.params, cfg, tokens=tt, lengths=tl)
    ops.reset_launch_counts()
    one, m1 = loop.make_train_step(cfg, tc, packed_width=20)(state, packed.cuda(), tt, tl, cache)
    torch.cuda.synchronize()
    per_step = ops.launch_counts()
    mesh = make_mesh(2, 1)
    assert [d.index for d in mesh.devices[:, 0]] == [0, 1]
    ops.reset_launch_counts()
    two, m2 = loop.make_train_step(cfg, tc, packed_width=20, mesh=mesh)(
        grid.place_state(state, mesh), packed, tt, tl, cache)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in ("gru_fwd", "gru_bwd"):
        assert counts[name] == 2 * per_step[name] > 0, (name, counts, per_step)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m2[key].cpu(), m1[key].cpu(), rtol=2e-4, atol=0)
    for a, b in zip(loop.tree_leaves(gather(two.params, torch.device("cuda", 0))),
                    loop.tree_leaves(one.params)):
        torch.testing.assert_close(a, b, rtol=3e-3, atol=3e-5)
    assert grid.copies_identical(two)
    copies = two.params["src_tower"]["proj_w"]
    assert sorted(d.index for d in copies) == [0, 1]
