"""The table gradient of ``embed_grad="take"`` on a CUDA card (marker
``gpu``; skips where torch sees no card): ``ops.embed.table_grad``, which
sorts the ids and launches ``csrc/embed_grad.cu``.

- Its table gradient is bit for bit the plain mirror's
  (``table_grad_reference``, run on the CPU) on the cases of
  ``tests/test_torch_embed_grad.py``, at E = 64, 128, 256 and an odd
  width (the scalar instance), and at the QnA step's token counts.
- It has the same bits on two runs, and eager against a replayed CUDA
  graph; the ``embed_grad`` counter counts a capture's launch on each
  replay.
- A tower on the card takes it only where its table takes a gradient:
  the counter stays at zero under ``torch.no_grad()`` and counts one
  launch a table lookup in a backward.
Run on the card with ``python -m pytest --noconftest tests/test_torch_gpu_embed_grad.py``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


def _case(name: str, E: int):
    from test_torch_embed_grad import token_case

    rng = np.random.default_rng(91 + E)
    if name == "qna_targets":  # a step's target rows: 2,304 passages of 50, some short
        toks = np.zeros((2304, 50), np.int64)
        for r, n in enumerate(np.clip(rng.lognormal(np.log(90), 0.5, 2304), 5, 50).astype(int)):
            toks[r, :n] = rng.integers(2, 8000, n)
        vocab = 8000
    else:
        toks, vocab = token_case(name, rng)
    dy = rng.normal(size=(*toks.shape, E)).astype(np.float32)
    return torch.from_numpy(toks).cuda(), torch.from_numpy(dy).cuda(), vocab


@pytest.mark.parametrize("E", [64, 128, 256, 20])
@pytest.mark.parametrize("case", ["one_id", "uniform", "pad_heavy", "run_ends_on_edge",
                                  "ragged_tail", "shorter_than_a_chunk", "negative_ids",
                                  "qna_targets"])
def test_kernel_equals_the_mirror_bit_for_bit(cuda, case, E):
    from sse_tpu_torch.ops import embed

    tokens, dy, vocab = _case(case, E)
    got = embed.table_grad(tokens, dy, vocab)
    want = embed.table_grad_reference(tokens.cpu(), dy.cpu(), vocab)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (vocab, E)
    assert torch.equal(got.cpu(), want)


def test_same_bits_on_every_run_eager_and_replayed(cuda):
    from sse_tpu_torch import ops
    from sse_tpu_torch.ops import embed

    tokens, dy, vocab = _case("qna_targets", 128)
    first = embed.table_grad(tokens, dy, vocab).clone()
    assert torch.equal(embed.table_grad(tokens, dy, vocab), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        embed.table_grad(tokens, dy, vocab)
    torch.cuda.current_stream().wait_stream(side)
    graph, counted = torch.cuda.CUDAGraph(), ops.GraphLaunches()
    ops.reset_launch_counts()
    with counted.capturing(), torch.cuda.graph(graph):
        out = embed.table_grad(tokens, dy, vocab)
    assert ops.launch_counts()["embed_grad"] == 0
    for _ in range(3):
        out.fill_(7.0)
        graph.replay()
        counted.replayed()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert ops.launch_counts()["embed_grad"] == 3


def test_tower_takes_the_kernel_only_with_a_gradient(cuda):
    from sse_tpu_torch import ops
    from sse_tpu_torch.models import towers

    cfg = towers.TowerConfig(vocab_size=300, embed_dim=64, hidden=64, encoding_dim=32,
                             cell="lstm", readout="attention")
    params = towers.init_tower(cfg, torch.Generator().manual_seed(0), device="cuda")
    params["embed"].requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(2, 300, (16, 20), generator=gen, device="cuda", dtype=torch.int32)
    lens = torch.randint(1, 21, (16,), generator=gen, device="cuda", dtype=torch.int32)
    toks = torch.where(torch.arange(20, device="cuda") < lens[:, None], toks, 0)
    ops.reset_launch_counts()
    with torch.no_grad():
        towers.encode_raw(params, cfg, toks, lens)
    torch.cuda.synchronize()
    assert ops.launch_counts()["embed_grad"] == 0
    towers.encode_raw(params, cfg, toks, lens).square().sum().backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["embed_grad"] == 1
    assert torch.isfinite(params["embed"].grad).all()
