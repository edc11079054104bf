"""The table gradient of ``embed_grad="take"`` on the CPU: the plain
mirror of ``csrc/embed_grad.cu``'s order (``ops.embed.table_grad_reference``:
the same chunks of sorted positions, edge partials and merge order, in
float32) against a float64 ``index_add_``, within float32 rounding; the
route ``models.towers._embed`` takes on the CPU (autograd's own backward,
unchanged); the ``embed_grad`` launch counter through graph replays.
``tests/test_torch_gpu_embed_grad.py`` holds the kernel to this mirror bit
for bit on the card."""

import numpy as np
import pytest
import torch

from sse_tpu_torch import ops
from sse_tpu_torch.models import towers
from sse_tpu_torch.ops import embed

S = embed.CHUNK


def _pad_heavy(rng, rows: int, length: int = 50, vocab: int = 8000) -> np.ndarray:
    """Token rows like the QnA cell's questions: 5-30 ids in [2, vocab),
    padded to ``length`` with id 0."""
    toks = np.zeros((rows, length), np.int64)
    for r, n in enumerate(rng.integers(5, min(30, length) + 1, rows)):
        toks[r, :n] = rng.integers(2, vocab, n)
    return toks


def token_case(name: str, rng) -> tuple:
    """(tokens, vocab) of one named case."""
    if name == "one_id":  # a run across every chunk, more than MERGE_WARPS of them
        return np.full((20, 50), 3, np.int64), 10
    if name == "uniform":
        return rng.integers(0, 50, (14, 50)), 50
    if name == "pad_heavy":
        return _pad_heavy(rng, 40), 8000
    if name == "run_ends_on_edge":  # runs of 2S, S and S + 5: edges at 2S and 3S
        return np.repeat(np.array([4, 7, 9]), [2 * S, S, S + 5])[rng.permutation(4 * S + 5)], 12
    if name == "ragged_tail":  # N = 37, not a multiple of S; and N < S below
        return rng.integers(0, 3, (37,)), 5
    if name == "shorter_than_a_chunk":
        return rng.integers(0, 4, (2, 3)), 6
    if name == "negative_ids":  # taken modulo the vocab, as the lookup takes them
        return rng.integers(-9, 9, (9, 11)), 9
    raise KeyError(name)


CASES = ["one_id", "uniform", "pad_heavy", "run_ends_on_edge", "ragged_tail",
         "shorter_than_a_chunk", "negative_ids"]


@pytest.mark.parametrize("E", [64, 128, 256])
@pytest.mark.parametrize("case", CASES)
def test_mirror_matches_float64_index_add(case, E):
    """Every id's row within float32 rounding of the float64 sum: a sum of
    n float32 terms in any order lies within (n - 1)·2^-24·Σ|term| of the
    exact one (a dropped or doubled row is far outside it); ids no token
    names are exactly zero."""
    rng = np.random.default_rng(27 + E)
    toks, vocab = token_case(case, rng)
    dy = torch.from_numpy(rng.normal(size=(*toks.shape, E)).astype(np.float32))
    tokens = torch.from_numpy(toks)
    got = embed.table_grad_reference(tokens, dy, vocab)
    assert got.dtype == torch.float32 and got.shape == (vocab, E)
    flat = tokens.reshape(-1).remainder(vocab)
    rows = dy.reshape(-1, E).double()
    exact = torch.zeros((vocab, E), dtype=torch.float64).index_add_(0, flat, rows)
    abs_sum = torch.zeros((vocab, E), dtype=torch.float64).index_add_(0, flat, rows.abs())
    count = torch.bincount(flat, minlength=vocab).double()[:, None]
    bound = (count - 1).clamp(min=0) * 2.0**-24 * abs_sum * (1 + 1e-6)
    assert ((got.double() - exact).abs() <= bound).all()
    assert not got[count[:, 0] == 0].any()


def test_mirror_cuts_runs_by_position():
    """The order the mirror states: a run inside a chunk is summed from 0
    in sorted order, so a run of one row is that row bit for bit; a run of
    one id over every chunk is the partials summed in groups."""
    dy = torch.randn(S * 3 + 1, 4)
    tokens = torch.tensor([1] * (S * 3) + [2])
    got = embed.table_grad_reference(tokens, dy, 3)
    assert torch.equal(got[2], dy[-1]) and not got[0].any()
    chunks = []
    for c in range(3):
        acc = torch.zeros(4)
        for j in range(S):
            acc = acc + dy[c * S + j]
        chunks.append(acc)
    n = len(chunks)
    total = torch.zeros(4)
    for w in range(embed.MERGE_WARPS):
        s = torch.zeros(4)
        for p in chunks[n * w // embed.MERGE_WARPS : n * (w + 1) // embed.MERGE_WARPS]:
            s = s + p
        total = total + s
    assert torch.equal(got[1], total)


def test_cpu_take_keeps_autograds_backward():
    """On the CPU ``_embed(..., "take")`` is the plain gather, its table
    gradient autograd's (the route every JAX parity test holds); the
    lookup function with the ``take`` cotangent (the card's route) gives
    the same gradient within float32 rounding, through the mirror."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(30, 16)).astype(np.float32))
    tokens = torch.from_numpy(_pad_heavy(rng, 6, length=12, vocab=30))
    dy = torch.from_numpy(rng.normal(size=(6, 12, 16)).astype(np.float32))
    t1 = table.clone().requires_grad_()
    out = towers._embed(t1, tokens, "take")
    assert type(out.grad_fn).__name__ == "IndexBackward0"
    out.backward(dy)
    t2 = table.clone().requires_grad_()
    out2 = towers._EmbedLookup.apply(t2, tokens, "take")
    assert torch.equal(out2.detach(), out.detach())
    before = ops.launch_counts()["embed_grad"]
    out2.backward(dy)
    assert ops.launch_counts()["embed_grad"] == before  # the CPU runs the mirror, no kernel
    torch.testing.assert_close(t2.grad, t1.grad, rtol=0, atol=1e-5)
    with torch.no_grad():
        assert towers._embed(t1, tokens, "take").grad_fn is None


def test_graph_launches_count_embed_grad_through_replays():
    """A capture's ``embed_grad`` launches come out of the counter and come
    back once a replay, as the recurrent kernels' do."""
    ops.reset_launch_counts()
    embed.launches["embed_grad"] += 1  # a launch before the capture
    counted = ops.GraphLaunches()
    with counted.capturing():
        embed.launches["embed_grad"] += 2  # one a tower's table
    assert ops.launch_counts()["embed_grad"] == 1
    for _ in range(3):
        counted.replayed()
    assert ops.launch_counts()["embed_grad"] == 7
    ops.reset_launch_counts()
    assert ops.launch_counts()["embed_grad"] == 0
