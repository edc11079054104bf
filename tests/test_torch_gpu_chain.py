"""Dispatch chaining on a CUDA card (marker ``gpu``; skips where torch sees
no card): ``make_train_step(chain=8)`` captures 8 train steps as one CUDA
graph and replays it.

- A replay from a state against 8 eager steps from the same state, for
  the bench's GRU and the compositional LSTM stack with dropout (B=256,
  L=50, 128 negatives) and the ``qna`` preset on pad-heavy batches: bit
  for bit where two eager runs are bit for bit on the card; where they
  are not (a backward that sums with atomics in any order), held as
  ``chip_smoke.held_state`` holds a state, with the eager-vs-eager drift
  printed beside it. The launch counters count a replay's kernels as the
  eager steps'.
- Replays sync nothing: they run under
  ``torch.cuda.set_sync_debug_mode("error")``, both from the state the
  last replay returned and from another state (copied in), with the chunk
  uploaded from pinned memory.
- A step that cannot be captured raises; the injected negatives hook is
  refused.
- The capture runs with Python's cyclic collector off: garbage cycles
  holding CUDA graphs, dropped during the capture under
  ``gc.set_threshold(1)``, do not end it.
Run on the card with ``python -m pytest --noconftest tests/test_torch_gpu_chain.py``."""

import pytest
import torch

pytestmark = pytest.mark.gpu

K = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _setup(cell: str):
    from sse_tpu_torch import bench
    from sse_tpu_torch.models.towers import TowerConfig

    tower = None
    if cell == "lstm":
        tower = TowerConfig(vocab_size=8000, embed_dim=128, hidden=128, encoding_dim=128,
                            cell="lstm", num_layers=3, residual=True, dropout=0.1)
    return bench.train_setup(tower=tower, chain=K)


def _eager(s):
    """The chain's plain version: the same packed steps, one by one."""
    from sse_tpu_torch.train import loop

    cfg = loop.TrainConfig(batch_size=len(s.lengths), steps_per_dispatch=K,
                           loss=loop.LossConfig(kind="sampled", num_negatives=s.num_negatives))
    return loop._eager_chain(loop.make_train_step(s.model_cfg, cfg, packed_width=s.max_seq_length),
                             K)


def _copy(state):
    from sse_tpu_torch.train import loop

    return loop._with_leaves(state, [x.clone() for x in loop._state_leaves(state)], state.step)


def _bitwise(a, b) -> bool:
    from sse_tpu_torch.train import loop

    return all(torch.equal(x, y) for x, y in zip(loop._state_leaves(a), loop._state_leaves(b)))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_replay_matches_eager_steps(cuda, cell):
    from sse_tpu_torch import ops

    s = _setup(cell)
    eager = _eager(s)
    pk = s.packed_variants[1]
    run = lambda fn: fn(s.state, pk, s.tgt_tokens, s.tgt_lens)  # noqa: E731
    ops.reset_launch_counts()
    e1, m1 = run(eager)
    eager_counts = ops.launch_counts()
    e2, _ = run(eager)
    s.chain_fn(s.state, s.packed_variants[0], s.tgt_tokens, s.tgt_lens)  # capture
    ops.reset_launch_counts()
    g, gm = run(s.chain_fn)
    torch.cuda.synchronize()
    assert ops.launch_counts() == eager_counts
    _held_against_eager(cell, g, gm, e1, e2, m1)


def test_qna_preset_replay_matches_eager_steps(cuda):
    """The ``qna`` preset as shipped (dual LSTM towers with the attention
    readout, 16 mined and 128 uniform negatives, EMA) on pad-heavy
    questions (5-30 tokens padded to 50) and passages of which some are
    short: a replay against 8 eager steps from the same state, as above.
    Both towers' tables take ``embed_grad``'s kernel, once a table a step,
    eager and replayed."""
    import dataclasses

    from sse_tpu_torch import configs, ops
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.train import loop

    task = configs.preset("qna")
    n, b, length = 4096, task.batch_size, task.max_seq_length
    model_cfg = task.model_config(8000, n)
    train_cfg = dataclasses.replace(task.train_config(), steps_per_dispatch=K)
    state = loop.init_train_state(model_cfg, train_cfg, torch.Generator().manual_seed(0), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    pos = torch.arange(length, device="cuda")

    def padded(rows: int, lo: int, hi: int):
        lens = torch.randint(lo, hi + 1, (rows,), generator=gen, device="cuda", dtype=torch.int32)
        toks = torch.randint(2, 8000, (rows, length), generator=gen, device="cuda",
                             dtype=torch.int32)
        return torch.where(pos < lens[:, None], toks, 0), lens

    tgt_tokens, tgt_lens = padded(n, 5, length)
    with torch.no_grad():
        cache = sse.target_embeddings(state.params, model_cfg, tokens=tgt_tokens,
                                      lengths=tgt_lens)
    weight = torch.ones((b,), dtype=torch.float32, device="cuda").view(torch.int32)
    batches = []
    for _ in range(K):
        src, lens = padded(b, 5, 30)
        labels = torch.randint(0, n, (b,), generator=gen, device="cuda", dtype=torch.int32)
        batches.append(torch.cat([src, lens[:, None], labels[:, None], weight[:, None]], 1))
    pk = torch.stack(batches)
    chain = loop.make_train_step(model_cfg, train_cfg, packed_width=length, chain=K)
    eager = loop._eager_chain(loop.make_train_step(model_cfg, train_cfg, packed_width=length), K)
    run = lambda fn: fn(state, pk, tgt_tokens, tgt_lens, tgt_emb_cache=cache)  # noqa: E731
    ops.reset_launch_counts()
    e1, m1 = run(eager)
    eager_counts = ops.launch_counts()
    assert eager_counts["embed_grad"] == 2 * K
    e2, _ = run(eager)
    run(chain)  # capture
    ops.reset_launch_counts()
    g, gm = run(chain)
    torch.cuda.synchronize()
    assert ops.launch_counts() == eager_counts
    _held_against_eager("qna", g, gm, e1, e2, m1)


def _held_against_eager(cell, g, gm, e1, e2, m1):
    """A replay's state and metrics against eager steps': bit for bit where
    two eager runs (e1, e2) are, else as chip_smoke.held_state holds a
    state."""
    import chip_smoke

    assert g.step == e1.step == K
    g = _copy(g)
    if _bitwise(e1, e2):
        assert _bitwise(g, e1)
        for name in m1:
            assert torch.equal(gm[name], m1[name]), name
    else:
        drift = chip_smoke.held_state(f"{cell} eager against eager", e2, e1)
        held = chip_smoke.held_state(f"{cell} replay against eager", g, e1)
        print(f"{cell}: eager against eager {drift}; replay against eager {held}")
        torch.testing.assert_close(gm["loss"], m1["loss"], rtol=2e-4, atol=0)


def test_capture_with_garbage_cycles_held_by_the_collector(cuda, monkeypatch):
    """A chain captures with Python's cyclic collector off: garbage cycles
    that hold CUDA graphs and their buffers, one dropped at each step of
    the warm-up and of the capture, under a collector that runs at every
    allocation (gc.set_threshold(1)). A collection inside the capture
    would free a graph and end it; the chain captures, and its replay
    equals eager steps. The collector's thresholds are restored."""
    import gc

    from sse_tpu_torch.train import loop

    s = _setup("gru")
    eager = _eager(s)
    pk = s.packed_variants[1]
    e1, m1 = eager(s.state, pk, s.tgt_tokens, s.tgt_lens)
    e2, _ = eager(s.state, pk, s.tgt_tokens, s.tgt_lens)

    def held_graph():
        x = torch.ones(1 << 20, device="cuda")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = x * 2
        cycle = [graph, x, y]
        cycle.append(cycle)
        return cycle

    pending = [held_graph() for _ in range(2 * (K + 1))]
    real = loop._Draws

    def dropping(*args, **kw):
        if pending:
            pending.pop()  # garbage now: only the collector frees a cycle
        return real(*args, **kw)

    monkeypatch.setattr(loop, "_Draws", dropping)
    thresholds = gc.get_threshold()
    try:
        gc.set_threshold(1)
        s.chain_fn(s.state, s.packed_variants[0], s.tgt_tokens, s.tgt_lens)  # capture
        g, gm = s.chain_fn(s.state, pk, s.tgt_tokens, s.tgt_lens)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*thresholds)
    assert len(pending) < K + 2 and gc.isenabled()
    _held_against_eager("gru", g, gm, e1, e2, m1)


def test_replays_sync_nothing(cuda):
    from sse_tpu_torch.train import loop

    s = _setup("gru")
    host = s.packed_variants[0].cpu().pin_memory()
    state, _ = s.chain_fn(s.state, host, s.tgt_tokens, s.tgt_lens)  # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):  # the state the last replay returned: taken as it is
            state, m = s.chain_fn(state, host, s.tgt_tokens, s.tgt_lens)
        decayed = loop.TrainState(params=state.params, opt_state=state.opt_state,
                                  step=state.step, lr=state.lr * 0.5,
                                  ema_params=state.ema_params)
        state, m = s.chain_fn(decayed, host, s.tgt_tokens, s.tgt_lens)  # lr copied in
        state, m = s.chain_fn(s.state, host, s.tgt_tokens, s.tgt_lens)  # another state
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert state.step == K and torch.isfinite(m["loss"]).all()


def test_capture_refusals_raise(cuda, monkeypatch):
    from sse_tpu_torch.train import loop, losses

    s = _setup("gru")
    cfg = loop.TrainConfig(batch_size=len(s.lengths), steps_per_dispatch=K,
                           loss=loop.LossConfig(kind="sampled", num_negatives=s.num_negatives))
    hooked = loop.make_train_step(s.model_cfg, cfg, packed_width=s.max_seq_length, chain=K,
                                  sample_negatives=lambda step, n, k: torch.zeros(k))
    with pytest.raises(ValueError, match="sample_negatives"):
        hooked(s.state, s.packed_variants[0], s.tgt_tokens, s.tgt_lens)
    real = losses.similarity_loss

    def syncing(*args, **kw):
        loss, acc = real(*args, **kw)
        float(loss)  # a host read: no CUDA graph can hold it
        return loss, acc

    monkeypatch.setattr(losses, "similarity_loss", syncing)
    chain = loop.make_train_step(s.model_cfg, cfg, packed_width=s.max_seq_length, chain=K)
    with pytest.raises(RuntimeError):
        chain(s.state, s.packed_variants[0], s.tgt_tokens, s.tgt_lens)
