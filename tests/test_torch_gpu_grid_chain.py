"""The grid's chain of train steps on CUDA cards (marker ``gpu``; skips
where torch sees no card, the two-card tests below two cards). Run on the
card with ``python -m pytest --noconftest tests/test_torch_gpu_grid_chain.py``.

``make_train_step(mesh=, chain=K)`` on a single-process grid of cards
captures K grid steps (``loop._GridChain``) and replays them:

- on one card, every grid entry on it (a (2, 1) grid of the ranking
  preset's loss, a (1, 2) grid of the classification preset's with its
  table in 'model' blocks, B=64, K=8): a replay from a state against the
  eager chain of K grid steps from that state, bit for bit where two
  eager runs are bit for bit on the card (else as
  ``chip_smoke.held_state`` holds a state); one graph and one replay a
  chunk; the recurrent kernels of a replayed step launched data times
  the one-card step's; replays under ``torch.cuda.set_sync_debug_mode
  ("error")`` from the state the last replay returned, with a rebound lr
  and from another state, the chunk uploaded from pinned memory;
- the segments on one card (``segmented="always"``, one graph a call of
  the step: a forward and its backward in separate graphs of one pool):
  a replay against the eager segmented chain, as above;
- across two cards (a (2, 1) and a (1, 2) grid of cuda:0 and cuda:1): a
  replay against the eager chain as above, and a second one carrying the
  state the first returned (the next steps' seeds: each card's
  generators read on that card), several graphs a card and the copies
  between them, every copy of the state identical, replays under sync
  debug "error";
- the injected negatives hook is refused, and a step that reads the
  device on the host raises in its capture.
"""

import dataclasses

import numpy as np
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
    return torch.cuda.device_count()


def _problem(task: str, shape, cards: int, b: int = 64):
    """(model config, train config, mesh, state on it, [two chunks of K
    packed batches], target tokens, lengths, the mining cache (all
    ``Replicated``)) of the ``ranking`` (GRU dual encoder, sampled and
    mined negatives, multi-label rows, 1,024 targets) or
    ``classification`` (full softmax over a 4,096-row table, dropout, EMA)
    preset at B=b, grid entry i on cuda:(i mod cards)."""
    from sse_tpu_torch import configs
    from sse_tpu_torch.data.batching import Batch
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.parallel.mesh import Replicated
    from sse_tpu_torch.train import grid, init_train_state, loop

    t, length = (1024, 50) if task == "ranking" else (4096, 50)
    preset = configs.preset(task, batch_size=b, steps_per_dispatch=K)
    mc, tc = preset.model_config(8000, t), preset.train_config()
    n = shape[0] * shape[1]
    mesh = make_mesh(*shape, devices=[torch.device("cuda", i % cards) for i in range(n)])
    rng = np.random.default_rng(3)
    multi = task == "ranking"

    def batch():
        labels = rng.integers(0, t, size=b).astype(np.int32)
        lm = None
        if multi:
            lm = np.full((b, 2), -1, np.int32)
            lm[:, 0] = labels
            take = rng.random(b) < 0.25
            lm[take, 1] = rng.integers(0, t, size=b)[take]
        return loop.pack_batch(Batch(rng.integers(2, 8000, size=(b, length)).astype(np.int32),
                                     rng.integers(1, length + 1, size=b).astype(np.int32),
                                     labels, np.ones(b, np.float32), lm))

    chunks = [torch.from_numpy(np.stack([batch() for _ in range(K)])).cuda() for _ in range(2)]
    lead = mesh.local_devices[0]
    copies = lambda x: Replicated({c: x.to(c) for c in mesh.local_devices})  # noqa: E731
    tt = torch.from_numpy(rng.integers(2, 8000, size=(t, length)).astype(np.int32)).to(lead)
    tl = torch.from_numpy(rng.integers(1, length + 1, size=t).astype(np.int32)).to(lead)
    state = grid.place_state(init_train_state(mc, tc, device=lead), mesh)
    cache = None
    if multi:
        with torch.no_grad():
            cache = copies(loop.sse.target_embeddings(loop.inference_params(state), mc,
                                                      tokens=tt, lengths=tl))
    return mc, tc, mesh, state, chunks, copies(tt), copies(tl), cache, 2 if multi else 1


def _copy(state):
    from sse_tpu_torch.train import grid

    return grid.with_tensors(state, [x.clone() for x in grid.state_tensors(state)], state.step)


def _bitwise(a, b) -> bool:
    from sse_tpu_torch.train import grid

    return all(torch.equal(x, y) for x, y in zip(grid.state_tensors(a), grid.state_tensors(b)))


def _held(label, got, e1, e2, gm, m1):
    """The replay against the eager chain: bit for bit where two eager
    runs are, else as chip_smoke holds a state."""
    import chip_smoke
    from sse_tpu_torch.train import grid

    if _bitwise(e1, e2):
        assert _bitwise(got, e1), label
        for name in m1:
            assert torch.equal(gm[name], m1[name]), (label, name)
        return "bit for bit"
    drift = chip_smoke.held_state(f"{label} eager against eager", grid.gather_state(e2),
                                  grid.gather_state(e1))
    held = chip_smoke.held_state(f"{label} replay against eager", grid.gather_state(got),
                                 grid.gather_state(e1))
    torch.testing.assert_close(gm["loss"], m1["loss"], rtol=2e-4, atol=0)
    return f"eager against eager {drift}; replay against eager {held}"


def _chains(task, shape, cards, segmented=True, split=False):
    """(problem, the eager chain, the captured chain function, a capture
    of the chain built by hand where ``segmented``/``split`` ask for one)."""
    from sse_tpu_torch.train import grid, loop

    mc, tc, mesh, state, chunks, tt, tl, cache, cols = p = _problem(task, shape, cards)
    packed = loop._packed(grid.make_grid_step(mc, tc, mesh, segmented=segmented), 50, cols)
    eager = loop._eager_chain(packed, K)
    if segmented == "always":
        use_dropout, _ = loop.step_plan(mc, tc)
        made = loop._GridChain(packed, K, tc, tc.loss.kind == "sampled", use_dropout, state,
                               chunks[0], tt, tl, cache, split=split)
        return p, eager, made
    return p, eager, loop.make_train_step(mc, tc, packed_width=50, num_label_cols=cols,
                                          mesh=mesh, chain=K)


def _launches_a_step(mc, tc, chunk, tt, tl, cache, cols):
    """The recurrent launches of one step on one card (no grid)."""
    from sse_tpu_torch import ops
    from sse_tpu_torch.train import init_train_state, loop

    one = loop.make_train_step(mc, tc, packed_width=50, num_label_cols=cols)
    s = init_train_state(mc, tc, device="cuda")
    on = lambda x: None if x is None else next(iter(x.values()))  # noqa: E731
    ops.reset_launch_counts()
    one(s, chunk[0], on(tt), on(tl), on(cache))
    torch.cuda.synchronize()
    return {n: c for n, c in ops.launch_counts().items() if n.startswith(("gru", "lstm", "rnn"))}


@pytest.mark.parametrize("task,shape", [("ranking", (2, 1)), ("classification", (1, 2))],
                         ids=str)
def test_one_card_replay_matches_eager_chain(cuda, task, shape):
    from sse_tpu_torch import ops

    (mc, tc, mesh, state, chunks, tt, tl, cache, cols), eager, chain = _chains(task, shape, 1)
    e1, m1 = eager(state, chunks[1], tt, tl, cache)
    e1 = _copy(e1)
    e2, _ = eager(state, chunks[1], tt, tl, cache)
    chain(state, chunks[0], tt, tl, cache)  # capture
    made = next(iter(chain.chains.values()))
    assert made.rec.graphs == {mesh.local_devices[0]: 1}
    assert [a[0] for a in made.rec.actions] == ["graph"]
    ops.reset_launch_counts()
    got, gm = chain(state, chunks[1], tt, tl, cache)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(task, shape, _held(f"{task} {shape}", _copy(got), e1, e2, gm, m1))
    per_step = _launches_a_step(mc, tc, chunks[1], tt, tl, cache, cols)
    for name, n in per_step.items():
        assert counts[name] == shape[0] * n * K, (name, counts, per_step)
    assert any(n > 0 for n in per_step.values())


@pytest.mark.parametrize("task,shape", [("ranking", (2, 1)), ("classification", (1, 2))],
                         ids=str)
def test_replays_sync_nothing(cuda, task, shape):
    from sse_tpu_torch.train import grid

    (_, _, _, state, chunks, tt, tl, cache, _), _, chain = _chains(task, shape, min(cuda, 2))
    host = chunks[0].cpu().pin_memory()
    new, _ = chain(state, host, tt, tl, cache)  # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):  # the state the last replay returned: taken as it is
            new, m = chain(new, host, tt, tl, cache)
        new, m = chain(dataclasses.replace(new, lr=new.lr * 0.5), host, tt, tl,
                       cache)  # lr copied in
        new, m = chain(state, host, tt, tl, cache)  # another state
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert new.step == K and bool(torch.isfinite(m["loss"]).all())
    assert grid.copies_identical(new)


def test_segments_on_one_card_replay_as_eager(cuda):
    """The segmented step forced on one card, each call of it a graph of
    its own in the card's pool, replayed in capture order."""
    from sse_tpu_torch import ops

    (mc, tc, mesh, state, chunks, tt, tl, cache, cols), eager, made = _chains(
        "ranking", (2, 1), 1, segmented="always", split=True)
    e1, m1 = eager(state, chunks[1], tt, tl, cache)
    e1 = _copy(e1)
    e2, _ = eager(state, chunks[1], tt, tl, cache)
    assert made.rec.graphs[mesh.local_devices[0]] > 10 * K
    ops.reset_launch_counts()
    got, gm = made(state, chunks[1], tt, tl, cache)
    torch.cuda.synchronize()
    print("segments on one card:", made.rec.graphs, _held("segments", _copy(got), e1, e2, gm, m1))


@pytest.mark.parametrize("task,shape", [("ranking", (2, 1)), ("classification", (1, 2))],
                         ids=str)
def test_two_card_replay_matches_eager_chain(cuda, task, shape):
    from sse_tpu_torch import ops
    from sse_tpu_torch.train import grid

    if cuda < 2:
        pytest.skip("needs two cards")
    (mc, tc, mesh, state, chunks, tt, tl, cache, cols), eager, chain = _chains(task, shape, 2)
    e1, m1 = eager(state, chunks[1], tt, tl, cache)
    e1 = _copy(e1)
    e2, _ = eager(state, chunks[1], tt, tl, cache)
    chain(state, chunks[0], tt, tl, cache)  # capture
    made = next(iter(chain.chains.values()))
    assert set(made.rec.graphs) == set(mesh.local_devices)
    assert any(a[0] == "copy" for a in made.rec.actions)
    ops.reset_launch_counts()
    got, gm = chain(state, chunks[1], tt, tl, cache)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(task, shape, "two cards:", dict(made.rec.graphs),
          sum(a[0] == "copy" for a in made.rec.actions), "copies,",
          _held(f"{task} {shape} two cards", _copy(got), e1, e2, gm, m1))
    assert grid.copies_identical(got)
    # a replay carrying the state the last returned draws the next steps' rows: each card's
    # generators must be read on that card
    e3, m3 = eager(e1, chunks[0], tt, tl, cache)
    e4, _ = eager(_copy(e1), chunks[0], tt, tl, cache)
    got2, gm2 = chain(got, chunks[0], tt, tl, cache)
    print(task, shape, "two cards, carried:",
          _held(f"{task} {shape} two cards carried", _copy(got2), e3, e4, gm2, m3))
    per_step = _launches_a_step(mc, tc, chunks[1], tt, tl, cache, cols)
    for name, n in per_step.items():
        assert counts[name] == shape[0] * n * K, (name, counts, per_step)


def test_capture_refusals_raise(cuda, monkeypatch):
    """The injected negatives hook is refused; a step that reads the device
    on the host cannot be captured, and the capture raises."""
    from sse_tpu_torch.train import loop, losses

    mc, tc, mesh, state, chunks, tt, tl, cache, cols = _problem("ranking", (2, 1), 1)
    hooked = loop.make_train_step(mc, tc, packed_width=50, num_label_cols=cols, mesh=mesh,
                                  chain=K, sample_negatives=lambda step, n, k: torch.zeros(k))
    with pytest.raises(ValueError, match="sample_negatives"):
        hooked(state, chunks[0], tt, tl, cache)
    real = losses.similarity_loss

    def syncing(*args, **kw):
        loss, acc = real(*args, **kw)
        float(loss)  # a host read: no CUDA graph can hold it
        return loss, acc

    monkeypatch.setattr(losses, "similarity_loss", syncing)
    chain = loop.make_train_step(mc, tc, packed_width=50, num_label_cols=cols, mesh=mesh, chain=K)
    with pytest.raises(RuntimeError):
        chain(state, chunks[0], tt, tl, cache)
