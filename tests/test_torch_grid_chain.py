"""The grid train step as per-card segments, and its chain, on the CPU.

The grids here are made of distinct CPU labels (``torch.device("cpu",
i)``), so a step cuts where a card would: the CPU tensors drop the label,
the step's own bookkeeping keeps it.

- The segmented grid step (``grid.make_grid_step``, every call of it a
  segment with its own autograd graph, run eagerly here) equals the plain
  step (``segmented=False``: one autograd graph over every card, the step
  as it was) bit for bit: params, Adam's count and moments, lr, EMA and
  metrics after two steps, on (2, 1), (4, 1), (1, 2) and (2, 2), for the
  sampled softmax with mined negatives, dropout and EMA (dual encoder,
  multi-label rows), the in-batch softmax (one tower pass, bidirectional)
  and the full softmax over a source-encoder-only table of 256 rows in
  'model' blocks.
- ``_BlockSoftmax.backward`` with fixed shapes (no ``nonzero()``) equals
  the boolean-indexed add it replaced bit for bit: labels inside and
  outside the block, masked label columns, -0.0 entries (end to end, and
  the label column's add alone on a chunk of -0.0).
- A grid chain of K=3 (``loop._GridChain``, with a stand-in for the
  recorder of CUDA graphs that replays by running its steps again, as no
  card is here) equals 3 single grid steps bit for bit, from a state of
  its own, from the state its last replay returned, and with a rebound
  lr.
- ``train(mesh=)`` through that chain at ``steps_per_dispatch`` 4 logs the
  same steps and losses as at 1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sse_tpu_torch.data.batching import Batch
from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.parallel import make_mesh
from sse_tpu_torch.train import grid
from sse_tpu_torch.train import loop as tloop
from sse_tpu_torch.train import losses as tlosses
from sse_tpu_torch.utils import graphs

V, L, B = 50, 10, 8
GRIDS = [(2, 1), (4, 1), (1, 2), (2, 2)]
CASES = {
    "sampled-mined-dropout-ema": dict(mode="dual-encoder", t=64, dropout=0.1, ema=0.99,
                                      multi=True, loss=dict(kind="sampled", num_negatives=8,
                                                            num_hard_negatives=2)),
    "inbatch": dict(mode="shared-encoder", t=64, loss=dict(kind="inbatch", bidirectional=True)),
    "full-table": dict(mode="source-encoder-only", t=256, dropout=0.1, ema=0.9,
                       loss=dict(kind="full")),
}


def _labels(shape):
    return make_mesh(*shape, devices=[torch.device("cpu", i) for i in range(shape[0] * shape[1])])


def _cfgs(case):
    tower = ttowers.TowerConfig(vocab_size=V, embed_dim=16, hidden=16, encoding_dim=8,
                                dropout=case.get("dropout", 0.0))
    extra = {"dual-encoder": dict(tgt_tower=tower),
             "source-encoder-only": dict(num_targets=case["t"])}.get(case["mode"], {})
    mc = tsse.SSEConfig(mode=tsse.NetworkMode(case["mode"]), src_tower=tower, **extra)
    tc = tloop.TrainConfig(batch_size=B, learning_rate=0.05, ema_decay=case.get("ema", 0.0),
                           loss=tlosses.LossConfig(**case["loss"]))
    return mc, tc


def _batch(t, seed, multi):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, t, size=B).astype(np.int32)
    lm = None
    if multi:  # a third of the rows carry a second label
        lm = np.full((B, 2), -1, np.int32)
        lm[:, 0] = labels
        take = rng.random(B) < 0.35
        lm[take, 1] = ((labels + 1 + rng.integers(0, t - 1, size=B)) % t)[take]
    weight = np.ones(B, np.float32)
    weight[-1] = 0.0
    return Batch(rng.integers(2, V, size=(B, L)).astype(np.int32),
                 rng.integers(2, L + 1, size=B).astype(np.int32), labels, weight, lm)


def _targets(t):
    rng = np.random.default_rng(99)
    return (torch.from_numpy(rng.integers(2, V, size=(t, L)).astype(np.int32)),
            torch.from_numpy(rng.integers(1, L + 1, size=t).astype(np.int32)))


def _cache(mc, case, state, tt, tl):
    if not case["loss"].get("num_hard_negatives"):
        return None
    params = tloop.inference_params(dataclasses.replace(state, ema_params=None))
    kw = {} if case["mode"] == "source-encoder-only" else dict(tokens=tt, lengths=tl)
    with torch.no_grad():
        return tsse.target_embeddings(params, mc, **kw)


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _same_state(a, b):
    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(grid.state_tensors(a), grid.state_tensors(b)))


@pytest.mark.parametrize("shape", GRIDS, ids=str)
@pytest.mark.parametrize("name", list(CASES))
def test_segmented_step_equals_plain_step(monkeypatch, name, shape):
    case = CASES[name]
    mc, tc = _cfgs(case)
    mesh = _labels(shape)
    tt, tl = _targets(case["t"])
    cuts = []
    real = grid._Segments.grads
    monkeypatch.setattr(grid._Segments, "grads",
                        lambda self, *a: cuts.append(len(self.calls)) or real(self, *a))
    runs = {}
    for segmented in (False, True):
        state = grid.place_state(tloop.init_train_state(mc, tc, device="cpu"), mesh)
        step = grid.make_grid_step(mc, tc, mesh, segmented=segmented)
        metrics = []
        for s in range(2):
            bt = _batch(case["t"], 10 + s, case.get("multi", False))
            args = [None if a is None else torch.from_numpy(a)
                    for a in (bt.src, bt.src_len, bt.labels, bt.weight, bt.labels_multi)]
            state, m = step(state, *args[:4], tt, tl, _cache(mc, case, state, tt, tl), args[4])
            metrics.append(m)
        runs[segmented] = (state, metrics)
    assert len(cuts) == 2 and min(cuts) > 4  # the segmented run cut each step into calls
    (plain, pm), (seg, sm) = runs[False], runs[True]
    assert seg.step == plain.step == 2
    assert _same_state(seg, plain)
    for a, b in zip(sm, pm):
        assert all(torch.equal(_bits(a[k]), _bits(b[k])) for k in b), (a, b)
    assert grid.copies_identical(seg)


def _old_block_backward(src, tbl, labels, extra, col0, scale, margin, lse, g_lse, g_ll):
    """The block softmax's backward as it was: the label column's entries
    gain g_ll through a boolean index (``nonzero()``, a host sync)."""
    d_src = torch.zeros_like(src)
    d_tbl = torch.empty_like(tbl)
    for lo, hi in tlosses._chunks(tbl.shape[0], src.shape[0]):
        logits = tlosses._block_logits(src, tbl[lo:hi], labels, extra, col0 + lo, scale, margin)
        d = torch.exp(logits - lse[:, None]) * g_lse[:, None]
        local = labels - (col0 + lo)
        here = (local >= 0) & (local < hi - lo)
        if extra is not None:
            here &= ~(extra == labels[:, None]).any(dim=1)
        here = here.nonzero()[:, 0]
        d[here, local[here]] += g_ll[here]
        d = d * scale
        d_src += d @ tbl[lo:hi]
        d_tbl[lo:hi] = d.t() @ src
    return d_src, d_tbl


@pytest.mark.parametrize("kind", ["labels-in-and-out", "masked-label-columns", "negative-zeros"])
def test_block_softmax_backward_without_nonzero(monkeypatch, kind):
    """Column chunks of 3 (BLOCK_LOGITS 3 columns of 8 rows) over a 10-row
    block whose global columns start at 4; labels below, inside and past
    it. ``negative-zeros``: a logit scale of 400 underflows most of
    exp(logits - lse), and a negative cotangent of the log-sum-exp makes
    those entries -0.0, which a masked add of 0.0 would turn to +0.0."""
    monkeypatch.setattr(tlosses, "BLOCK_LOGITS", 3 * 8)
    gen = torch.Generator().manual_seed(7)
    b, t, col0 = 8, 10, 4
    src = torch.nn.functional.normalize(torch.randn(b, 6, generator=gen), dim=1)
    tbl = torch.nn.functional.normalize(torch.randn(t, 6, generator=gen), dim=1)
    labels = torch.tensor([0, 3, 4, 7, 9, 13, 14, 20])
    lm = None
    scale = 400.0 if kind == "negative-zeros" else 20.0
    if kind == "masked-label-columns":  # rows 2 and 3 list their own label again: masked
        lm = torch.stack([labels, torch.tensor([-1, 5, 4, 7, -1, 2, 6, -1])], dim=1)
    extra = None if lm is None else lm[:, 1:].contiguous()
    s, w = src.clone().requires_grad_(True), tbl.clone().requires_grad_(True)
    lse, ll, _, _ = tlosses.block_softmax(s, w, labels, col0, scale, 0.1, lm)
    g_lse = torch.randn(b, generator=gen) - (1.0 if kind == "negative-zeros" else 0.0)
    g_ll = torch.randn(b, generator=gen)
    got = torch.autograd.grad([lse, ll], [s, w], grad_outputs=[g_lse, g_ll])
    want = _old_block_backward(src, tbl, labels, extra, col0, scale, 0.1, lse.detach(), g_lse,
                               g_ll)
    for a, r in zip(got, want):
        assert torch.equal(_bits(a), _bits(r))


def test_label_column_add_keeps_negative_zeros():
    """``losses._add_at_label`` against the boolean-indexed add on a chunk
    of cotangents that holds -0.0 everywhere but two entries: rows whose
    label lies in the chunk gain g_ll (one at a -0.0), rows outside it or
    masked keep their -0.0 at the clamped column, bit for bit."""
    d = torch.full((6, 5), -0.0)
    d[1, 2], d[4, 0] = 0.25, -1.5
    local = torch.tensor([0, 2, -3, 4, 7, 1])
    here = (local >= 0) & (local < 5)
    here[3] = False  # a masked label column
    g_ll = torch.tensor([0.5, -0.75, 2.0, 1.0, 3.0, -0.0])
    want = d.clone()
    idx = here.nonzero()[:, 0]
    want[idx, local[idx]] += g_ll[idx]
    got = tlosses._add_at_label(d.clone(), local, here, g_ll)
    assert torch.equal(_bits(got), _bits(want))
    assert _bits(got)[2, 0] == _bits(torch.tensor(-0.0))  # below the chunk: clamped, kept
    assert _bits(got)[4, 4] == _bits(torch.tensor(-0.0))  # past it: clamped, kept
    assert _bits(got)[3, 4] == _bits(torch.tensor(-0.0))  # masked: kept


class _StandIn:
    """A stand-in for ``graphs.Recorder``: nothing is captured; ``record``
    runs the program once and keeps it, and each replay runs it again on
    the same fixed buffers, as a replay of its graphs would read them."""

    replays = 0

    def __init__(self, cards, per_card=None, split=False):
        self.cards = list(cards)
        self.launches = graphs.GraphLaunches()
        self.on, self.copy, self.new_pass = graphs.EAGER.on, graphs.EAGER.copy, graphs.EAGER.new_pass

    def warm(self, run):
        run()

    def record(self, run):
        self.run = run
        return run()

    def replay(self):
        _StandIn.replays += 1
        return self.run()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "Recorder", _StandIn)
    monkeypatch.setattr(tloop, "_captures", lambda dev: True)
    _StandIn.replays = 0
    return _StandIn


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), "one device"], ids=str)
def test_grid_chain_equals_single_steps(stand_in, shape):
    case = CASES["sampled-mined-dropout-ema"]
    mc, tc = _cfgs(case)
    mesh = make_mesh(2, 1, devices=[torch.device("cpu")] * 2) if shape == "one device" \
        else _labels(shape)
    tt, tl = _targets(case["t"])
    k = 3
    packed = [torch.from_numpy(np.stack([tloop.pack_batch(_batch(case["t"], 30 * c + i, True))
                                         for i in range(k)])) for c in range(2)]
    single = tloop.make_train_step(mc, tc, packed_width=L, num_label_cols=2, mesh=mesh)
    chain = tloop.make_train_step(mc, tc, packed_width=L, num_label_cols=2, mesh=mesh, chain=k)
    state = grid.place_state(tloop.init_train_state(mc, tc, device="cpu"), mesh)
    cache = _cache(mc, case, state, tt, tl)

    def singles(s, chunk):
        ms = []
        for i in range(k):
            s, m = single(s, chunk[i], tt, tl, cache)
            ms.append(m)
        return s, {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    ref, rm = singles(state, packed[0])
    got, gm = chain(state, packed[0], tt, tl, cache)
    assert got.step == ref.step == k and _same_state(got, ref)
    assert all(torch.equal(_bits(gm[key]), _bits(rm[key])) for key in rm)
    ref2, rm2 = singles(ref, packed[1])  # from the state the last replay returned
    got2, gm2 = chain(got, packed[1], tt, tl, cache)
    assert got2.step == 2 * k and _same_state(got2, ref2)
    assert all(torch.equal(_bits(gm2[key]), _bits(rm2[key])) for key in rm2)
    halved = dataclasses.replace(ref2, lr=ref2.lr * 0.5)  # a rebound lr is copied in
    ref3, _ = singles(halved, packed[0])
    got3, _ = chain(dataclasses.replace(got2, lr=got2.lr * 0.5), packed[0], tt, tl, cache)
    assert _same_state(got3, ref3)
    assert stand_in.replays == 3


def test_train_on_a_grid_chains_as_unchained(stand_in):
    """train(mesh=) on a (2, 1) grid of labels, 2 epochs of 6 steps, a log
    record and a mining refresh every 4 steps: steps 1-4 and 9-12 as chunks
    through the chain, 5-8 as single steps (an epoch's tail, then a chunk
    cut at the boundary), against steps_per_dispatch 1."""
    case = CASES["sampled-mined-dropout-ema"]
    mc, tc = _cfgs(case)
    t, n = case["t"], 48
    rng = np.random.default_rng(0)
    pairs = EncodedPairs(src=rng.integers(2, V, size=(n, L)).astype(np.int32),
                         src_len=rng.integers(2, L + 1, size=n).astype(np.int32),
                         labels=rng.integers(0, t, size=n).astype(np.int32),
                         label_sets=[(0,)] * n)
    tt, tl = _targets(t)
    tspace = TargetSpace(ids=[f"t{i}" for i in range(t)], texts=["x"] * t, tokens=tt.numpy(),
                         lengths=tl.numpy(), id_to_row={f"t{i}": i for i in range(t)})
    logs = {}
    for k in (4, 1):
        cfg = dataclasses.replace(tc, max_epochs=2, steps_per_checkpoint=4,
                                  hard_negative_refresh=4, steps_per_dispatch=k)
        records = []
        state = tloop.train(mc, cfg, pairs, tspace, log_fn=records.append, mesh=_labels((2, 1)),
                            device="cpu")
        logs[k] = (state, records)
    assert stand_in.replays == 2
    (chained, r4), (single, r1) = logs[4], logs[1]
    assert [r["step"] for r in r4] == [r["step"] for r in r1] == [4, 8, 12]
    assert [r["loss"] for r in r4] == [r["loss"] for r in r1]
    assert chained.step == single.step == 12 and _same_state(chained, single)
