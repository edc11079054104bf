"""Dispatch chaining on the CPU: ``make_train_step(chain=K)`` and
``train()`` with ``steps_per_dispatch`` (on a card a chain is one
captured CUDA graph; here its K steps run eagerly, the plain version the
graph is held against in ``tests/test_torch_gpu_chain.py``).

- train() chained (K=3) against unchained (K=1), bit for bit: the final
  params, Adam moments and count, EMA, lr; every step's loss, accuracy
  and grad_norm; every log record but its wall-clock rate. Cases: a GRU
  dual encoder with sampled negatives, Adam, EMA and dropout; the merged
  scan of a shared encoder with the in-batch loss; mining with refresh and
  checkpoint intervals that are not multiples of K; a resume from a step
  inside a chunk, which also ends where the unbroken run ends;
- the port's chain of 3 against JAX's ``make_train_step(chain=3)`` with
  the JAX negatives injected, within ``test_train_step_matches_jax``'s
  tolerances (step 1's metrics to 1e-3 relative; the 3-step change of the
  params and of the EMA to 3e-2 of each leaf's max-abs);
- train()'s chunks against JAX's, call for call;
- Adam's device count through a checkpoint (an int in the file), the
  JAX converter and a grid;
- ``ops.GraphLaunches``: a capture counts nothing, each replay counts its
  launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.data import synthetic
from sse_tpu.data.corpus import build_vocab, encode_pairs, encode_target_space
from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu.train import loop as jloop
from sse_tpu.train import losses as jlosses
from sse_tpu_torch import ops
from sse_tpu_torch.convert import params_from_jax, train_state_from_jax
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.train import loop as tloop
from sse_tpu_torch.train import losses as tlosses
from sse_tpu_torch.train.checkpoint import CheckpointManager

K = 3
TOWER = dict(vocab_size=300, embed_dim=16, hidden=16, encoding_dim=16)


def _corpus():
    rows, _, targets = synthetic.make_corpus(task="ranking", num_targets=8, train_per_target=5,
                                             seed=0)
    vocab = build_vocab(300, rows, targets)
    tspace = encode_target_space(vocab, targets, 10)
    return tspace, encode_pairs(vocab, rows, tspace, 10)  # 40 pairs: 5 batches of 8 an epoch


def _model(mode: str, **tower_kw):
    tower = ttowers.TowerConfig(**TOWER, **tower_kw)
    dual = mode == "dual-encoder"
    return tsse.SSEConfig(mode=tsse.NetworkMode(mode), src_tower=tower,
                          tgt_tower=tower if dual else None)


def _train_cfg(**kw):
    loss = kw.pop("loss")
    base = dict(batch_size=8, learning_rate=0.01, steps_per_checkpoint=5, max_epochs=3)
    return tloop.TrainConfig(loss=tlosses.LossConfig(**loss), **{**base, **kw})


CASES = {
    "gru-dual-sampled-adam-ema-dropout": (
        _model("dual-encoder", dropout=0.2),
        _train_cfg(loss=dict(kind="sampled", num_negatives=4), ema_decay=0.9)),
    "merged-scan-shared-inbatch": (
        _model("shared-encoder"),
        _train_cfg(loss=dict(kind="inbatch"), ema_decay=0.5)),
    "mining-refresh-4-checkpoint-7": (
        _model("dual-encoder"),
        _train_cfg(loss=dict(kind="sampled", num_negatives=4, num_hard_negatives=2),
                   hard_negative_refresh=4, steps_per_checkpoint=7, max_epochs=5)),
}


def _run(monkeypatch, model, cfg, k, state=None, scored=True):
    """train() at ``steps_per_dispatch=k`` → (final state, [(steps in the
    call, its metrics)], log records). With ``scored`` a scripted eval
    (the plateau decay fires) that also reads the inference params."""
    tspace, pairs = _corpus()
    calls = []
    real = tloop.make_train_step

    def factory(*args, **kwargs):
        fn = real(*args, **kwargs)

        def wrapped(state, packed, *rest, **kw):
            new, m = fn(state, packed, *rest, **kw)
            calls.append((packed.shape[0] if packed.ndim == 3 else 1,
                          {name: v.clone() for name, v in m.items()}))
            return new, m

        return wrapped

    scores = iter([0.5, 0.3, 0.6, 0.4, 0.2, 0.7] * 4)

    def evaluate(params):
        total = sum(float(x.double().sum()) for x in tloop.tree_leaves(params))
        return {"recall@1": next(scores), "param_sum": total}

    records = []
    monkeypatch.setattr(tloop, "make_train_step", factory)
    try:
        final = tloop.train(model, dataclasses.replace(cfg, steps_per_dispatch=k), pairs, tspace,
                            eval_fn=evaluate if scored else None, log_fn=records.append,
                            state=state, device="cpu")
    finally:
        monkeypatch.undo()
    return final, calls, records


def _same_state(a, b):
    assert a.step == b.step
    la, lb = tloop._state_leaves(a), tloop._state_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _per_step(calls):
    """Each metric over the run's steps, in order."""
    return {name: torch.cat([m[name].reshape(-1) for _, m in calls]) for name in calls[0][1]}


def _same_run(chained, unchained):
    (cs, ccalls, crec), (us, ucalls, urec) = chained, unchained
    _same_state(cs, us)
    assert {n for n, _ in ucalls} == {1} and K in {n for n, _ in ccalls}
    got, want = _per_step(ccalls), _per_step(ucalls)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    def strip(recs):  # all but the wall-clock rate
        return [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in recs]

    assert strip(crec) == strip(urec) and len(crec) > 1


@pytest.mark.parametrize("case", list(CASES))
def test_chained_train_equals_unchained(monkeypatch, case):
    model, cfg = CASES[case]
    chained = _run(monkeypatch, model, cfg, K)
    unchained = _run(monkeypatch, model, cfg, 1)
    _same_run(chained, unchained)
    assert len({r["lr"] for r in chained[2]}) > 1  # the plateau decay fired
    assert (chained[0].ema_params is not None) == (cfg.ema_decay > 0)
    assert int(chained[0].opt_state.count) == chained[0].step == 5 * cfg.max_epochs


def test_resume_mid_chunk_draws_what_the_unbroken_run_drew(monkeypatch):
    """Resumed at step 4 (inside a chunk of 3 from step 3), chained and
    unchained runs end bit for bit where the unbroken unchained run ends:
    the same batches, negatives and dropout masks at every step."""
    model, cfg = CASES["gru-dual-sampled-adam-ema-dropout"]
    at = {}
    tspace, pairs = _corpus()
    tloop.train(model, dataclasses.replace(cfg, steps_per_dispatch=1, steps_per_checkpoint=4,
                                           max_epochs=1),
                pairs, tspace, checkpoint_fn=lambda s, step, rec: at.setdefault(step, s),
                device="cpu")
    mid = at[4]
    unbroken = _run(monkeypatch, model, cfg, 1, scored=False)
    resumed = _run(monkeypatch, model, cfg, K, state=mid, scored=False)
    resumed_plain = _run(monkeypatch, model, cfg, 1, state=mid, scored=False)
    _same_run(resumed, resumed_plain)
    _same_state(resumed[0], unbroken[0])
    assert [n for n, _ in resumed[1]][:2] == [1, K]  # step 4 alone, then 5-7 as one chain
    tail = {n: v[4:] for n, v in _per_step(unbroken[1]).items()}
    for name, v in _per_step(resumed[1]).items():
        assert torch.equal(v, tail[name]), name


# ------------------------------------------------- against JAX's chain
V, L, NT, BS, NEG = 120, 6, 40, 8, 8


def test_chain_step_matches_jax_chain():
    """Three SGD steps (lr 0.5, clip 1e9) with EMA 0.9 as one chain in both
    packages, the negatives JAX drew injected: step 1's loss, accuracy and
    grad_norm to 1e-3 relative; the params' and the EMA's change after the
    chain to 3e-2 of each leaf's max-abs (test_train_step_matches_jax's
    tolerances); metrics stacked [3]; the step count 3."""
    tower = dict(vocab_size=V, embed_dim=32, hidden=32, encoding_dim=16)
    jt, tt = jtowers.TowerConfig(**tower), ttowers.TowerConfig(**tower)
    jm = jsse.SSEConfig(mode=jsse.NetworkMode.DUAL_ENCODER, src_tower=jt,
                        tgt_tower=dataclasses.replace(jt, hidden=48))
    tm = tsse.SSEConfig(mode=tsse.NetworkMode.DUAL_ENCODER, src_tower=tt,
                        tgt_tower=dataclasses.replace(tt, hidden=48))
    loss = dict(kind="sampled", num_negatives=NEG)
    train = dict(batch_size=BS, learning_rate=0.5, optimizer="sgd", max_gradient_norm=1e9,
                 ema_decay=0.9, steps_per_dispatch=3)
    jtc = jloop.TrainConfig(loss=jlosses.LossConfig(**loss), **train)
    ttc = tloop.TrainConfig(loss=tlosses.LossConfig(**loss), **train)
    rng = np.random.default_rng(5)
    tgt_tokens = rng.integers(2, V, (NT, L)).astype(np.int32)
    tgt_lens = rng.integers(1, L + 1, NT).astype(np.int32)
    packed = []
    for _ in range(3):
        src = rng.integers(2, V, (BS, L)).astype(np.int32)
        src_len = rng.integers(1, L + 1, BS).astype(np.int32)
        labels = rng.permutation(NT)[:BS].astype(np.int32)
        weight = np.ones(BS, np.float32)
        weight[-1] = 0.0
        packed.append(np.concatenate(
            [src, src_len[:, None], labels[:, None], weight.view(np.int32)[:, None]], 1))
    packed = np.stack(packed)

    def jax_negs(step, n, k):
        key = jax.random.fold_in(jax.random.PRNGKey(jtc.seed), step)
        return torch.from_numpy(np.array(jlosses.sample_negative_rows(key, n, k)))

    js = jloop.init_train_state(jax.random.PRNGKey(0), jm, jtc)
    p0 = params_from_jax(jax.device_get(js.params))
    ts = tloop.TrainState(params=p0, opt_state=None, step=0, lr=torch.tensor(0.5),
                          ema_params=tloop.tree_map(torch.clone, p0))
    jchain = jloop.make_train_step(jm, jtc, donate=False, packed_width=L, chain=3)
    tchain = tloop.make_train_step(tm, ttc, packed_width=L, chain=3, sample_negatives=jax_negs)
    js, jmet = jchain(js, jnp.asarray(packed), jnp.asarray(tgt_tokens), jnp.asarray(tgt_lens))
    ts, tmet = tchain(ts, torch.from_numpy(packed), torch.from_numpy(tgt_tokens),
                      torch.from_numpy(tgt_lens))
    assert ts.step == int(js.step) == 3
    for name in ("loss", "accuracy", "grad_norm"):
        assert tmet[name].shape == (3,) == jmet[name].shape
        np.testing.assert_allclose(float(tmet[name][0]), float(jmet[name][0]), rtol=1e-3,
                                   atol=1e-3, err_msg=name)
    for got_tree, want_tree in ((ts.params, js.params), (ts.ema_params, js.ema_params)):
        for got, want, start in zip(tloop.tree_leaves(got_tree), jax.tree.leaves(want_tree),
                                    tloop.tree_leaves(p0)):
            dg = (start - got).double().numpy()
            dw = start.double().numpy() - np.asarray(want, np.float64)
            assert np.abs(dg - dw).max() <= 3e-2 * (np.abs(dw).max() + 1e-9), start.shape


@pytest.mark.parametrize("start", [0, 7])
def test_train_chunks_match_jax(monkeypatch, start):
    """The steps of each call of train()'s step and chain functions, call
    for call, in both packages: K=3 chains clamped at checkpoints every 4
    steps and mining refreshes every 6, never across an epoch; from step 0
    and resumed at step 7. (JAX's steps are stubbed to return their state:
    its train() loop's chunking is what is compared; the port's steps run.)"""
    tspace, pairs = _corpus()
    jtower = jtowers.TowerConfig(**TOWER)
    jm = jsse.SSEConfig(mode=jsse.NetworkMode.DUAL_ENCODER, src_tower=jtower, tgt_tower=jtower)
    tm = _model("dual-encoder")
    loss = dict(kind="sampled", num_negatives=4, num_hard_negatives=2)
    train = dict(batch_size=8, steps_per_checkpoint=4, steps_per_dispatch=K, max_epochs=4,
                 hard_negative_refresh=6, learning_rate=0.01)
    jtc = jloop.TrainConfig(loss=jlosses.LossConfig(**loss), **train)
    ttc = tloop.TrainConfig(loss=tlosses.LossConfig(**loss), **train)

    def stub(*args, **kwargs):
        def step(state, packed, *rest, **kw):
            return state, {"loss": jnp.zeros(packed.shape[:1] if packed.ndim == 3 else ())}

        return step

    sizes = {}
    for mod, make, run in (
        (jloop, stub, lambda: jloop.train(jm, jtc, pairs, tspace, state=dataclasses.replace(
            jloop.init_train_state(jax.random.PRNGKey(0), jm, jtc),
            step=jnp.asarray(start, jnp.int32)))),
        (tloop, tloop.make_train_step, lambda: tloop.train(
            tm, ttc, pairs, tspace, state=dataclasses.replace(
                tloop.init_train_state(tm, ttc, device="cpu"), step=start))),
    ):
        calls = []

        def factory(*args, _make=make, _calls=calls, **kwargs):
            fn = _make(*args, **kwargs)

            def wrapped(state, packed, *rest, **kw):
                _calls.append(int(packed.shape[0]) if packed.ndim == 3 else 1)
                return fn(state, packed, *rest, **kw)

            return wrapped

        monkeypatch.setattr(mod, "make_train_step", factory)
        try:
            final = run()
        finally:
            monkeypatch.undo()
        sizes[mod.__name__] = calls
    jsizes, tsizes = sizes.values()
    assert tsizes == jsizes and K in tsizes and 1 in tsizes
    assert sum(tsizes) == 20 - start and final.step == 20


# ------------------------------------------------------------ the state
def test_adam_count_round_trips(tmp_path):
    """Adam's count is an int32 scalar on the params' device; the
    checkpoint keeps an int in its file and restores the tensor; the JAX
    converter and a grid's place_state / gather_state carry it."""
    from sse_tpu_torch.parallel import make_mesh
    from sse_tpu_torch.train.grid import gather_state, place_state

    model, cfg = CASES["gru-dual-sampled-adam-ema-dropout"]
    s = tloop.init_train_state(model, cfg, device="cpu")
    assert s.opt_state.count.dtype == torch.int32 and s.opt_state.count.shape == ()
    s = dataclasses.replace(s, step=7, opt_state=s.opt_state._replace(
        count=tloop.adam_count(7, "cpu")))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(s, 7)
    saved = torch.load(mgr._path(7, "state.pt"), weights_only=True)
    assert type(saved["opt_state"]["count"]) is int and saved["opt_state"]["count"] == 7
    back = mgr.restore(tloop.init_train_state(model, cfg, device="cpu"))
    assert back.opt_state.count.dtype == torch.int32 and int(back.opt_state.count) == 7

    jtower = jtowers.TowerConfig(**TOWER)
    jm = jsse.SSEConfig(mode=jsse.NetworkMode.DUAL_ENCODER, src_tower=jtower, tgt_tower=jtower)
    jtc = jloop.TrainConfig(loss=jlosses.LossConfig(kind="sampled", num_negatives=4))
    js = jloop.init_train_state(jax.random.PRNGKey(0), jm, jtc)
    adam = js.opt_state[-1]._replace(count=jnp.asarray(5, jnp.int32))
    js = dataclasses.replace(js, opt_state=(*js.opt_state[:-1], adam))
    conv = train_state_from_jax(jax.tree.map(np.asarray, js))
    assert conv.opt_state.count.dtype == torch.int32 and int(conv.opt_state.count) == 5

    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    placed = place_state(s, mesh)
    assert isinstance(placed.opt_state.count, torch.Tensor) and int(placed.opt_state.count) == 7
    whole = gather_state(placed)
    assert whole.opt_state.count.dtype == torch.int32 and int(whole.opt_state.count) == 7


def test_graph_launches_count_each_replay():
    from sse_tpu_torch.ops import rnn, topk

    ops.reset_launch_counts()
    rnn.launches["gru_fwd"] += 1  # a launch before the capture
    counted = ops.GraphLaunches()
    with counted.capturing():
        rnn.launches["gru_fwd"] += 2
        rnn.launches["gru_bwd"] += 2
        topk.launches["topk_stream", 8] += 1
    assert ops.launch_counts() == {**dict.fromkeys(ops.launch_counts(), 0), "gru_fwd": 1}
    counted.replayed()
    counted.replayed()
    got = ops.launch_counts()
    assert (got["gru_fwd"], got["gru_bwd"], got["topk_stream"]) == (5, 4, 2)
    assert topk.launches["topk_stream", 8] == 2
    ops.reset_launch_counts()


def test_chain_refuses_what_it_cannot_take():
    model, cfg = CASES["merged-scan-shared-inbatch"]
    with pytest.raises(ValueError, match="packed"):
        tloop.make_train_step(model, cfg, chain=K)
    chain = tloop.make_train_step(model, cfg, packed_width=10, chain=K)
    state = tloop.init_train_state(model, cfg, device="cpu")
    tspace, _ = _corpus()
    with pytest.raises(ValueError, match="chain of 3 steps got 2"):
        chain(state, torch.zeros((2, 8, 13), dtype=torch.int32),
              torch.from_numpy(np.asarray(tspace.tokens)),
              torch.from_numpy(np.asarray(tspace.lengths)))


@pytest.mark.parametrize("on", [True, False])
def test_chain_captures_with_the_collector_off(monkeypatch, on):
    """A chain's capture (``_GraphChain``, with torch.cuda's graph, streams
    and capture replaced by stand-ins that record the collector's state)
    runs with Python's cyclic collector off, as ``utils/graphs.py``'s
    captures do: a collection there could free an earlier CUDA graph and
    end the capture. Afterwards the collector is as it was, also after a
    capture that fails."""
    import contextlib
    import gc

    seen = []

    class Graph:
        def register_generator_state(self, g):
            pass

    class Stream:
        def __init__(self, *args, **kw):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def capture(graph, *args, **kw):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *args: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", capture)
    model, cfg = CASES["merged-scan-shared-inbatch"]
    state = tloop.init_train_state(model, cfg, device="cpu")
    tspace, _ = _corpus()
    tokens = torch.from_numpy(np.asarray(tspace.tokens))
    lengths = torch.from_numpy(np.asarray(tspace.lengths))
    calls = []

    def step(state, packed, tokens, lengths, cache, draws):
        calls.append(gc.isenabled())
        if len(calls) == 3 and fail:
            raise RuntimeError("not capturable")
        return state, {"loss": torch.zeros(())}

    was = gc.isenabled()
    (gc.enable if on else gc.disable)()
    try:
        for fail in (False, True):
            calls.clear()
            with pytest.raises(RuntimeError) if fail else contextlib.nullcontext():
                tloop._GraphChain(step, K, 0, False, False, state,
                                  torch.zeros((K, 8, 13), dtype=torch.int32), tokens, lengths,
                                  None)
            assert calls[:3] == [on, False, False]  # the warm-up, then the capture's steps
            assert gc.isenabled() == on
        assert seen == [False, False]
    finally:
        (gc.enable if was else gc.disable)()
