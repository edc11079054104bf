"""The port's checkpoints (``sse_tpu_torch.train.checkpoint``) against the
JAX package's Orbax manager (``sse_tpu.train.checkpoint``).

- a TrainState (params, Adam count/mu/nu, lr, step, EMA params) saves and
  restores bit for bit; a restore into another structure raises;
- for one sequence of saves and metrics both managers keep the same steps
  and report the same latest and best step (max_to_keep, keep-the-best,
  a metric missing or absent, ties, a save at or below the latest step);
- a save cut off before its rename leaves the previous step the latest,
  and the next manager removes the partial one;
- a JAX-trained state restored by ``sse_tpu`` and converted with
  ``convert.train_state_from_jax`` saves and restores in the port and
  scores the same Evaluator recall as in JAX (exactly equal: the same
  float32 scoring of the same params).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu import configs as jconfigs
from sse_tpu.data import synthetic
from sse_tpu.data.corpus import build_vocab, encode_pairs, encode_target_space
from sse_tpu.evals import recall as jrecall
from sse_tpu.train import loop as jloop
from sse_tpu.train.checkpoint import CheckpointManager as JaxManager
from sse_tpu_torch import configs as tconfigs
from sse_tpu_torch.convert import train_state_from_jax
from sse_tpu_torch.evals import recall as trecall
from sse_tpu_torch.train import loop as tloop
from sse_tpu_torch.train.checkpoint import CheckpointManager

WIDTHS = dict(embed_dim=16, hidden=16, encoding_dim=16, max_seq_length=10)


def _state(ema=True, seed=0):
    task = tconfigs.preset("ranking", **WIDTHS, ema_decay=0.9 if ema else 0.0, seed=seed)
    mc = task.model_config(200, 12)
    return tloop.init_train_state(mc, task.train_config(), device="cpu")


def _equal(a, b):
    la, lb = tloop.tree_leaves(a), tloop.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_round_trip(tmp_path):
    s = _state()
    gen = torch.Generator().manual_seed(1)
    bump = lambda t: t + torch.randn(t.shape, generator=gen)  # noqa: E731
    s = tloop.TrainState(
        params=tloop.tree_map(bump, s.params),
        opt_state=tloop.ScaleByAdamState(
            count=7, mu=tloop.tree_map(bump, s.opt_state.mu), nu=tloop.tree_map(bump, s.opt_state.nu)
        ),
        step=7, lr=torch.tensor(0.0081), ema_params=tloop.tree_map(bump, s.ema_params),
    )
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore(_state()) is None and mgr.latest_step() is None
    assert mgr.save(s, 7, extra={"epoch": 2}, metrics={"recall@1": 0.5})
    back = CheckpointManager(str(tmp_path)).restore(_state(seed=3))
    assert back.step == 7 and back.opt_state.count == 7 and torch.equal(back.lr, s.lr)
    assert _equal(back.params, s.params) and _equal(back.ema_params, s.ema_params)
    assert _equal(back.opt_state.mu, s.opt_state.mu) and _equal(back.opt_state.nu, s.opt_state.nu)
    assert mgr.restore_extra() == {"epoch": 2}
    with pytest.raises(ValueError, match="ema_params"):
        mgr.restore(_state(ema=False))
    wider = tconfigs.preset("ranking", **{**WIDTHS, "hidden": 24}).model_config(200, 12)
    with pytest.raises(ValueError, match="params"):
        mgr.restore(tloop.init_train_state(wider, tloop.TrainConfig(), device="cpu"))


SAVES = [  # (step, metrics)
    (5, {"recall@1": 0.1}),
    (5, {"recall@1": 0.9}),  # not above the latest: skipped
    (3, {"recall@1": 0.9}),  # below it: skipped
    (10, {"recall@1": 0.2, "loss": 1.0}),
    (15, {"loss": 0.5}),  # no recall@1: ranks as -inf
    (20, {"recall@1": 0.2}),  # ties step 10: the later one ranks higher
    (25, None),  # no metrics: never removed
    (30, {"recall@1": 0.05}),
    (35, {"recall@1": 0.7}),
]


@pytest.mark.parametrize("best_metric", [None, "recall@1"])
def test_retention_matches_orbax(tmp_path, best_metric):
    ours = CheckpointManager(str(tmp_path / "torch"), best_metric=best_metric)
    orbax = JaxManager(str(tmp_path / "jax"), best_metric=best_metric)
    s = _state(ema=False)
    for step, metrics in SAVES:
        ours.save(s, step, metrics=metrics)
        orbax.save({"x": jnp.ones(2)}, step, metrics=metrics)
        orbax.wait()
        kept = sorted(int(n) for n in os.listdir(tmp_path / "jax") if n.isdigit())
        assert ours.all_steps() == kept, (step, ours.all_steps(), kept)
        assert ours.latest_step() == orbax.latest_step()
        assert ours.best_step() == orbax.best_step()
    orbax.close()


def test_interrupted_save_keeps_previous_step(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    s = _state()
    mgr.save(s, 4)
    real_save = torch.save

    def dies_midway(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt  # a kill before the rename

    monkeypatch.setattr(torch, "save", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(dataclasses.replace(s, step=8), 8)
    monkeypatch.setattr(torch, "save", real_save)
    assert any(n.startswith(".tmp-") for n in os.listdir(tmp_path))
    assert mgr.latest_step() == 4 and mgr.restore(_state()).step == 0
    fresh = CheckpointManager(str(tmp_path))  # a restarted process
    assert os.listdir(tmp_path) == ["4"] and fresh.latest_step() == 4


def test_jax_checkpoint_carried_across(tmp_path):
    rows, evrows, targets = synthetic.make_corpus(task="ranking", num_targets=8,
                                                  train_per_target=5, seed=4)
    vocab = build_vocab(300, rows, targets)
    tspace = encode_target_space(vocab, targets, 10)
    pairs = encode_pairs(vocab, rows, tspace, 10)
    evpairs = encode_pairs(vocab, evrows, tspace, 10)
    kw = dict(WIDTHS, batch_size=8, max_epochs=2, steps_per_checkpoint=5, num_negatives=4,
              num_hard_negatives=0)
    jtask = jconfigs.preset("ranking", **kw)
    jm = jtask.model_config(vocab.vocab_size, tspace.num_targets)
    jmgr = JaxManager(str(tmp_path / "jax"))
    jstate = jloop.train(jm, jtask.train_config(), pairs, tspace,
                         checkpoint_fn=lambda s, step, rec: jmgr.save(s, step))
    jmgr.save(jstate, int(jstate.step))
    jmgr.wait()
    abstract = jloop.init_train_state(jax.random.PRNGKey(0), jm, jtask.train_config())
    restored = jmgr.restore(abstract)
    jmgr.close()
    assert int(restored.step) == 10 and restored.ema_params is not None

    ttask = tconfigs.preset("ranking", **kw)
    tm = ttask.model_config(vocab.vocab_size, tspace.num_targets)
    mgr = CheckpointManager(str(tmp_path / "torch"))
    mgr.save(train_state_from_jax(jax.tree.map(np.asarray, restored)), int(restored.step))
    state = mgr.restore(tloop.init_train_state(tm, ttask.train_config(), device="cpu"))
    assert state.step == 10 and state.opt_state.count == int(restored.opt_state[-1].count)
    assert float(state.lr) == float(restored.lr)
    want = jrecall.Evaluator(jm, evpairs, tspace).evaluate(jloop.inference_params(restored))
    got = trecall.Evaluator(tm, evpairs, tspace).evaluate(tloop.inference_params(state))
    assert got == pytest.approx(want, abs=1e-12)
