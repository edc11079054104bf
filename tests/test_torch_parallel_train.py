"""Training on a ('data', 'model') grid in the port (``sse_tpu_torch.train
.grid``), context parallelism (``sse_tpu_torch.parallel.context``) and
the CP index build, on the CPU.

The port's grids repeat one CPU device (``make_mesh(d, m, devices=[cpu] *
8)``); JAX runs on the conftest's 8 fake CPU devices. Tolerances, by test:

- a grid step against JAX's ``make_train_step`` on the matching mesh (the
  ports of ``tests/test_parallel.py``'s data-parallel and 'model'-sharded
  full-softmax tests, and the candidate losses) on JAX's weights, with the
  negatives JAX drew: ``tests/test_parallel.py``'s tolerances, loss and
  grad_norm rtol 2e-4 and the target table rtol 3e-3 / atol 3e-5 after
  an Adam step; the tower-only cases step with SGD (clip off), and their
  parameter change is held within 3e-2 of its max-abs (the bound
  ``tests/test_torch_train.py`` holds the port's one-device step to: the
  port's recurrent backward rounds dgates to bf16, XLA's scan autodiff
  does not; an Adam step would turn those last-bit differences of
  near-zero gradients into whole steps);
- three grid steps against three one-device steps of the port (dropout
  on, the merged scan on and off, EMA, SGD and Adam): loss, accuracy and
  grad_norm rtol 2e-4, every parameter (and Adam moment) rtol 3e-3 /
  atol 3e-5, and every copy of every leaf identical bit for bit;
- the context-parallel encode and its gradients against JAX's
  ``encode_context_parallel`` / ``make_cp_encoder``: rtol 2e-5 / atol
  2e-6, and gradients within 1e-2 of max(1, max |ref|)
  (``tests/test_parallel.py:192, 262``);
- ``build_index(cp_shards=)`` against JAX's and against the port's plain
  build: rtol 2e-5 / atol 2e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sse_tpu.models import sse as jsse
from sse_tpu.models import towers as jtowers
from sse_tpu.parallel import batch_sharding
from sse_tpu.parallel import make_mesh as jmake_mesh
from sse_tpu.parallel import param_shardings as jparam_shardings
from sse_tpu.train import loop as jloop
from sse_tpu.train import losses as jlosses
from sse_tpu_torch.convert import params_from_jax
from sse_tpu_torch.data.batching import Batch
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.models import towers as ttowers
from sse_tpu_torch.parallel import context, make_mesh
from sse_tpu_torch.parallel.mesh import RowShards, gather, place
from sse_tpu_torch.train import grid
from sse_tpu_torch.train import loop as tloop
from sse_tpu_torch.train import losses as tlosses
from sse_tpu_torch.train.checkpoint import CheckpointManager

CPU = torch.device("cpu")
V, L = 50, 10


def _mesh(data, model):
    return make_mesh(data, model, devices=[CPU] * 8)


def _cfgs(mode, num_targets, dropout=0.0, **tower_kw):
    tower = dict(vocab_size=V, embed_dim=16, hidden=16, encoding_dim=8, **tower_kw)
    jt = jtowers.TowerConfig(**tower)
    tt = ttowers.TowerConfig(dropout=dropout, **tower)
    extra_j, extra_t = {}, {}
    if mode == "dual-encoder":
        extra_j, extra_t = dict(tgt_tower=jt), dict(tgt_tower=tt)
    if mode == "source-encoder-only":
        extra_j = extra_t = dict(num_targets=num_targets)
    return (jsse.SSEConfig(mode=jsse.NetworkMode(mode), src_tower=jt, **extra_j),
            tsse.SSEConfig(mode=tsse.NetworkMode(mode), src_tower=tt, **extra_t))


def _problem(b, t, seed, multi=False):
    """A batch (the last row padding) and a target space of t rows."""
    rng = np.random.default_rng(seed)
    src = rng.integers(2, V, size=(b, L)).astype(np.int32)
    src_len = rng.integers(2, L + 1, size=(b,)).astype(np.int32)
    labels = rng.integers(0, t, size=(b,)).astype(np.int32)
    weight = np.ones((b,), np.float32)
    weight[-1] = 0.0
    lm = None
    if multi:  # a third of the rows carry a second label
        lm = np.full((b, 2), -1, np.int32)
        lm[:, 0] = labels
        take = rng.random(b) < 0.35
        lm[take, 1] = ((labels + 1 + rng.integers(0, t - 1, size=b)) % t)[take]
    tgt_tokens = rng.integers(2, V, size=(t, L)).astype(np.int32)
    tgt_lens = rng.integers(1, L + 1, size=(t,)).astype(np.int32)
    return (src, src_len, labels, weight, lm), tgt_tokens, tgt_lens


def _jax_negatives(seed):
    def draw(step, n, k):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        return torch.from_numpy(np.array(jlosses.sample_negative_rows(key, n, k)))

    return draw


# ------------------------------------------------- the grid against JAX
JAX_CASES = {
    # tests/test_parallel.py::test_data_parallel_train_step_matches_single_device
    "full-dp": dict(mode="source-encoder-only", loss=dict(kind="full"), b=16, t=12,
                    grid=(8, 1)),
    # ::test_model_sharded_target_table_full_softmax
    "full-tp": dict(mode="source-encoder-only", loss=dict(kind="full"), b=8, t=16,
                    grid=(2, 4)),
    "full-tp-multi": dict(mode="source-encoder-only", loss=dict(kind="full", margin=0.1),
                          b=8, t=16, grid=(1, 8), multi=True),
    # the merged scan (shared encoder, no mining) and the two-pass dual encoder
    "inbatch-bidir-merged": dict(mode="shared-encoder",
                                 loss=dict(kind="inbatch", bidirectional=True), b=16, t=24,
                                 grid=(4, 2), sgd=True),
    "inbatch-bidir": dict(mode="dual-encoder", loss=dict(kind="inbatch", bidirectional=True),
                          b=16, t=24, grid=(2, 1), sgd=True),
    "sampled-hard-multi": dict(mode="dual-encoder",
                               loss=dict(kind="sampled", num_negatives=8, num_hard_negatives=2),
                               b=16, t=24, grid=(4, 1), multi=True, sgd=True),
    "sampled-table-tp": dict(mode="source-encoder-only",
                             loss=dict(kind="sampled", num_negatives=8, num_hard_negatives=2),
                             b=8, t=16, grid=(2, 2)),
}


def _jax_step(case, jcfg, jtc, js, batch, tgt_tokens, tgt_lens, cache):
    mesh = jmake_mesh(*case["grid"])
    bs = batch_sharding(mesh)
    src, src_len, labels, weight, lm = batch
    args = [jax.device_put(jnp.asarray(a), bs) for a in (src, src_len, labels, weight)]
    js = jax.device_put(js, jparam_shardings(mesh, js))
    rep = NamedSharding(mesh, P())
    extra = {}
    if cache is not None:
        extra["tgt_emb_cache"] = jax.device_put(jnp.asarray(cache), rep)
    if lm is not None:
        extra["labels_multi"] = jax.device_put(jnp.asarray(lm), bs)
    step = jloop.make_train_step(jcfg, jtc, donate=False)
    return step(js, *args, jax.device_put(jnp.asarray(tgt_tokens), rep),
                jax.device_put(jnp.asarray(tgt_lens), rep), **extra)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_grid_step_matches_jax_sharded_step(name):
    """One step on the port's grid against JAX's step on the same mesh
    shape, from JAX's weights: Adam at TrainConfig's defaults (lr 0.5, clip
    5), or SGD with the clip off for the tower-only cases."""
    case = JAX_CASES[name]
    b, t = case["b"], case["t"]
    jcfg, tcfg = _cfgs(case["mode"], t)
    loss = case["loss"]
    opt = dict(optimizer="sgd", max_gradient_norm=1e9) if case.get("sgd") else {}
    jtc = jloop.TrainConfig(batch_size=b, loss=jlosses.LossConfig(**loss), **opt)
    ttc = tloop.TrainConfig(batch_size=b, loss=tlosses.LossConfig(**loss), **opt)
    batch, tgt_tokens, tgt_lens = _problem(b, t, seed=3, multi=case.get("multi", False))
    js = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    jparams = jax.device_get(js.params)
    cache = None
    if loss.get("num_hard_negatives"):
        kw = {} if case["mode"] == "source-encoder-only" else dict(
            tokens=jnp.asarray(tgt_tokens), lengths=jnp.asarray(tgt_lens))
        cache = np.asarray(jsse.target_embeddings(js.params, jcfg, **kw))
    j_new, jm = _jax_step(case, jcfg, jtc, js, batch, tgt_tokens, tgt_lens, cache)

    p0 = params_from_jax(jparams)
    ts = tloop.TrainState(params=p0, opt_state=tloop.make_optimizer(ttc).init(p0), step=0,
                          lr=torch.tensor(ttc.learning_rate))
    mesh = _mesh(*case["grid"])
    step = tloop.make_train_step(tcfg, ttc, sample_negatives=_jax_negatives(ttc.seed), mesh=mesh)
    src, src_len, labels, weight, lm = (None if a is None else torch.from_numpy(a)
                                        for a in batch)
    t_new, tm = step(grid.place_state(ts, mesh), src, src_len, labels, weight,
                     torch.from_numpy(tgt_tokens), torch.from_numpy(tgt_lens),
                     None if cache is None else torch.from_numpy(cache), lm)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-4)
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=1e-6)
    got = gather(t_new.params)
    want = jax.device_get(j_new.params)
    if "target_table" in got:
        np.testing.assert_allclose(got["target_table"].numpy(), np.asarray(want["target_table"]),
                                   rtol=3e-3, atol=3e-5)
    if case.get("sgd"):
        for g, w, s in zip(tloop.tree_leaves(got), jax.tree.leaves(want), tloop.tree_leaves(p0)):
            dg, dw = (s - g).double().numpy(), s.double().numpy() - np.asarray(w, np.float64)
            assert np.abs(dg - dw).max() <= 3e-2 * (np.abs(dw).max() + 1e-9), s.shape
    assert grid.copies_identical(t_new)


# ------------------------------------------- the grid against one device
PORT_CASES = {
    "full-tp-dropout-ema": dict(mode="source-encoder-only", loss=dict(kind="full"), t=16,
                                grids=((2, 2), (1, 4), (4, 1)), dropout=0.1, ema=0.99,
                                multi=True),
    "full-update-norm": dict(mode="source-encoder-only", loss=dict(kind="full", margin=0.2),
                             t=16, grids=((2, 4),), norm_metric="update"),
    "merged-dropout": dict(mode="shared-encoder", loss=dict(kind="sampled", num_negatives=8),
                           t=24, grids=((2, 1), (4, 1)), dropout=0.1),
    "two-pass-dropout-hard": dict(mode="dual-encoder",
                                  loss=dict(kind="sampled", num_negatives=8, num_hard_negatives=2,
                                            bidirectional=True),
                                  t=24, grids=((2, 1), (8, 1)), dropout=0.1, multi=True,
                                  ema=0.9),
    "shared-hard": dict(mode="shared-encoder", loss=dict(kind="inbatch", num_hard_negatives=2),
                        t=24, grids=((4, 2),)),
}


def _port_run(tcfg, ttc, batches, tgt_tokens, tgt_lens, mesh=None, cache_of=None):
    state = tloop.init_train_state(tcfg, ttc, device="cpu")
    if mesh is not None:
        state = grid.place_state(state, mesh)
    step = tloop.make_train_step(tcfg, ttc, packed_width=L, num_label_cols=batches[0][1],
                                 mesh=mesh)
    metrics = []
    for packed, _ in batches:
        cache = None if cache_of is None else cache_of(tloop.inference_params(
            dataclasses.replace(state, ema_params=None)))
        state, m = step(state, packed, tgt_tokens, tgt_lens, cache)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("name", list(PORT_CASES))
def test_grid_steps_match_one_device(name, optimizer):
    """Three steps through make_train_step(mesh=) (the packed operand, as
    train() feeds it) against three one-device steps on the same batches."""
    case = PORT_CASES[name]
    t, b = case["t"], 16
    _, tcfg = _cfgs(case["mode"], t, dropout=case.get("dropout", 0.0))
    ttc = tloop.TrainConfig(batch_size=b, learning_rate=0.05, loss=tlosses.LossConfig(**case["loss"]),
                            ema_decay=case.get("ema", 0.0), optimizer=optimizer,
                            norm_metric=case.get("norm_metric", "grad"))
    batches = []
    for s in range(3):
        (src, src_len, labels, weight, lm), tt, tl = _problem(b, t, seed=10 + s,
                                                            multi=case.get("multi", False))
        packed = tloop.pack_batch(Batch(src, src_len, labels, weight, lm))
        batches.append((torch.from_numpy(packed), 1 if lm is None else 2))
    tgt_tokens, tgt_lens = torch.from_numpy(tt), torch.from_numpy(tl)
    cache_of = None
    if case["loss"].get("num_hard_negatives"):
        def cache_of(params):
            kw = {} if case["mode"] == "source-encoder-only" else dict(tokens=tgt_tokens,
                                                                       lengths=tgt_lens)
            with torch.no_grad():
                return tsse.target_embeddings(params, tcfg, **kw)
    ref, ref_m = _port_run(tcfg, ttc, batches, tgt_tokens, tgt_lens, cache_of=cache_of)
    for shape in case["grids"]:
        got, got_m = _port_run(tcfg, ttc, batches, tgt_tokens, tgt_lens, _mesh(*shape), cache_of)
        for g, r in zip(got_m, ref_m):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], r[k], rtol=2e-4, err_msg=f"{shape} {k}")
            assert g["accuracy"] == pytest.approx(r["accuracy"], abs=1e-6)
        assert grid.copies_identical(got), shape
        assert got.step == ref.step == 3 and isinstance(got.params["src_tower"]["embed"], dict)
        trees = [(got.params, ref.params), (got.ema_params, ref.ema_params)]
        if ref.opt_state is not None:
            trees += [(got.opt_state.mu, ref.opt_state.mu), (got.opt_state.nu, ref.opt_state.nu)]
        for g_tree, r_tree in trees:
            if r_tree is None:
                continue
            for g, r in zip(tloop.tree_leaves(gather(g_tree)), tloop.tree_leaves(r_tree)):
                np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=3e-3, atol=3e-5,
                                           err_msg=str(shape))


def test_a_per_replica_loss_fails_the_check():
    """DDP's loss, each replica's own mean softmax over its own in-batch
    candidates, averaged, is not the global loss: the tolerance of the
    tests above tells them apart (and so would catch a grid step that
    computed it), while the grid's step computes the global loss."""
    _, tcfg = _cfgs("shared-encoder", 24)
    ttc = tloop.TrainConfig(batch_size=16, loss=tlosses.LossConfig(kind="inbatch"))
    (src, src_len, labels, weight, _), tt, tl = _problem(16, 24, seed=5)
    weight[-4:] = 0.0  # the replicas' weights differ: their means weigh rows apart
    params = tloop.init_train_state(tcfg, ttc, device="cpu").params
    args = [torch.from_numpy(a) for a in (src, src_len, labels, weight)]
    tgt = torch.from_numpy(tt), torch.from_numpy(tl)
    lab = args[2].long()
    with torch.no_grad():
        emb = tsse.encode_source(params, tcfg, args[0], args[1])
        cand = tsse.encode_source(params, tcfg, tgt[0][lab], tgt[1][lab])

        def loss(r):
            return float(tlosses.similarity_loss(ttc.loss, emb[r], lab[r], args[3][r],
                                                 cand_emb=cand[r], cand_rows=lab[r])[0])

    global_loss = loss(slice(0, 16))
    ddp = (loss(slice(0, 8)) + loss(slice(8, 16))) / 2
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(ddp, global_loss, rtol=2e-4)
    mesh = _mesh(2, 1)
    step = tloop.make_train_step(tcfg, ttc, mesh=mesh)
    state = grid.place_state(tloop.init_train_state(tcfg, ttc, device="cpu"), mesh)
    _, m = step(state, *args, *tgt)
    np.testing.assert_allclose(float(m["loss"]), global_loss, rtol=2e-4)


@pytest.mark.parametrize("values", ["random", "ties"])
def test_block_softmax_over_column_chunks_matches_full_softmax(monkeypatch, values):
    """``block_softmax`` over two 8-row blocks, each cut into column chunks
    of 3 (BLOCK_LOGITS set to 3 columns of 8 rows), combined by
    ``combine_blocks``, against ``full_softmax_loss`` on the whole table:
    labels, margin and labels_multi columns in later chunks and in the
    second block, a zero-weight row. Loss and the gradients of the rows
    and the table within rtol 1e-5 / atol 1e-6 (the log-sum-exp is summed
    in another order); the first maximal column, and so accuracy, exactly.
    ``ties``: values on a grid of 1/4, so the logits are exact and three
    table rows (2, 5 and 10: another chunk, another block) tie for the
    maximum, which goes to the first, as ``jnp.argmax``'s does."""
    monkeypatch.setattr(tlosses, "BLOCK_LOGITS", 8 * 3)
    b, t, d = 8, 16, 4
    rng = np.random.default_rng(11)
    if values == "random":
        src = rng.normal(size=(b, d)).astype(np.float32)
        tbl = rng.normal(size=(t, d)).astype(np.float32)
        src /= np.linalg.norm(src, axis=1, keepdims=True)
        tbl /= np.linalg.norm(tbl, axis=1, keepdims=True)
    else:
        tbl = rng.integers(-1, 2, size=(t, d)).astype(np.float32) / 4
        tbl[[2, 5, 10]] = 0.5
        src = rng.integers(-1, 2, size=(b, d)).astype(np.float32) / 4
        src[:4] = 0.5
    labels = np.array([1, 4, 7, 9, 12, 15, 6, 13])
    lm = np.full((b, 3), -1)
    lm[:, 0] = labels
    lm[[0, 3, 6], 1] = [5, 14, 11]
    lm[[0, 5], 2] = [8, 3]
    weight = np.ones(b, np.float32)
    weight[5] = 0.0
    scale, margin = 20.0, 0.25
    lab, lmt, w = torch.from_numpy(labels), torch.from_numpy(lm), torch.from_numpy(weight)

    def leaves():
        return (torch.from_numpy(src).requires_grad_(True),
                torch.from_numpy(tbl).requires_grad_(True))

    s_ref, t_ref = leaves()
    ref, ref_acc = tlosses.full_softmax_loss(s_ref, t_ref, lab, w, scale, margin, lmt)
    ref.backward()
    s_got, t_got = leaves()
    parts = [tlosses.block_softmax(s_got, t_got[c0:c0 + 8], lab, c0, scale, margin, lmt)
             for c0 in (0, 8)]
    assert len(tlosses._chunks(8, b)) == 3
    logp, arg = tlosses.combine_blocks(parts)
    got = -(logp * w).sum() / w.sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref.detach()), rtol=1e-5, atol=1e-6)
    for g, r in ((s_got, s_ref), (t_got, t_ref)):
        np.testing.assert_allclose(g.grad.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-6)
    cos = src @ tbl.T - margin * (np.arange(t)[None] == labels[:, None])
    logits = np.where((np.arange(t)[None, :, None] == lm[:, None, 1:]).any(2), -np.inf,
                      scale * cos)
    np.testing.assert_array_equal(arg.numpy(), logits.argmax(1))
    if values == "ties":
        assert (arg.numpy()[:4] == 2).all()
    acc = float(((arg == lab).float() * w).sum() / w.sum())
    assert acc == float(ref_acc)


def test_placement_of_a_train_state():
    """The table's rows over 'model' (each block on every device of its
    column), every other leaf on each device; 12 rows on 'model' = 8 raise
    ValueError, as jax.device_put(state, param_shardings(...)) does."""
    _, tcfg = _cfgs("source-encoder-only", 16)
    ttc = tloop.TrainConfig(ema_decay=0.9)
    state = tloop.init_train_state(tcfg, ttc, device="cpu")
    placed = grid.place_state(state, _mesh(2, 4))
    for tree in (placed.params, placed.ema_params, placed.opt_state.mu, placed.opt_state.nu):
        assert isinstance(tree["target_table"], RowShards)
        assert tree["target_table"].rows_per_shard == 4
        assert isinstance(tree["src_tower"]["embed"], dict)
    assert all(torch.equal(a, b) for a, b in zip(tloop.tree_leaves(gather(placed.params)),
                                                  tloop.tree_leaves(state.params)))
    _, tcfg12 = _cfgs("source-encoder-only", 12)
    with pytest.raises(ValueError, match="equal blocks"):
        place(tloop.init_train_state(tcfg12, ttc, device="cpu").params, _mesh(1, 8))
    jcfg12, _ = _cfgs("source-encoder-only", 12)
    js = jloop.init_train_state(jax.random.PRNGKey(0), jcfg12, jloop.TrainConfig())
    with pytest.raises(ValueError, match="divisible by 8"):
        jax.device_put(js, jparam_shardings(jmake_mesh(data=1, model=8), js))


def test_grid_checkpoint_restores_on_one_device_and_back(tmp_path):
    """A state saved on a (2, 2) grid restores on one device and onto a
    (1, 4) grid, bit for bit; a one-device save restores onto a grid."""
    _, tcfg = _cfgs("source-encoder-only", 16)
    ttc = tloop.TrainConfig(batch_size=8, loss=tlosses.LossConfig(kind="full"), ema_decay=0.9)
    (src, src_len, labels, weight, _), _, _ = _problem(8, 16, seed=7)
    mesh = _mesh(2, 2)
    state = grid.place_state(tloop.init_train_state(tcfg, ttc, device="cpu"), mesh)
    step = tloop.make_train_step(tcfg, ttc, mesh=mesh)
    dummy = torch.zeros((16, L), dtype=torch.int32), torch.ones((16,), dtype=torch.int32)
    state, _ = step(state, *map(torch.from_numpy, (src, src_len, labels, weight)), *dummy)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(state, 1)
    fresh = tloop.init_train_state(tcfg, ttc, device="cpu")
    one = mgr.restore(fresh)
    other = mgr.restore(grid.place_state(fresh, _mesh(1, 4)))
    assert other.mesh is not None and isinstance(other.params["target_table"], RowShards)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tloop.tree_leaves(a), tloop.tree_leaves(b)))

    for name in ("params", "ema_params"):
        saved = gather(getattr(state, name))
        assert same(getattr(one, name), saved) and same(gather(getattr(other, name)), saved)
    assert same(one.opt_state.mu, gather(state.opt_state.mu))
    assert one.opt_state.count == other.opt_state.count == 1 and one.step == 1
    assert torch.equal(one.lr, state.lr)
    mgr2 = CheckpointManager(str(tmp_path / "ckpt2"))
    mgr2.save(one, 1)
    back = mgr2.restore(grid.place_state(fresh, mesh))
    assert same(gather(back.params), one.params) and grid.copies_identical(back)


def test_train_driver_on_a_grid_matches_one_device():
    """train(mesh=) against train() on one device: the same steps, log
    records and final params (the hard-negative cache refreshed inside the
    run), the inference params whole on one device."""
    from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace

    rng = np.random.default_rng(0)
    n, t = 48, 12
    pairs = EncodedPairs(
        src=rng.integers(2, V, size=(n, L)).astype(np.int32),
        src_len=rng.integers(2, L + 1, size=(n,)).astype(np.int32),
        labels=rng.integers(0, t, size=(n,)).astype(np.int32),
        label_sets=[(0,)] * n,
    )
    tspace = TargetSpace(ids=[f"t{i}" for i in range(t)], texts=["x"] * t,
                         tokens=rng.integers(2, V, size=(t, L)).astype(np.int32),
                         lengths=np.full((t,), L, np.int32),
                         id_to_row={f"t{i}": i for i in range(t)})
    _, tcfg = _cfgs("dual-encoder", t)
    ttc = tloop.TrainConfig(batch_size=16, learning_rate=0.05, max_epochs=2,
                            steps_per_checkpoint=3, hard_negative_refresh=2, ema_decay=0.9,
                            loss=tlosses.LossConfig(kind="sampled", num_negatives=8,
                                                    num_hard_negatives=2))
    evals = []

    def eval_fn(params):
        assert params["src_tower"]["embed"].device == CPU and torch.is_tensor(
            params["src_tower"]["embed"])
        evals.append(float(params["src_tower"]["proj_w"].sum()))
        return {"recall@1": -len(evals)}  # falls: the lr decays at every eval

    logs = {}
    for key, mesh in (("one", None), ("grid", _mesh(4, 1))):
        records = []
        state = tloop.train(tcfg, ttc, pairs, tspace, eval_fn=eval_fn, log_fn=records.append,
                            mesh=mesh, device="cpu")
        logs[key] = (state, records)
    (one, rec1), (on_grid, rec2) = logs["one"], logs["grid"]
    assert one.step == on_grid.step == 6 and on_grid.mesh is not None
    assert [r["step"] for r in rec1] == [r["step"] for r in rec2] == [3, 6]
    for a, b in zip(rec1, rec2):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-4)
        assert a["lr"] == b["lr"]
    for g, r in zip(tloop.tree_leaves(tloop.inference_params(on_grid)),
                    tloop.tree_leaves(tloop.inference_params(one))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=3e-3, atol=3e-5)
    with pytest.raises(ValueError, match="requires a mesh"):
        tloop.train(tcfg, ttc, pairs, tspace, process_count=2, device="cpu")


# --------------------------------------------------- context parallelism
def _cp_cfgs(pos="rope", **kw):
    tower = dict(vocab_size=V, embed_dim=16, hidden=16, encoding_dim=8, cell="transformer",
                 num_layers=2, num_heads=2, readout="mean", max_len=64, pos_encoding=pos, **kw)
    return jtowers.TowerConfig(**tower), ttowers.TowerConfig(**tower)


@pytest.mark.parametrize("pos", ["rope", "learned", "sinusoid"])
def test_context_parallel_encode_matches_jax(pos):
    """The sequence split over 4 shards (tests/test_parallel.py::
    test_context_parallel_transformer_matches_unsharded): lengths that end
    mid-shard, in the first shard, at one token; against JAX's CP encode
    on the (2, 4) mesh's 'model' axis and the port's unsharded encode."""
    jcfg, tcfg = _cp_cfgs(pos)
    jp = jtowers.init_tower(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, V, size=(6, 16)).astype(np.int32)
    lengths = np.asarray([16, 11, 8, 3, 1, 13], np.int32)
    from sse_tpu.parallel import encode_context_parallel as jcp

    want = np.asarray(jcp(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lengths),
                          jmake_mesh(data=2, model=4), axis="model"))
    toks, lens = torch.from_numpy(tokens), torch.from_numpy(lengths)
    for mesh, axis in ((context.cp_mesh(4, [CPU] * 4), "seq"), (_mesh(2, 4), "model")):
        got = context.encode_context_parallel(tp, tcfg, toks, lens, mesh, axis=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    plain = ttowers.encode_raw(tp, tcfg, toks, lens).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-6)


def test_context_parallel_grads_match_jax():
    """d(sum(out · v))/d(params) through the 4-shard encode against JAX's
    make_cp_encoder and the port's unsharded tower (the shards' copies'
    gradients summed: without the sum each would be about a quarter; the
    tolerance is JAX's, for the bf16 weight cotangents each shard rounds
    before the sum)."""
    jcfg, tcfg = _cp_cfgs("rope")
    jp = jtowers.init_tower(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, V, size=(4, 16)).astype(np.int32)
    lengths = np.asarray([16, 9, 3, 12], np.int32)
    v = rng.normal(size=(4, 8)).astype(np.float32)
    from sse_tpu.parallel import cp_mesh as jcp_mesh
    from sse_tpu.parallel import make_cp_encoder as jmake

    jenc = jmake(jcfg, jcp_mesh(4))
    g_jax = jax.grad(lambda p: jnp.sum(jenc(p, jnp.asarray(tokens), jnp.asarray(lengths)) * v))(jp)
    leaves = [t.requires_grad_(True) for t in tloop.tree_leaves(params_from_jax(
        jax.device_get(jp)))]

    def grads(encode):
        params = tloop._unflatten(params_from_jax(jax.device_get(jp)), leaves)
        out = encode(params, torch.from_numpy(tokens), torch.from_numpy(lengths))
        return torch.autograd.grad((out * torch.from_numpy(v)).sum(), leaves)

    g_cp = grads(context.make_cp_encoder(tcfg, context.cp_mesh(4, [CPU] * 4)))
    g_plain = grads(lambda p, t, n: ttowers.encode_raw(p, tcfg, t, n))
    for a, b, c in zip(g_cp, jax.tree.leaves(g_jax), g_plain):
        for ref in (np.asarray(b), c.numpy()):
            tol = 1e-2 * max(1.0, float(np.abs(ref).max()))
            assert float(np.abs(a.numpy() - ref).max()) <= tol, a.shape


def test_check_cp_config_errors():
    """RNN and bag-of-subwords cells and non-mean readouts refuse CP with
    the JAX package's messages; a width the shards do not divide raises."""
    from sse_tpu.parallel.context import check_cp_config as jcheck

    _, tcfg = _cp_cfgs()
    params = ttowers.init_tower(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks, lens = torch.ones((2, 16), dtype=torch.int32), torch.tensor([16, 3])
    mesh = context.cp_mesh(4, [CPU] * 4)
    for kw, what in ((dict(cell="gru"), "sequential"), (dict(cell="bow"), "sequential"),
                     (dict(cell="transformer", readout="attention"), "mean"),
                     (dict(cell="lstm", readout="final"), "sequential")):
        cfg = ttowers.TowerConfig(vocab_size=V, embed_dim=16, hidden=16, encoding_dim=8, **kw)
        with pytest.raises(ValueError, match=what):
            context.encode_context_parallel(params, cfg, toks, lens, mesh)
        with pytest.raises(ValueError, match=what):
            jcheck(jtowers.TowerConfig(vocab_size=V, embed_dim=16, hidden=16, encoding_dim=8,
                                       **kw))
    with pytest.raises(ValueError, match="not divisible"):
        context.encode_context_parallel(params, tcfg, toks[:, :14], lens, mesh)
    with pytest.raises(ValueError, match="need 4 devices"):
        context.cp_mesh(4, [CPU] * 3)


def test_build_index_cp_matches_jax_and_composes_with_model_sharding():
    """build_index(cp_shards=4) (tests/test_parallel.py::
    test_build_index_cp_matches_and_composes_with_model_sharding): a token
    width of 14 (padded to 16), the same rows as the plain build and as
    JAX's, also written onto a (1, 2) grid's row blocks."""
    from sse_tpu.data.corpus import TargetSpace as JTargetSpace
    from sse_tpu.index.sharded_index import build_index as jbuild
    from sse_tpu_torch.data.corpus import TargetSpace
    from sse_tpu_torch.index import build_index

    jt, tt = _cp_cfgs("learned")
    jcfg = jsse.SSEConfig(mode=jsse.NetworkMode.SHARED_ENCODER, src_tower=jt)
    tcfg = tsse.SSEConfig(mode=tsse.NetworkMode.SHARED_ENCODER, src_tower=tt)
    jp = jsse.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(5)
    t, width = 23, 14
    toks = rng.integers(2, V, size=(t, width)).astype(np.int32)
    lens = rng.integers(1, width + 1, size=(t,)).astype(np.int32)
    for i in range(t):
        toks[i, lens[i]:] = 0
    space = dict(ids=[f"t{i}" for i in range(t)], texts=[f"doc {i}" for i in range(t)],
                 tokens=toks, lengths=lens, id_to_row={f"t{i}": i for i in range(t)})
    want = np.asarray(jbuild(jp, jcfg, JTargetSpace(**space), batch_size=8, cp_shards=4).emb)[:t]
    plain = build_index(tp, tcfg, TargetSpace(**space), batch_size=8)
    cp = build_index(tp, tcfg, TargetSpace(**space), batch_size=8, cp_shards=4)
    on_grid = build_index(tp, tcfg, TargetSpace(**space), batch_size=8, cp_shards=4,
                          mesh=_mesh(1, 2))
    assert isinstance(on_grid.emb, RowShards) and on_grid.emb.rows_per_shard * 2 == 32
    for got in (cp.emb[:t], on_grid.emb[0:t]):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got.numpy(), plain.emb[:t].numpy(), rtol=2e-5, atol=2e-6)
    assert not cp.emb[t:].any()


def test_debug_checks_and_profiler_server(tmp_path):
    """enable_debug_checks(nans=True) makes a NaN backward raise (anomaly
    mode); tracer_leaks is accepted. start_profiler_server captures a
    trace of the asked duration into the asked directory."""
    import json
    import threading
    import urllib.request

    from sse_tpu_torch.utils import enable_debug_checks, start_profiler_server

    enable_debug_checks(nans=True, tracer_leaks=True)
    try:
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(False)
    server = start_profiler_server(0, str(tmp_path / "default"))
    stop = threading.Event()

    def work():
        while not stop.is_set():
            torch.randn(32, 32) @ torch.randn(32, 32)

    worker = threading.Thread(target=work)
    worker.start()
    try:
        port = server.server_address[1]
        url = f"http://127.0.0.1:{port}/profile?duration_ms=100&log_dir={tmp_path / 'asked'}"
        with urllib.request.urlopen(url, timeout=60) as r:
            path = json.load(r)["trace"]
    finally:
        stop.set()
        worker.join()
        server.shutdown()
        server.server_close()
    assert path.startswith(str(tmp_path / "asked"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]
