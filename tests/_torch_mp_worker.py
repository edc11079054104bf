"""Worker of the port's two-process tests (tests/test_torch_multiprocess.py).

    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> serve
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> indexsave <dir>
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> full|flagship adam|sgd [K [init.npy]]
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> cp
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> rule
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> stand_in
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> gpu_chain|gpu_query|gpu_fail

Each process holds two CPU entries of one global grid, joined over gloo
by ``sse_tpu_torch.parallel.distributed``. ``serve`` runs the sharded
fused query (encode → per-shard top-k → exchange → merge) and
``distributed_topk`` on a (1, 2 · num_processes) grid and prints their
results on a ``RESULT`` line; ``indexsave`` saves a row-sharded index,
each process its own blocks. ``full`` and ``flagship`` train
``build_problem(mode, optimizer)`` through ``train()`` on a (2 · num_processes, 1)
grid, each process feeding its slice of the global batch, at
``steps_per_dispatch`` K (the TrainConfig default where not given), from
the state saved by ``save_state`` where a file is given (the parent's
JAX init state); ``cp`` runs the context-parallel transformer encode
over a {'seq': 2 · num_processes} grid across the processes, with its
gradients. ``rule`` reports what a grid across processes captures over
gloo (``distributed.captures()``, the chain function), the collectives
(op, shape, type) of one grid step and of one chain call of ``RULE_K``
steps for both modes, and how ``utils.graphs.agree`` ends a capture that
failed on one rank, or whose readings differ. ``stand_in`` drives what
NCCL would capture with the collectives over gloo and a stand-in for the
capture (``StandInRecorder``, ``StandInCaptured``: a replay runs the
program again on its fixed buffers): a chain of a grid across processes
(``loop._GridChain``, its ranks agreeing on the recording) against the
eager chain for both modes, and a (1, 2 · num_processes) grid query whose
card body holds the exchange and the merge. The ``gpu_*`` modes run a
rank a card over NCCL (``tests/test_torch_gpu_processes.py``):
``gpu_chain`` a captured chain of GPU_K grid steps on a (num_processes,
1) grid against the eager chain, ``gpu_query`` a captured (1,
num_processes) grid query against its eager call, and ``gpu_fail`` a
chain whose capture fails on rank 1 only. Imports torch and the port
only.
"""

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sse_tpu_torch.parallel import distributed, distributed_topk, make_mesh  # noqa: E402

CPU = torch.device("cpu")


def serve_problem():
    """The serving problem, the same in every process and in the parent's
    single-process reference: a dual-encoder GRU with seeded weights, a
    50-row float32 index, 8 queries."""
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig

    rng = np.random.default_rng(7)
    tw = TowerConfig(vocab_size=40, embed_dim=8, hidden=8, encoding_dim=16)
    cfg = SSEConfig(mode=NetworkMode.DUAL_ENCODER, src_tower=tw, tgt_tower=tw)
    params = sse.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    ids = [f"d{i}" for i in range(50)]
    texts = [f"doc {i}" for i in range(50)]
    tokens = torch.from_numpy(rng.integers(2, 40, size=(8, 6)).astype(np.int32))
    lengths = torch.full((8,), 6, dtype=torch.int32)
    return emb, ids, texts, cfg, params, tokens, lengths


def build_problem(mode: str, optimizer: str = "adam", width: int = 8):
    """tests/_mp_worker.py's problem in the port (towers ``width`` wide): 64 pairs, 12 targets,
    batch 16, two epochs, with ``optimizer`` "adam" at the TrainConfig
    defaults (the JAX worker's) or "sgd" at lr 0.05. ``full``: source-encoder-only, full softmax.
    ``flagship``: the ranking preset's loss path: dual-encoder towers,
    sampled softmax with mined hard negatives (the cache refreshed every 3
    steps) and multi-label rows."""
    from sse_tpu_torch.data.corpus import EncodedPairs, TargetSpace
    from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
    from sse_tpu_torch.models.towers import TowerConfig
    from sse_tpu_torch.train import LossConfig, TrainConfig

    rng = np.random.default_rng(0)
    n, l, v, t = 64, 8, 40, 12
    src = rng.integers(2, v, size=(n, l)).astype(np.int32)
    src_len = rng.integers(2, l + 1, size=(n,)).astype(np.int32)
    labels = rng.integers(0, t, size=(n,)).astype(np.int32)
    labels_multi = None
    if mode == "flagship":
        labels_multi = np.full((n, 2), -1, np.int32)
        labels_multi[:, 0] = labels
        second = rng.integers(0, t, size=(n,)).astype(np.int32)
        take = rng.random(n) < 0.25
        labels_multi[take, 1] = second[take]
    pairs = EncodedPairs(src=src, src_len=src_len, labels=labels,
                         label_sets=[(int(x),) for x in labels], labels_multi=labels_multi)
    flagship = mode == "flagship"
    tok = rng.integers(2, v, size=(t, l)).astype(np.int32) if flagship else np.zeros((t, l), np.int32)
    tspace = TargetSpace(ids=[f"t{i}" for i in range(t)], texts=["x"] * t, tokens=tok,
                         lengths=np.full((t,), l if flagship else 1, np.int32),
                         id_to_row={f"t{i}": i for i in range(t)})
    tw = TowerConfig(vocab_size=v, embed_dim=width, hidden=width, encoding_dim=width)
    opt = {} if optimizer == "adam" else {"learning_rate": 0.05, "optimizer": "sgd"}
    if flagship:
        model_cfg = SSEConfig(mode=NetworkMode.DUAL_ENCODER, src_tower=tw, tgt_tower=tw)
        cfg = TrainConfig(batch_size=16, max_epochs=2, **opt,
                          loss=LossConfig(kind="sampled", num_negatives=16, num_hard_negatives=4),
                          hard_negative_refresh=3, steps_per_checkpoint=10_000)
    else:
        model_cfg = SSEConfig(mode=NetworkMode.SOURCE_ENCODER_ONLY, src_tower=tw, num_targets=t)
        cfg = TrainConfig(batch_size=16, max_epochs=2, **opt, loss=LossConfig(kind="full"),
                          steps_per_checkpoint=10_000)
    return pairs, tspace, model_cfg, cfg


def save_state(path: str, params, count: int, mu, nu, step: int, lr: float) -> None:
    """A train state's trees (dicts and lists of numpy arrays) and scalars
    in one numpy file, read back by ``load_state`` (``mu`` None: SGD, no
    Adam state)."""
    np.save(path, np.array({"params": params, "count": count, "mu": mu, "nu": nu, "step": step,
                            "lr": lr}, dtype=object), allow_pickle=True)


def load_state(path: str):
    """The port's TrainState on the CPU from ``save_state``'s file, through
    ``convert.train_state_from_jax`` (JAX's layout: the Adam state last in
    ``opt_state``)."""
    from types import SimpleNamespace

    from sse_tpu_torch.convert import train_state_from_jax

    d = np.load(path, allow_pickle=True).item()
    adam = SimpleNamespace() if d["mu"] is None else SimpleNamespace(  # SGD: no Adam state
        count=d["count"], mu=d["mu"], nu=d["nu"])
    return train_state_from_jax(SimpleNamespace(
        params=d["params"], opt_state=(None, adam), step=d["step"], lr=d["lr"],
        ema_params=None), "cpu")


def state_digest(state) -> str:
    """sha256 over every tensor of a one-device state (params, Adam's count
    and moments, lr, EMA): equal digests are equal bits."""
    from sse_tpu_torch.train.loop import _state_leaves

    return _digest(_state_leaves(state))


RULE_K = 3  # steps of the chain ``rule`` logs


@contextlib.contextmanager
def logged():
    """A list of (op, shape, type) of each device collective issued inside,
    in order (``distributed._issued``, which counts each one, wrapped)."""
    real, log = distributed._issued, []

    def issued(op, t):
        log.append((op, tuple(t.shape), str(t.dtype).replace("torch.", "")))
        real(op, t)

    distributed._issued = issued
    try:
        yield log
    finally:
        distributed._issued = real


def capture_rule(pid: int, nproc: int) -> dict:
    """``rule``'s readings (see the module docstring)."""
    from sse_tpu_torch.parallel.mesh import Replicated
    from sse_tpu_torch.train import grid, loop
    from sse_tpu_torch.utils import graphs

    out = {"pid": pid, "captures": distributed.captures(), "logs": {}}
    for mode in ("full", "flagship"):
        pairs, tspace, model_cfg, cfg = build_problem(mode)
        mesh = make_mesh(data=2 * nproc, model=1, devices=[CPU, CPU])
        state = grid.place_state(loop.init_train_state(model_cfg, cfg, device="cpu"), mesh)
        cols = 1 if pairs.labels_multi is None else pairs.labels_multi.shape[1]
        width = pairs.src.shape[1]
        kw = dict(packed_width=width, num_label_cols=cols, mesh=mesh)
        step = loop.make_train_step(model_cfg, cfg, **kw)
        chain = loop.make_train_step(model_cfg, cfg, chain=RULE_K, **kw)
        out[f"{mode}_chain_eager"] = not hasattr(chain, "chains")
        it = loop.BatchIterator(pairs, cfg.batch_size, seed=cfg.seed, process_index=pid,
                                process_count=nproc)
        packed = torch.from_numpy(np.stack([loop.pack_batch(b) for b in it.epoch_batches(0)]))
        rep = lambda x: Replicated({CPU: x})  # noqa: E731
        tt, tl = rep(torch.from_numpy(tspace.tokens)), rep(torch.from_numpy(tspace.lengths))
        cache = None
        if cfg.loss.num_hard_negatives:
            with torch.no_grad():
                cache = rep(loop.sse.target_embeddings(
                    loop.inference_params(state), model_cfg, tokens=tt[CPU], lengths=tl[CPU]))
        with logged() as one:
            step(state, packed[0], tt, tl, tgt_emb_cache=cache)
        with logged() as many:
            chain(state, packed[:RULE_K], tt, tl, cache)
        out["logs"][mode] = {"step": one, "chain": many}
    outcomes = {}
    for case, error, reading in (
            ("agreed", None, {"graphs": 1}),
            ("one failed", RuntimeError("made to fail") if pid == 1 else None, {"graphs": 1}),
            ("readings differ", None, {"graphs": 1 + pid})):
        try:
            graphs.agree(error, reading, "a test capture")
            outcomes[case] = "returned"
        except RuntimeError as e:
            outcomes[case] = str(e)
    out["agree"] = outcomes
    return out


class StandInRecorder:
    """``utils.graphs.Recorder`` on the CPU: ``record`` runs the program
    once (its collectives too, over gloo) and agrees with the other ranks
    as the real one does where ``agree`` is set; each replay runs it again
    on the same fixed buffers, as a replay of its graphs reads them."""

    def __init__(self, cards, per_card=None, split=False):
        from sse_tpu_torch.ops import GraphLaunches
        from sse_tpu_torch.utils import graphs

        self.cards, self.agree, self.agreed = list(cards), False, False
        self.launches = GraphLaunches()
        self.on, self.copy, self.new_pass = graphs.EAGER.on, graphs.EAGER.copy, graphs.EAGER.new_pass

    def warm(self, run):
        run()

    def record(self, run):
        from sse_tpu_torch.utils import graphs

        self.run = run
        with self.launches.capturing():
            out = run()
        if self.agree:
            graphs.agree(None, {"collectives": dict(self.launches.collectives)}, "a stand-in")
            self.agreed = True
        return out

    def replay(self):
        return self.run()


class StandInCaptured:
    """``utils.graphs.Captured`` on the CPU: its warm-up runs ``run`` once,
    and each replay runs it again on the same fixed buffers."""

    def __init__(self, run, dev, pool, side, pack=None):
        from sse_tpu_torch.ops import GraphLaunches

        self.run, self.launches = run, GraphLaunches()
        with self.launches.capturing():
            self.first = run()
        self.seconds, self.mib = 0.0, 0.0

    def take_first(self):
        out, self.first = self.first, None
        return out

    def replay(self):
        return self.run()


def stand_in(pid: int, nproc: int) -> dict:
    """``stand_in``'s readings (see the module docstring)."""

    from sse_tpu_torch.parallel.mesh import Replicated
    from sse_tpu_torch.serve.engine import build_fused_query_fn
    from sse_tpu_torch.train import grid, loop
    from sse_tpu_torch.utils import graphs

    distributed.captures = lambda: True  # what NCCL on a card a rank answers
    distributed.check_capturable = lambda: None
    loop._captures = lambda dev: True
    graphs.Recorder, graphs.Captured = StandInRecorder, StandInCaptured
    pools = iter(range(1000))
    torch.cuda.graph_pool_handle = lambda: next(pools)
    torch.cuda.Stream = lambda device: "side"
    torch.cuda.device = lambda device: contextlib.nullcontext()
    out = {"pid": pid}
    for mode in ("full", "flagship"):
        pairs, tspace, model_cfg, cfg = build_problem(mode)
        mesh = make_mesh(data=2 * nproc, model=1, devices=[CPU, CPU])
        state = grid.place_state(loop.init_train_state(model_cfg, cfg, device="cpu"), mesh)
        kw = dict(packed_width=pairs.src.shape[1], num_label_cols=1 if mode == "full" else 2,
                  mesh=mesh)
        eager = loop._eager_chain(loop.make_train_step(model_cfg, cfg, **kw), RULE_K)
        chain = loop.make_train_step(model_cfg, cfg, chain=RULE_K, **kw)
        it = loop.BatchIterator(pairs, cfg.batch_size, seed=cfg.seed, process_index=pid,
                                process_count=nproc)
        batches = [loop.pack_batch(b) for e in range(2) for b in it.epoch_batches(e)]
        chunks = [torch.from_numpy(np.stack(batches[i : i + RULE_K])) for i in (0, RULE_K)]
        rep = lambda x: Replicated({CPU: x})  # noqa: E731
        tt, tl = rep(torch.from_numpy(tspace.tokens)), rep(torch.from_numpy(tspace.lengths))
        cache = None
        if cfg.loss.num_hard_negatives:
            with torch.no_grad():
                cache = rep(loop.sse.target_embeddings(
                    loop.inference_params(state), model_cfg, tokens=tt[CPU], lengths=tl[CPU]))
        want, got = state, state
        for c in chunks:
            want, wm = eager(want, c, tt, tl, cache)
            got, gm = chain(got, c, tt, tl, cache)  # the capture, then a replay
            want = grid.with_tensors(want, [x.clone() for x in grid.state_tensors(want)],
                                     want.step)
        (made,) = chain.chains.values()
        out[mode] = {"agreed": made.rec.agreed, "replays_equal": _digest(
            grid.state_tensors(got)) == _digest(grid.state_tensors(want)) and all(
                torch.equal(gm[k], wm[k]) for k in wm), "digest": _digest(grid.state_tensors(got)),
            "collectives": dict(made.rec.launches.collectives)}
    emb, ids, texts, cfg, params, tokens, lengths = serve_problem()
    from sse_tpu_torch.index.sharded_index import from_embeddings

    mesh = make_mesh(data=1, model=2 * nproc, devices=[CPU, CPU])
    idx = from_embeddings(emb, ids, texts, mesh=mesh)
    fn = build_fused_query_fn(cfg, k=5, num_real=idx.num_real, mesh=mesh)
    first = fn.replay(params, idx.emb, tokens, lengths, idx.num_real)
    again = fn.replay(params, idx.emb, tokens, lengths, idx.num_real)
    run = fn.run(params, idx.emb, tokens, lengths, idx.num_real)
    out["query"] = {"exchange": fn.exchange, "counts": fn.stats.counts(),
                    **{name: [x[0].tolist(), x[1].tolist()]
                       for name, x in (("first", first), ("replay", again), ("eager", run))}}
    return out


GPU_K = 4  # steps of the chain the gpu_* modes capture


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def gpu_chain(pid: int, nproc: int, fail: bool = False) -> dict:
    """A chain of GPU_K grid steps of the flagship problem (towers 128
    wide) on a (num_processes, 1) grid, a card a rank: the replay of one
    chunk against the eager chain from the same state (state digests, and
    whether two eager runs agree), a second replay carrying the first's
    state, both under sync debug "error"; the graphs and collectives of a
    replay. With ``fail``, rank 1's capture reads a loss on the host, and
    each rank reports the error its chain call raised."""
    import dataclasses

    from sse_tpu_torch.parallel.mesh import Replicated
    from sse_tpu_torch.train import grid, loop

    dev = distributed.local_device()
    pairs, tspace, model_cfg, cfg = build_problem("flagship", width=128)
    cfg = dataclasses.replace(cfg, steps_per_dispatch=GPU_K)
    mesh = make_mesh(data=nproc, model=1)
    state = grid.place_state(loop.init_train_state(model_cfg, cfg, device=dev), mesh)
    kw = dict(packed_width=pairs.src.shape[1], num_label_cols=2, mesh=mesh)
    eager = loop._eager_chain(loop.make_train_step(model_cfg, cfg, **kw), GPU_K)
    chain = loop.make_train_step(model_cfg, cfg, chain=GPU_K, **kw)
    it = loop.BatchIterator(pairs, 16, seed=0, process_index=pid, process_count=nproc)
    batches = [loop.pack_batch(b) for e in range(3) for b in it.epoch_batches(e)]
    chunks = [torch.from_numpy(np.stack(batches[i : i + GPU_K])).to(dev)
              for i in range(0, 3 * GPU_K, GPU_K)]
    rep = lambda x: Replicated({dev: x.to(dev)})  # noqa: E731
    tt, tl = rep(torch.from_numpy(tspace.tokens)), rep(torch.from_numpy(tspace.lengths))
    with torch.no_grad():
        cache = rep(loop.sse.target_embeddings(loop.inference_params(state), model_cfg,
                                               tokens=tt[dev], lengths=tl[dev]))
    out = {"pid": pid, "captures": distributed.captures(), "captured": hasattr(chain, "chains")}
    if fail and pid == 1:
        from sse_tpu_torch.train import losses

        real = losses.similarity_loss

        def reads_the_host(*a, **k):
            loss, acc = real(*a, **k)
            if torch.cuda.is_current_stream_capturing():
                float(loss)  # a host read: no CUDA graph can hold it
            return loss, acc

        losses.similarity_loss = reads_the_host
    if fail:
        try:
            chain(state, chunks[0], tt, tl, cache)
            out["error"] = None
        except RuntimeError as e:
            out["error"] = str(e)[:500]
        return out
    e1, _ = eager(state, chunks[1], tt, tl, cache)
    e1 = _digest(grid.state_tensors(e1))
    e2, _ = eager(state, chunks[1], tt, tl, cache)
    out["eager_repeats"] = e1 == _digest(grid.state_tensors(e2))
    e3, _ = eager(e2, chunks[2], tt, tl, cache)
    e3 = _digest(grid.state_tensors(e3))
    chain(state, chunks[0], tt, tl, cache)  # warm-up step, capture, first replay
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        g1, m1 = chain(state, chunks[1], tt, tl, cache)
        first = [x.clone() for x in grid.state_tensors(g1)]  # the next replay rewrites g1
        g2, m2 = chain(g1, chunks[2], tt, tl, cache)  # carries the state the first returned
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    d1 = _digest(first)
    made = next(iter(chain.chains.values()))
    out.update(eager=e1, replay=d1, eager_carried=e3, replay_carried=_digest(grid.state_tensors(g2)),
               finite=bool(torch.isfinite(m2["loss"]).all()),
               graphs=sum(made.rec.graphs.values()), copies=sum(
                   a[0] == "copy" for a in made.rec.actions),
               collectives=dict(made.launches.collectives), gru=made.launches.rnn)
    return out


def gpu_query(pid: int, nproc: int) -> dict:
    """The bench's GRU model over 16,384 random bf16 rows on a (1,
    num_processes) grid, a card a rank: at B=8 and 64, the capturing call,
    a replay under sync debug "error" and the eager call (``.run``), the
    rows and values of each, and the graph counts."""
    from sse_tpu_torch import bench
    from sse_tpu_torch.models import sse
    from sse_tpu_torch.parallel import RowShards
    from sse_tpu_torch.serve.engine import build_fused_query_fn

    dev = distributed.local_device()
    mesh = make_mesh(1, nproc)
    cfg = bench._default_model()
    params = sse.init_params(cfg, torch.Generator().manual_seed(0), dev)
    rows = 16384
    emb = RowShards.from_tensor(bench._device_index(rows, 128, torch.bfloat16, dev,
                                                    shards=nproc), mesh)
    fn = build_fused_query_fn(cfg, 10, rows - 100, mesh=mesh)
    out = {"pid": pid, "exchange": fn.exchange, "calls": {}}
    for b in (8, 64):
        gen = torch.Generator(device=dev).manual_seed(b)
        toks = bench._random_tokens(gen, (b, 20), 8000, dev)
        lens = torch.randint(1, 21, (b,), generator=gen, device=dev, dtype=torch.int32)
        first = fn(params, emb, toks, lens)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(params, emb, toks, lens)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eager = fn.run(params, emb, toks, lens, rows - 100)
        out["calls"][b] = {name: [x[0].tolist(), x[1].tolist()]
                           for name, x in (("first", first), ("replay", got), ("eager", eager))}
    out["counts"] = fn.stats.counts()
    return out


def params_sums(params):
    leaves = [x for x in _leaves(params)]
    return (float(sum(x.double().sum() for x in leaves)),
            float(sum(x.double().abs().sum() for x in leaves)))


def _leaves(tree):
    from sse_tpu_torch.train.loop import tree_leaves

    return tree_leaves(tree)


def cp_problem():
    """A 2-block RoPE transformer tower (mean readout), 4 rows of 16 tokens
    and the cotangent of the encode."""
    from sse_tpu_torch.models.towers import TowerConfig, init_tower

    cfg = TowerConfig(vocab_size=40, embed_dim=16, hidden=16, encoding_dim=8, cell="transformer",
                      num_layers=2, num_heads=2, readout="mean", max_len=32)
    params = init_tower(cfg, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(2, 40, size=(4, 16)).astype(np.int32))
    lengths = torch.tensor([16, 9, 3, 12], dtype=torch.int32)
    v = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    return cfg, params, tokens, lengths, v


def cp_grads(encode, params, tokens, lengths, v):
    """(the encode, the gradient of sum(encode · v) by param leaf)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
    from sse_tpu_torch.train.loop import _unflatten

    out = encode(_unflatten(params, leaves), tokens, lengths)
    grads = torch.autograd.grad((out * v).sum(), leaves)
    return out.detach(), grads


def saved_problem():
    """The index the two processes save: 50 seeded rows, escaped texts."""
    emb = np.random.default_rng(42).standard_normal((50, 16)).astype(np.float32)
    return emb, [f"d{i}" for i in range(50)], [f"text\t{i}\n" for i in range(50)]


def sum_problem(pid: int) -> torch.Tensor:
    """Rank ``pid``'s addend for ``sum_over_ranks``: float32 values over
    twelve orders of magnitude, whose sum rounds."""
    rng = np.random.default_rng(100 + pid)
    x = rng.standard_normal((37, 5)) * 10.0 ** rng.integers(-6, 6, size=(37, 5))
    return torch.from_numpy(x.astype(np.float32))


def main() -> int:
    pid, nproc, coord, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    distributed.initialize(coord, nproc, pid)
    info = distributed.process_info()
    assert info["process_index"] == pid and info["process_count"] == nproc, info
    if mode in ("full", "flagship"):
        from sse_tpu_torch.train import inference_params, train
        from sse_tpu_torch.train.grid import copies_identical

        import dataclasses

        from sse_tpu_torch.train.grid import gather_state

        pairs, tspace, model_cfg, cfg = build_problem(mode, sys.argv[5])
        if len(sys.argv) > 6:
            cfg = dataclasses.replace(cfg, steps_per_dispatch=int(sys.argv[6]))
        start = load_state(sys.argv[7]) if len(sys.argv) > 7 else None
        mesh = make_mesh(data=2 * nproc, model=1, devices=[CPU, CPU])
        state = train(model_cfg, cfg, pairs, tspace, process_index=pid, process_count=nproc,
                      mesh=mesh, state=start)
        table_sum, table_abs = params_sums(inference_params(state))
        out = {"pid": pid, "step": int(state.step), "table_sum": table_sum,
               "table_abs": table_abs, "copies_identical": copies_identical(state),
               "digest": state_digest(gather_state(state))}
        print("RESULT " + json.dumps(out), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    if mode.startswith("gpu_"):
        out = gpu_query(pid, nproc) if mode == "gpu_query" else gpu_chain(
            pid, nproc, fail=mode == "gpu_fail")
        print("RESULT " + json.dumps(out), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    if mode in ("rule", "stand_in"):
        out = capture_rule(pid, nproc) if mode == "rule" else stand_in(pid, nproc)
        print("RESULT " + json.dumps(out), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    if mode == "sum":
        t = sum_problem(pid)
        before = t.clone()
        total = distributed.sum_over_ranks(t)
        out = {"pid": pid, "bits": total.view(torch.int32).reshape(-1).tolist(),
               "left_as_it_was": bool(torch.equal(t.view(torch.int32), before.view(torch.int32)))}
        print("RESULT " + json.dumps(out), flush=True)
        torch.distributed.destroy_process_group()
        return 0
    if mode == "cp":
        from sse_tpu_torch.parallel.context import cp_mesh, make_cp_encoder

        cfg, params, tokens, lengths, v = cp_problem()
        seq = cp_mesh(2 * nproc, devices=[CPU, CPU])
        assert seq.multi_process and seq.local == [2 * pid, 2 * pid + 1]
        out, grads = cp_grads(make_cp_encoder(cfg, seq), params, tokens, lengths, v)
        print("RESULT " + json.dumps({"pid": pid, "out": out.tolist(),
                                      "grads": [g.reshape(-1).tolist() for g in grads]}),
              flush=True)
        torch.distributed.destroy_process_group()
        return 0
    mesh = make_mesh(data=1, model=2 * nproc, devices=[CPU, CPU])
    assert mesh.multi_process and mesh.ranks.tolist() == [[r for r in range(nproc) for _ in (0, 1)]]

    from sse_tpu_torch.index.sharded_index import from_embeddings

    if mode == "serve":
        from sse_tpu_torch.serve.engine import build_fused_query_fn

        emb, ids, texts, cfg, params, tokens, lengths = serve_problem()
        idx = from_embeddings(emb, ids, texts, mesh=mesh)
        vals, rows = build_fused_query_fn(cfg, k=5, num_real=idx.num_real, mesh=mesh)(
            params, idx.emb, tokens, lengths)
        scores = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
        _, top = distributed_topk(torch.from_numpy(scores), 5, mesh)
        out = {"pid": pid, "backend": distributed.backend(), "vals": vals.tolist(),
               "rows": rows.tolist(),
               "topk_ok": bool((top.numpy() == np.argsort(-scores, axis=1)[:, :5]).all())}
    else:
        emb, ids, texts = saved_problem()
        from_embeddings(emb, ids, texts, mesh=mesh).save(sys.argv[5])
        out = {"pid": pid, "saved": True}
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
