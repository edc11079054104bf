"""Worker of the port's two-process tests (tests/test_torch_multiprocess.py).

    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> serve
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> indexsave <dir>
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> full|flagship adam|sgd
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> cp

Each process holds two CPU entries of one global grid, joined over gloo
by ``sse_tpu_torch.parallel.distributed``. ``serve`` runs the sharded
fused query (encode → per-shard top-k → exchange → merge) and
``distributed_topk`` on a (1, 2 · num_processes) grid and prints their
results on a ``RESULT`` line; ``indexsave`` saves a row-sharded index,
each process its own blocks. ``full`` and ``flagship`` train
``build_problem(mode, optimizer)`` through ``train()`` on a (2 · num_processes, 1)
grid, each process feeding its slice of the global batch; ``cp`` runs the
context-parallel transformer encode over a {'seq': 2 · num_processes}
grid across the processes, with its gradients. Imports torch and the
port only.
"""

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


def build_problem(mode: str, optimizer: str = "adam"):
    """tests/_mp_worker.py's problem in the port: 64 pairs, 12 targets,
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
    tw = TowerConfig(vocab_size=v, embed_dim=8, hidden=8, encoding_dim=8)
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

        pairs, tspace, model_cfg, cfg = build_problem(mode, sys.argv[5])
        mesh = make_mesh(data=2 * nproc, model=1, devices=[CPU, CPU])
        state = train(model_cfg, cfg, pairs, tspace, process_index=pid, process_count=nproc,
                      mesh=mesh)
        table_sum, table_abs = params_sums(inference_params(state))
        out = {"pid": pid, "step": int(state.step), "table_sum": table_sum,
               "table_abs": table_abs, "copies_identical": copies_identical(state)}
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
