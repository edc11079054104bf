"""Worker of the port's two-process tests (tests/test_torch_multiprocess.py).

    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> serve
    python tests/_torch_mp_worker.py <process_id> <num_processes> <coordinator> indexsave <dir>

Each process holds two CPU entries of one global (1, 2 · num_processes)
grid, joined over gloo by ``sse_tpu_torch.parallel.distributed``. ``serve``
runs the sharded fused query (encode → per-shard top-k → exchange →
merge) and ``distributed_topk`` and prints their results on a ``RESULT``
line; ``indexsave`` saves a row-sharded index, each process its own
blocks. Imports torch and the port only.
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


def saved_problem():
    """The index the two processes save: 50 seeded rows, escaped texts."""
    emb = np.random.default_rng(42).standard_normal((50, 16)).astype(np.float32)
    return emb, [f"d{i}" for i in range(50)], [f"text\t{i}\n" for i in range(50)]


def main() -> int:
    pid, nproc, coord, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    distributed.initialize(coord, nproc, pid)
    info = distributed.process_info()
    assert info["process_index"] == pid and info["process_count"] == nproc, info
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
