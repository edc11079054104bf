"""Eval at index scale (port of ``sse_tpu/evals/at_scale.py``): recall@k
scored through the same fused encode + top-k function that serves queries
(``build_fused_query_fn``: the streaming or two-phase top-k kernels on a
GPU, per row block and merged exactly when the index lies on a grid), so
large-target-space evaluation costs what serving costs and exercises the
serving path.

(The ``Evaluator`` in ``evals/recall.py`` re-encodes the targets on every
call, which is right during training; this one takes a built
``ShardedIndex``, which is right after indexing.)
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from sse_tpu_torch.data.corpus import EncodedPairs
from sse_tpu_torch.evals.recall import recall_at_k
from sse_tpu_torch.index.sharded_index import ShardedIndex
from sse_tpu_torch.models.sse import SSEConfig
from sse_tpu_torch.parallel.mesh import replicate
from sse_tpu_torch.serve.engine import build_fused_query_fn


def evaluate_against_index(
    params,
    model_cfg: SSEConfig,
    eval_pairs: EncodedPairs,
    index: ShardedIndex,
    ks: Sequence[int] = (1, 10),
    batch_size: int = 256,
) -> Dict[str, float]:
    """recall@k and MRR of the eval pairs against ``index``, in batches of
    ``batch_size`` (the last one padded with length-1 rows, as in JAX, so
    every call has one shape); rows stay on the device until one copy at
    the end. An index with a mesh is scored through the sharded function,
    its params replicated on the grid (``batch_size`` must divide over
    the 'data' axis)."""
    ks = [k for k in ks if k <= index.num_real]
    if index.mesh is not None:
        params = replicate(params, index.mesh)
    fused = build_fused_query_fn(
        model_cfg, k=max(ks), num_real=index.num_real, mesh=index.mesh
    )
    device = index.emb.device
    n = eval_pairs.num_examples
    tops = []
    for lo in range(0, n, batch_size):
        src = np.asarray(eval_pairs.src[lo : lo + batch_size])
        sl = np.asarray(eval_pairs.src_len[lo : lo + batch_size])
        if src.shape[0] < batch_size:
            pad = batch_size - src.shape[0]
            src = np.concatenate([src, np.zeros((pad, src.shape[1]), src.dtype)])
            sl = np.concatenate([sl, np.ones((pad,), sl.dtype)])
        _, rows = fused(
            params, index.emb,
            torch.from_numpy(np.ascontiguousarray(src)).to(device),
            torch.from_numpy(np.ascontiguousarray(sl)).to(device),
        )
        tops.append(rows)
    top = torch.cat(tops).cpu().numpy()[:n]
    return recall_at_k(top, eval_pairs.label_sets, ks)
