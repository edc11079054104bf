"""Parallelism layer (port of ``sse_tpu.parallel``): the ('data', 'model')
grid of devices, the placement of a train state on it, the exact top-k
merge across index row shards, context parallelism and the process group
across several processes.

* ``mesh``: ``make_mesh``, the grid; ``replicate`` (params on each
  device), ``RowShards`` (index rows split over 'model'), ``place`` /
  ``gather`` / ``param_shardings`` (a train state on the grid: the target
  table over 'model', everything else replicated) and ``batch_rows`` (a
  batch over 'data');
* ``topk``: the exact cross-shard merge on int64 composites;
* ``context``: the transformer encode with its sequence split over a
  ``{'seq': n}`` grid (``cp_mesh``, ``make_cp_encoder``,
  ``encode_context_parallel``);
* ``distributed``: ``torch.distributed`` bring-up (NCCL when every rank
  has a card of its own, gloo otherwise) and the collectives that carry
  gradients. The backend decides what is captured across processes
  (``distributed.captures()``): over NCCL a grid's chunk of train steps
  (``train.loop._GridChain``) and its query (``serve.engine.GridQuery``,
  the exchange and the merge included) are one CUDA graph a rank with
  their collectives inside; over gloo, whose collectives run on the
  host, both run eagerly, as do the context-parallel encode, the mining
  refresh and a delete's row gather on any backend.
"""

from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.context import (
    check_cp_config,
    cp_mesh,
    encode_context_parallel,
    make_cp_encoder,
)
from sse_tpu_torch.parallel.mesh import (
    Mesh,
    Replicated,
    RowShards,
    batch_rows,
    gather,
    make_mesh,
    param_shardings,
    place,
    replicate,
)
from sse_tpu_torch.parallel.topk import distributed_topk, local_topk_merge_body

__all__ = [
    "Mesh",
    "Replicated",
    "RowShards",
    "batch_rows",
    "check_cp_config",
    "cp_mesh",
    "distributed",
    "distributed_topk",
    "encode_context_parallel",
    "gather",
    "local_topk_merge_body",
    "make_cp_encoder",
    "make_mesh",
    "param_shardings",
    "place",
    "replicate",
]
