"""Parallelism layer (port of ``sse_tpu.parallel``): the ('data', 'model')
grid of devices, the exact top-k merge across index row shards, and the
process group across several processes.

* ``mesh``: ``make_mesh``, the grid; ``replicate`` (params on each
  device) and ``RowShards`` (index rows split over 'model');
* ``topk``: the exact cross-shard merge on int64 composites;
* ``distributed``: ``torch.distributed`` bring-up (NCCL when every rank
  has a card of its own, gloo otherwise).

The JAX package's context parallelism (``cp_mesh``, ``make_cp_encoder``,
``encode_context_parallel``) and its ``param_shardings`` belong to
training on a mesh, which is not ported yet (ROADMAP.md §1 item 5).
"""

from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import Mesh, Replicated, RowShards, make_mesh, replicate
from sse_tpu_torch.parallel.topk import distributed_topk, local_topk_merge_body

__all__ = [
    "Mesh",
    "Replicated",
    "RowShards",
    "distributed",
    "distributed_topk",
    "local_topk_merge_body",
    "make_mesh",
    "replicate",
]
