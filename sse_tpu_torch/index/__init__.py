"""Device-resident target index (port of ``sse_tpu.index``)."""

from sse_tpu_torch.index.sharded_index import (
    ShardedIndex,
    build_index,
    from_embeddings,
    quantize_rows,
)

__all__ = ["ShardedIndex", "build_index", "from_embeddings", "quantize_rows"]
