"""Model definitions (port of ``sse_tpu.models``)."""

from sse_tpu_torch.models.sse import (
    NetworkMode,
    SSEConfig,
    encode_source,
    encode_target,
    init_params,
    target_embeddings,
)
from sse_tpu_torch.models.towers import TowerConfig, init_tower

__all__ = [
    "NetworkMode",
    "SSEConfig",
    "TowerConfig",
    "encode_source",
    "encode_target",
    "init_params",
    "init_tower",
    "target_embeddings",
]
