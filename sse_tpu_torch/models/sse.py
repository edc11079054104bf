"""The SSE dual-encoder model in its three network modes (port of
``sse_tpu/models/sse.py``; see that module for the mode semantics).
Both sides return L2-normalized float32 vectors in one ``encoding_dim``
space."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional

import torch

from sse_tpu_torch.models import towers
from sse_tpu_torch.models.towers import TowerConfig

Params = Dict[str, Any]


class NetworkMode(str, enum.Enum):
    SOURCE_ENCODER_ONLY = "source-encoder-only"
    SHARED_ENCODER = "shared-encoder"
    DUAL_ENCODER = "dual-encoder"


@dataclasses.dataclass(frozen=True)
class SSEConfig:
    """Mirror of ``sse_tpu.models.sse.SSEConfig``."""

    mode: NetworkMode
    src_tower: TowerConfig
    tgt_tower: Optional[TowerConfig] = None
    num_targets: int = 0

    def __post_init__(self):
        if self.mode == NetworkMode.SOURCE_ENCODER_ONLY:
            if self.num_targets <= 0:
                raise ValueError("source-encoder-only needs num_targets > 0")
        elif self.mode == NetworkMode.DUAL_ENCODER:
            if self.tgt_tower is None:
                raise ValueError("dual-encoder needs tgt_tower")
            if self.tgt_tower.encoding_dim != self.src_tower.encoding_dim:
                raise ValueError("towers must share encoding_dim")

    @property
    def encoding_dim(self) -> int:
        return self.src_tower.encoding_dim


def init_params(
    cfg: SSEConfig,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> Params:
    """Random params of every tower of ``cfg`` on ``device`` (the card
    unless the caller asks for another), in the JAX checkpoint layout:
    fused ``[(in+H), G·H]`` layer weights with gate order (z, r, n) for
    the GRU and (i, f, g, o) for the LSTM (``towers.init_tower``)."""
    gen = generator if generator is not None else torch.Generator()
    params: Params = {
        "src_tower": towers.init_tower(cfg.src_tower, gen, device)
    }
    if cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
        params["target_table"] = (
            torch.randn(
                (cfg.num_targets, cfg.encoding_dim), generator=gen,
                dtype=torch.float32,
            )
            * 0.05
        ).to(device)
    elif cfg.mode == NetworkMode.DUAL_ENCODER:
        params["tgt_tower"] = towers.init_tower(cfg.tgt_tower, gen, device)
    return params


def encode_source(
    params: Params,
    cfg: SSEConfig,
    tokens,
    lengths,
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Source text → [B, D] normalized embeddings. ``dropout_generator``
    enables the tower's train-time dropout; eval and serving pass none."""
    return towers.encode_raw(
        params["src_tower"], cfg.src_tower, tokens, lengths, dropout_generator
    )


def encode_target(
    params: Params,
    cfg: SSEConfig,
    tokens,
    lengths,
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Target text → [B, D] normalized embeddings (tower modes only)."""
    if cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
        raise ValueError(
            "source-encoder-only mode has no target tower; use "
            "target_embeddings(rows=...) on the learned table"
        )
    if cfg.mode == NetworkMode.SHARED_ENCODER:
        return towers.encode_raw(
            params["src_tower"], cfg.src_tower, tokens, lengths, dropout_generator
        )
    return towers.encode_raw(
        params["tgt_tower"], cfg.tgt_tower, tokens, lengths, dropout_generator
    )


def target_embeddings(
    params: Params,
    cfg: SSEConfig,
    tokens: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Normalized target-side embeddings: rows of the learned table in
    source-encoder-only mode (all rows if ``rows`` is None), otherwise
    the encoded target token batch."""
    if cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
        table = params["target_table"]
        if rows is not None:
            table = table[rows]
        return table / torch.clamp(
            torch.linalg.norm(table, dim=-1, keepdim=True), min=1e-6
        )
    if tokens is None or lengths is None:
        raise ValueError("tower modes need target tokens + lengths")
    emb = encode_target(params, cfg, tokens, lengths, dropout_generator)
    if rows is not None:
        emb = emb[rows]
    return emb
