"""Encoder towers → fixed-size L2-normalized vectors (port of
``sse_tpu/models/towers.py``).

Ported: the GRU cell (fused-reset form), stacked layers with optional
identity residuals, the final-state readout, the tanh projection, the L2
norm and the train-only dropout. Every layer goes through
``rnn.RNNLayer``, so the tower is differentiable end to end. Other cells (lstm, transformer, bow) and readouts (mean,
attention) raise ``NotImplementedError``; ROADMAP.md §1 queues them.

Precision policy, as in the JAX package: matmul operands are bfloat16,
accumulation and the recurrent carry are float32. A plain product of
bf16-rounded operands is written ``a.bfloat16().float() @ b...``: a bf16
``torch.matmul`` would round its result to bf16 and lose the float32
accumulation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from sse_tpu_torch.ops import rnn
from sse_tpu_torch.ops.rnn import bf16_matmul, gru_cell

Params = Dict[str, Any]

_COMPUTE_DTYPE = torch.bfloat16
_NOT_PORTED = "not ported yet (see ROADMAP.md §1)"


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """Mirror of ``sse_tpu.models.towers.TowerConfig``: same fields, same
    defaults (see that class for what each one means)."""

    vocab_size: int
    embed_dim: int = 128
    hidden: int = 128
    num_layers: int = 1
    encoding_dim: int = 64
    cell: str = "gru"
    readout: str = "final"
    num_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512
    pos_encoding: str = "rope"
    use_pallas_scan: Optional[bool] = None
    dropout: float = 0.0
    residual: bool = False
    embed_grad: str = "take"


def _check_supported(cfg: TowerConfig) -> None:
    if cfg.cell != "gru":
        raise NotImplementedError(f"cell={cfg.cell!r} is {_NOT_PORTED}")
    if cfg.readout != "final":
        raise NotImplementedError(f"readout={cfg.readout!r} is {_NOT_PORTED}")


def _glorot(gen: torch.Generator, shape, device) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(device)


def init_tower(
    cfg: TowerConfig,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
) -> Params:
    """Random tower params in the JAX checkpoint layout: ``embed``
    [V, E], ``proj_w`` [H, D], ``proj_b`` [D], and per layer one fused
    ``w`` [(in+H), 3H] over [x; h] with ``b`` [3H] (gate order z, r, n).
    The numbers differ from ``sse_tpu``'s init for the same seed; parity
    tests convert JAX params with ``sse_tpu_torch.convert`` instead."""
    _check_supported(cfg)
    gen = generator if generator is not None else torch.Generator()
    p: Params = {
        "embed": (
            torch.randn(
                (cfg.vocab_size, cfg.embed_dim), generator=gen,
                dtype=torch.float32,
            )
            * 0.05
        ).to(device),
        "proj_w": _glorot(gen, (cfg.hidden, cfg.encoding_dim), device),
        "proj_b": torch.zeros((cfg.encoding_dim,), device=device),
    }
    layers = []
    for l in range(cfg.num_layers):
        in_dim = cfg.embed_dim if l == 0 else cfg.hidden
        layers.append(
            {
                "w": torch.cat(
                    [
                        _glorot(gen, (in_dim, 3 * cfg.hidden), device),
                        _glorot(gen, (cfg.hidden, 3 * cfg.hidden), device),
                    ],
                    dim=0,
                ),
                "b": torch.zeros((3 * cfg.hidden,), device=device),
            }
        )
    p["layers"] = layers
    return p


def _split_weights(layer: Params, cell: str):
    """The fused [(in+H), G·H] kernel → (x-part, h-part, bias)."""
    n_gates = 3 if cell == "gru" else 4
    h = layer["w"].shape[1] // n_gates
    in_dim = layer["w"].shape[0] - h
    return layer["w"][:in_dim], layer["w"][in_dim:], layer["b"]


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout (scale-at-train, identity-at-eval), as
    ``towers.py:576-580``; the keep mask is drawn from ``gen``."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def encode_raw(
    params: Params,
    cfg: TowerConfig,
    tokens: torch.Tensor,  # [B, L] int
    lengths: torch.Tensor,  # [B] int
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Token ids → L2-normalized [B, encoding_dim] float32 embeddings.
    Each recurrent layer is one ``rnn.RNNLayer`` call: the hand-written
    GRU kernels on a CUDA device, their plain versions on the CPU.

    ``dropout_generator`` (a ``torch.Generator`` on the tokens' device)
    turns on ``cfg.dropout`` on the embeddings and on the readout
    features (training only); None, what eval and serving pass, keeps the
    forward deterministic."""
    _check_supported(cfg)
    train = dropout_generator is not None and cfg.dropout > 0.0
    L = tokens.shape[1]
    with record_function("sse.tower.embed"):
        emb = params["embed"][tokens.long()]  # [B, L, E] fp32
        if train:
            emb = _dropout(emb, cfg.dropout, dropout_generator)
    pos = torch.arange(L, device=tokens.device)[None, :]
    valid = (pos < lengths[:, None]).float()  # [B, L]
    xs = emb.transpose(0, 1).to(_COMPUTE_DTYPE).contiguous()  # [L, B, E]
    mask = valid.T[:, None, :].contiguous()  # [L, 1, B]
    final = None
    for li, layer in enumerate(params["layers"]):
        ys, fin = rnn.RNNLayer.apply(xs, mask, *_split_weights(layer, cfg.cell))
        if cfg.residual and li > 0:
            # identity skip; carry-freezing makes the stream's last step
            # each row's value at its own length (towers.py:628-637)
            final = fin + xs[-1].float()
            xs = xs + ys
        else:
            final, xs = fin, ys
    if train:
        final = _dropout(final, cfg.dropout, dropout_generator)
    out = torch.tanh(bf16_matmul(final, params["proj_w"]) + params["proj_b"])
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-6)


__all__ = [
    "TowerConfig",
    "init_tower",
    "gru_cell",
    "encode_raw",
]
