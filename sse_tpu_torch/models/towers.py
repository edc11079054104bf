"""Encoder towers → fixed-size L2-normalized vectors (port of
``sse_tpu/models/towers.py``).

Ported: the recurrent towers — the GRU cell (fused-reset form) and the
LSTM cell (+1 forget bias), stacked layers with optional identity
residuals — with the final, mean and attention readouts, the tanh
projection, the L2 norm and the train-only dropout. Every layer goes
through ``rnn.RNNLayer``, so the tower is differentiable end to end. The
transformer and bag-of-subwords towers raise ``NotImplementedError``;
ROADMAP.md §1 queues them.

Precision policy, as in the JAX package: matmul operands are bfloat16,
accumulation and the recurrent carry are float32. A plain product of
bf16-rounded operands is written ``bf16_matmul``: a bf16 ``torch.matmul``
would round its result to bf16 and lose the float32 accumulation. The
attention readout's two einsums take float32 operands in full float32,
as the JAX package's default-precision ``einsum`` does on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from sse_tpu_torch.ops import rnn
from sse_tpu_torch.ops.rnn import bf16_matmul, gru_cell, lstm_cell, split_weights

Params = Dict[str, Any]

_COMPUTE_DTYPE = torch.bfloat16
_NOT_PORTED = "not ported yet (see ROADMAP.md §1)"
_READOUTS = ("final", "mean", "attention")


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
    if cfg.cell in ("transformer", "bow"):
        raise NotImplementedError(f"cell={cfg.cell!r} is {_NOT_PORTED}")
    if cfg.cell not in ("gru", "lstm"):
        raise ValueError(f"unknown cell {cfg.cell!r}")
    if cfg.readout not in _READOUTS:
        raise ValueError(f"unknown readout {cfg.readout!r}")


def _glorot(gen: torch.Generator, shape, device) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(device)


def init_tower(
    cfg: TowerConfig,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> Params:
    """Random tower params in the JAX checkpoint layout: ``embed``
    [V, E], ``proj_w`` [H, D], ``proj_b`` [D]; per layer one fused ``w``
    [(in+H), G·H] over [x; h] with ``b`` [G·H], gate order (z, r, n) for
    the GRU (G=3) and (i, f, g, o) for the LSTM (G=4); with the attention
    readout ``attn_w`` [H, H], ``attn_b`` [H] and ``attn_v`` [H]
    (``towers.py:195-227``). The numbers differ from ``sse_tpu``'s init
    for the same seed; parity tests convert JAX params with
    ``sse_tpu_torch.convert`` instead."""
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
    if cfg.readout == "attention":
        p["attn_w"] = _glorot(gen, (cfg.hidden, cfg.hidden), device)
        p["attn_b"] = torch.zeros((cfg.hidden,), device=device)
        p["attn_v"] = (
            torch.randn((cfg.hidden,), generator=gen, dtype=torch.float32) * 0.05
        ).to(device)
    n = (3 if cfg.cell == "gru" else 4) * cfg.hidden
    layers = []
    for l in range(cfg.num_layers):
        in_dim = cfg.embed_dim if l == 0 else cfg.hidden
        layers.append(
            {
                "w": torch.cat(
                    [_glorot(gen, (in_dim, n), device), _glorot(gen, (cfg.hidden, n), device)],
                    dim=0,
                ),
                "b": torch.zeros((n,), device=device),
            }
        )
    p["layers"] = layers
    return p


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout (scale-at-train, identity-at-eval), as
    ``towers.py:576-580``; the keep mask is drawn from ``gen``."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def _masked_mean(states: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """states [B, L, H], valid [B, L] → [B, H] (``towers.py:529-532``)."""
    denom = torch.clamp(valid.sum(1, keepdim=True), min=1.0)
    return (states * valid[:, :, None]).sum(1) / denom


def _attention_readout(
    p: Params, states: torch.Tensor, valid: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """Self-attentive pooling with the pooled-summary residual
    (``towers.py:535-561``): ``score_t = v·tanh(W·h_t + b)`` (W·h_t on bf16
    operands, float32 sums), masked softmax over the valid steps, the
    weighted sum of the float32 states, plus ``residual``."""
    proj = torch.tanh(bf16_matmul(states, p["attn_w"]) + p["attn_b"])  # [B, L, H]
    scores = torch.einsum("blh,h->bl", proj, p["attn_v"])
    scores = torch.where(valid > 0, scores, torch.finfo(torch.float32).min)
    alpha = torch.softmax(scores, dim=-1)  # [B, L]
    return torch.einsum("bl,blh->bh", alpha, states) + residual


def encode_raw(
    params: Params,
    cfg: TowerConfig,
    tokens: torch.Tensor,  # [B, L] int
    lengths: torch.Tensor,  # [B] int
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Token ids → L2-normalized [B, encoding_dim] float32 embeddings.
    Each recurrent layer is one ``rnn.RNNLayer`` call: the hand-written
    kernels on a CUDA device, their plain versions on the CPU; the
    readout is plain tensor code (XLA in the JAX package, not Pallas).

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
        ys, fin = rnn.RNNLayer.apply(xs, mask, *split_weights(layer, cfg.cell), cfg.cell)
        if cfg.residual and li > 0:
            # identity skip; carry-freezing makes the stream's last step
            # each row's value at its own length (towers.py:628-637)
            final = fin + xs[-1].float()
            xs = xs + ys
        else:
            final, xs = fin, ys
    if cfg.readout == "final":
        feats = final  # [B, H] fp32: the state at each row's own length
    else:
        with record_function("sse.tower.readout"):
            states = xs.transpose(0, 1).float()  # [B, L, H]
            if cfg.readout == "mean":
                feats = _masked_mean(states, valid)
            else:
                feats = _attention_readout(params, states, valid, final)
    if train:
        feats = _dropout(feats, cfg.dropout, dropout_generator)
    out = torch.tanh(bf16_matmul(feats, params["proj_w"]) + params["proj_b"])
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-6)


__all__ = [
    "TowerConfig",
    "encode_raw",
    "gru_cell",
    "init_tower",
    "lstm_cell",
]
