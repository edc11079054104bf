"""Similarity losses: softmax cross-entropy over negatives (port of
``sse_tpu/train/losses.py``; see that module for the reference parity
notes). The JAX package computes these in plain XLA, so the port is
plain torch too.

Logits are scaled cosine similarities; the negatives are every target
(``full``), the other examples' targets (``inbatch``), or those plus K
uniform rows (``sampled``), optionally with mined hard negatives. A
candidate that is one of the example's own targets but not its
designated column is masked to ``finfo(float32).min``, as in JAX. Every
loss honours per-example weights (weight 0 = batch padding row).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

_MASKED = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Mirror of ``sse_tpu.train.losses.LossConfig``: same fields, same
    defaults."""

    kind: str = "inbatch"  # full | inbatch | sampled
    scale: float = 20.0  # cosine logit scale (temperature⁻¹)
    num_negatives: int = 128  # sampled mode: extra uniform negatives
    margin: float = 0.0  # additive margin on the positive's cosine
    bidirectional: bool = False  # average in target→source (tower modes)
    num_hard_negatives: int = 0  # mined hard negatives per example


def _weighted_ce(
    logits: torch.Tensor, label_col: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean weighted CE + accuracy. logits [B,C], label_col [B]."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, label_col[:, None].long())[:, 0]
    denom = torch.clamp(weight.sum(), min=1.0)
    loss = -(ll * weight).sum() / denom
    acc = ((logits.argmax(dim=-1) == label_col).float() * weight).sum() / denom
    return loss, acc.detach()


def full_softmax_loss(
    src_emb: torch.Tensor,  # [B, D] normalized
    tgt_all: torch.Tensor,  # [T, D] normalized
    labels: torch.Tensor,  # [B] rows into tgt_all
    weight: torch.Tensor,  # [B]
    scale: float,
    margin: float = 0.0,
    labels_multi: Optional[torch.Tensor] = None,  # [B, M] -1-padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    cos = src_emb.float() @ tgt_all.float().t()
    cols = torch.arange(cos.shape[1], device=cos.device)[None, :]
    if margin:
        cos = cos - margin * (cols == labels[:, None]).float()
    logits = scale * cos
    if labels_multi is not None and labels_multi.shape[1] > 1:
        # a multi-label example's OTHER correct targets are not negatives;
        # the designated positive stays column labels[:, 0]
        extra = labels_multi[:, 1:]  # [B, M-1]; -1 never matches a column
        false_neg = (cols[:, :, None] == extra[:, None, :]).any(dim=2)
        logits = logits.masked_fill(false_neg, _MASKED)
    return _weighted_ce(logits, labels, weight)


def candidate_softmax_loss(
    src_emb: torch.Tensor,  # [B, D]
    cand_emb: torch.Tensor,  # [C, D]; column i < B is example i's positive
    cand_rows: torch.Tensor,  # [C] global target rows of the candidates
    labels: torch.Tensor,  # [B] global target rows of the positives
    weight: torch.Tensor,  # [B]
    scale: float,
    margin: float = 0.0,
    bidirectional: bool = False,
    labels_multi: Optional[torch.Tensor] = None,  # [B, M] -1-padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch / sampled softmax with false-negative masking (any other
    column holding one of the example's targets), optional additive
    margin on the positive and optional target→source averaging over
    the in-batch square."""
    B = src_emb.shape[0]
    cos = src_emb.float() @ cand_emb.float().t()
    if labels_multi is not None and labels_multi.shape[1] > 1:
        same_target = (labels_multi[:, :, None] == cand_rows[None, None, :]).any(dim=1)
    else:
        same_target = labels[:, None] == cand_rows[None, :]  # [B, C]
    own_col = (
        torch.arange(cos.shape[1], device=cos.device)[None, :]
        == torch.arange(B, device=cos.device)[:, None]
    )
    if margin:
        cos = cos - margin * own_col.float()
    logits = scale * cos
    logits = logits.masked_fill(same_target & ~own_col, _MASKED)
    label_col = torch.arange(B, device=cos.device)
    loss, acc = _weighted_ce(logits, label_col, weight)
    if bidirectional:
        # candidate i's positive source is row i; masks and margin carry over
        loss_ts, _ = _weighted_ce(logits[:, :B].t(), label_col, weight)
        loss = 0.5 * (loss + loss_ts)
    return loss, acc


def sample_negative_rows(
    generator: torch.Generator, num_targets: int, num_negatives: int
) -> torch.Tensor:
    """Uniform negative rows with replacement, on the generator's device
    (collisions with positives are masked in the loss)."""
    return torch.randint(
        0, num_targets, (num_negatives,), generator=generator,
        device=generator.device,
    )


@torch.no_grad()
def mine_hard_negative_rows(
    src_emb: torch.Tensor,  # [B, D] (no gradient flows through mining)
    tgt_emb_cache: torch.Tensor,  # [T, D] periodically refreshed target embs
    labels: torch.Tensor,  # [B]
    num_hard: int,
    labels_multi: Optional[torch.Tensor] = None,  # [B, M] -1-padded
) -> torch.Tensor:
    """The ``num_hard`` top-scoring WRONG targets per example against the
    cached target embeddings; every label of a multi-label example is
    excluded. Returns [B·num_hard] rows."""
    sims = src_emb.float() @ tgt_emb_cache.float().t()  # [B, T]
    cols = torch.arange(sims.shape[1], device=sims.device)[None, :]
    if labels_multi is not None and labels_multi.shape[1] > 1:
        own = (cols[:, :, None] == labels_multi[:, None, :]).any(dim=2)
    else:
        own = cols == labels[:, None]
    sims = sims.masked_fill(own, float("-inf"))
    return torch.topk(sims, num_hard, dim=1).indices.reshape(-1)


def similarity_loss(
    cfg: LossConfig,
    src_emb: torch.Tensor,
    labels: torch.Tensor,
    weight: torch.Tensor,
    *,
    tgt_all: Optional[torch.Tensor] = None,  # full mode
    cand_emb: Optional[torch.Tensor] = None,  # inbatch / sampled modes
    cand_rows: Optional[torch.Tensor] = None,
    labels_multi: Optional[torch.Tensor] = None,  # [B, M] label sets
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on cfg.kind → (loss, train_accuracy), inside the profiler
    range ``sse.train.loss``."""
    with record_function("sse.train.loss"):
        if cfg.kind == "full":
            if tgt_all is None:
                raise ValueError("full softmax needs tgt_all")
            return full_softmax_loss(
                src_emb, tgt_all, labels, weight, cfg.scale,
                margin=cfg.margin, labels_multi=labels_multi,
            )
        if cand_emb is None or cand_rows is None:
            raise ValueError(f"{cfg.kind} softmax needs cand_emb and cand_rows")
        return candidate_softmax_loss(
            src_emb, cand_emb, cand_rows, labels, weight, cfg.scale,
            margin=cfg.margin, bidirectional=cfg.bidirectional,
            labels_multi=labels_multi,
        )


__all__ = [
    "LossConfig",
    "candidate_softmax_loss",
    "full_softmax_loss",
    "mine_hard_negative_rows",
    "sample_negative_rows",
    "similarity_loss",
]
