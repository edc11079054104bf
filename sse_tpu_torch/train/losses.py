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

On a grid (``train.grid``) the full softmax over a 'model'-sharded table
is computed block by block (``block_softmax``): each (data replica,
table block) entry scores its replica's rows against its block in column
chunks and returns per-row partials (log-sum-exp, the label's logit, the
first maximal column); ``combine_blocks`` joins a row's partials over the
blocks. No device holds a [B, T] logits matrix, and the backward
recomputes each chunk instead of keeping it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from sse_tpu_torch.utils.profiling import span

_MASKED = torch.finfo(torch.float32).min
# logits a column chunk of block_softmax holds (128 MiB of float32)
BLOCK_LOGITS = 1 << 25


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


def _block_logits(src, tbl, labels, extra, col0: int, scale: float, margin: float):
    """Logits of ``src`` [b, D] against table rows ``tbl`` [c, D] whose first
    global column is ``col0``: full_softmax_loss's margin and false-negative
    mask on global column ids."""
    cos = src @ tbl.t()
    cols = torch.arange(col0, col0 + tbl.shape[0], device=cos.device)[None, :]
    if margin:
        cos = cos - margin * (cols == labels[:, None]).float()
    logits = scale * cos
    if extra is not None:
        logits = logits.masked_fill((cols[:, :, None] == extra[:, None, :]).any(dim=2), _MASKED)
    return logits


def _chunks(rows: int, b: int):
    """Column ranges of about BLOCK_LOGITS logits for ``b`` rows."""
    step = max(1, BLOCK_LOGITS // max(b, 1))
    return [(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


class _BlockSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, tbl, labels, extra, col0, scale, margin):
        lses, lls, bests, args = [], torch.zeros_like(src[:, 0]), [], []
        for lo, hi in _chunks(tbl.shape[0], src.shape[0]):
            logits = _block_logits(src, tbl[lo:hi], labels, extra, col0 + lo, scale, margin)
            lses.append(torch.logsumexp(logits, dim=1))
            local = labels - (col0 + lo)
            here = (local >= 0) & (local < hi - lo)
            got = torch.gather(logits, 1, local.clamp(0, hi - lo - 1)[:, None])[:, 0]
            lls = torch.where(here, got, lls)
            best, arg = logits.max(dim=1)  # the first maximal column of the chunk
            bests.append(best)
            args.append(arg + (col0 + lo))
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        best, arg = _first_max(bests, args)
        ctx.save_for_backward(src, tbl, labels, extra, lse)
        ctx.col0, ctx.scale, ctx.margin = col0, scale, margin
        ctx.mark_non_differentiable(best, arg)
        return lse, lls, best, arg

    @staticmethod
    @once_differentiable
    def backward(ctx, g_lse, g_ll, _g_best, _g_arg):
        src, tbl, labels, extra, lse = ctx.saved_tensors
        d_src = torch.zeros_like(src)
        d_tbl = torch.empty_like(tbl)
        for lo, hi in _chunks(tbl.shape[0], src.shape[0]):
            logits = _block_logits(src, tbl[lo:hi], labels, extra, ctx.col0 + lo, ctx.scale,
                                   ctx.margin)
            d = torch.exp(logits - lse[:, None]) * g_lse[:, None]
            local = labels - (ctx.col0 + lo)
            here = (local >= 0) & (local < hi - lo)
            if extra is not None:  # a masked label column takes no gradient
                here &= ~(extra == labels[:, None]).any(dim=1)
            _add_at_label(d, local, here, g_ll)
            d = d * ctx.scale
            d_src += d @ tbl[lo:hi]
            d_tbl[lo:hi] = d.t() @ src
        return d_src, d_tbl, None, None, None, None, None


def _add_at_label(d: torch.Tensor, local: torch.Tensor, here: torch.Tensor,
                  g_ll: torch.Tensor) -> torch.Tensor:
    """``d[r, local[r]] += g_ll[r]`` for the rows r where ``here``, in place,
    with fixed shapes (no host sync): each row's label column is gathered
    and written back, as it was where not ``here``, bit for bit (a masked
    add of 0.0 would turn a -0.0 into +0.0)."""
    col = local.clamp(0, d.shape[1] - 1)[:, None]
    cur = torch.gather(d, 1, col)
    return d.scatter_(1, col, torch.where(here[:, None], cur + g_ll[:, None], cur))


def _first_max(bests, args):
    """The greatest of per-part maxima and its column, ties to the first
    part (``jnp.argmax``'s first maximal column over the parts in order)."""
    best, arg = bests[0], args[0]
    for b, a in zip(bests[1:], args[1:]):
        take = b > best
        best, arg = torch.where(take, b, best), torch.where(take, a, arg)
    return best, arg


def block_softmax(
    src_emb: torch.Tensor,  # [b, D] normalized, one data replica's rows
    tbl: torch.Tensor,  # [t, D] normalized rows [col0, col0 + t) of the table
    labels: torch.Tensor,  # [b] global rows of the positives
    col0: int,
    scale: float,
    margin: float = 0.0,
    labels_multi: Optional[torch.Tensor] = None,  # [b, M] -1-padded
):
    """One table block's share of ``full_softmax_loss`` for a replica's
    rows: (log-sum-exp of the block's logits, the label's logit where the
    label lies in the block and 0 elsewhere, the block's greatest logit
    and its first global column), each [b]. Differentiable in ``src_emb``
    and ``tbl`` through the first two."""
    extra = None
    if labels_multi is not None and labels_multi.shape[1] > 1:
        extra = labels_multi[:, 1:].contiguous()
    return _BlockSoftmax.apply(src_emb.float(), tbl.float(), labels.long(), extra, col0,
                               float(scale), float(margin))


def combine_blocks(parts):
    """A row's partials from ``block_softmax`` over every block (in block
    order, on one device) → (log-softmax of the label's column [b], the
    first maximal global column [b]): the log-sum-exp combined over the
    blocks, the label logit from the one block that holds it."""
    lse = torch.logsumexp(torch.stack([p[0] for p in parts]), dim=0)
    ll = parts[0][1]
    for p in parts[1:]:
        ll = ll + p[1]
    _, arg = _first_max([p[2] for p in parts], [p[3] for p in parts])
    return ll - lse, arg


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
    with span("train.loss"):
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
    "block_softmax",
    "combine_blocks",
    "candidate_softmax_loss",
    "full_softmax_loss",
    "mine_hard_negative_rows",
    "sample_negative_rows",
    "similarity_loss",
]
