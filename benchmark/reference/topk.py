"""Exact scores and top-k in float32: every query against every index row,
in blocks of rows so that no [B, T] matrix is held."""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.model import Precision


@torch.no_grad()
def exact_topk(q: torch.Tensor, index: torch.Tensor, num_real: int, k: int, prec: Precision,
               block: int = 1 << 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, k] float32, rows [B, k] int64) of the k best rows of
    ``index[:num_real]`` for each query, best first."""
    best_v = torch.full((q.shape[0], k), -float("inf"), device=q.device)
    best_r = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
    qr = prec.round(q.float())
    for lo in range(0, num_real, block):
        hi = min(lo + block, num_real)
        s = qr @ prec.round(index[lo:hi].float()).t()
        v, r = torch.topk(s, min(k, hi - lo), dim=1)
        v, r = torch.cat([best_v, v], 1), torch.cat([best_r, r + lo], 1)
        best_v, pos = torch.topk(v, k, dim=1)
        best_r = torch.gather(r, 1, pos)
    return best_v, best_r


@torch.no_grad()
def row_scores(q: torch.Tensor, index: torch.Tensor, rows: torch.Tensor, prec: Precision
               ) -> torch.Tensor:
    """q[i] · index[rows[i, j]] in float32, [B, k]."""
    picked = prec.round(index[rows.long()].float())  # [B, k, D]
    return (picked * prec.round(q.float())[:, None, :]).sum(-1)
