"""Exact top-k over row shards (port of ``sse_tpu/parallel/topk.py``).

1. Each shard selects its local top-k (``k`` best of its rows, or all of
   them when it has fewer: the rest are empty slots).
2. The local rows are lifted to global rows (+ the shard's first row).
3. The shards' candidates, S·k a query, are gathered on one device (across
   processes: every rank's, ``distributed.all_gather``).
4. One more top-k over them gives the global result.

Every true global top-k row is in its own shard's local top-k, so the
merge is exact. It works on the port's int64 composites,
``key << 32 | (0xFFFFFFFF - row)`` (``ops/topk.py``): one max picks (key
descending, global row ascending), the unsharded contract, and the
composites are distinct, so ``torch.topk`` over them has no tie to break.
(The JAX package merges decoded values with ``lax.top_k``, whose ties go
to the lower gathered position: the same order, as shards are gathered in
row order.) An empty slot stays empty when lifted.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from sse_tpu_torch.ops.topk import _EMPTY, _composite, _topk_desc, decode, to_sortable
from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import Mesh


def lift(comp: torch.Tensor, row0: int) -> torch.Tensor:
    """Shard-local composites → global rows (row + ``row0``); empty slots
    stay empty. The row lives in the low 32 bits as 0xFFFFFFFF - row, so
    lifting subtracts ``row0`` there (no borrow while the row fits)."""
    if row0 == 0:
        return comp
    return torch.where(comp == _EMPTY, comp, comp - row0)


def merge(comps: Sequence[torch.Tensor], k: int, device: torch.device) -> torch.Tensor:
    """The k best of the shards' (lifted) composites [B, k_i], gathered on
    ``device``: [B, k], best first."""
    return _topk_desc(torch.cat([c.to(device) for c in comps], dim=1), k)


def local_topk(scores: torch.Tensor, k: int, row0: int = 0) -> torch.Tensor:
    """A shard's [B, t_local] float32 scores → its k best as composites of
    the full float32 key (-0.0 counted as +0.0), rows lifted by ``row0``;
    a shard of fewer than k rows fills the rest with empty slots."""
    s = scores.to(torch.float32)
    s = torch.where(s == 0, torch.zeros((), dtype=s.dtype, device=s.device), s)
    rows = torch.arange(s.shape[1], device=s.device)
    return lift(_topk_desc(_composite(to_sortable(s), rows), k), row0)


def local_topk_merge_body(
    blocks: Sequence[torch.Tensor], k: int, row0s: Sequence[int], device: torch.device
) -> torch.Tensor:
    """Every shard's local top-k, lifted, and the merge on ``device``: the
    global top-k composites [B, k] of the score matrix whose column blocks
    are ``blocks`` (starting at columns ``row0s``)."""
    return merge([local_topk(b, k, r0) for b, r0 in zip(blocks, row0s)], k, device)


def distributed_topk(
    scores: torch.Tensor, k: int, mesh: Mesh
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (float32 values, int32 rows) of a [B, T] score matrix
    split by columns over ``mesh``'s 'model' axis: column block s is scored on
    the device of the grid's first entry of that column, and the full row
    never lies on one device. Across processes each rank passes the same
    ``scores`` and scores only its own blocks; every rank gets the result.
    With fewer than k columns the empty slots are (-3e38, row 0), where
    JAX returns (-inf, a clamped row)."""
    shards = mesh.shape["model"]
    if scores.shape[1] % shards:
        raise ValueError(f"{scores.shape[1]} columns do not split into {shards} blocks")
    t = scores.shape[1] // shards
    own = [s for s in range(shards) if mesh.owner(s) == mesh.rank]
    blocks = [scores[:, s * t : (s + 1) * t].to(mesh.devices[0, s]) for s in own]
    if not mesh.multi_process:
        comp = local_topk_merge_body(blocks, k, [s * t for s in own], mesh.devices[0, 0])
        return decode(comp, False, exact=True)
    # across processes: each rank fills the cells of its shards, the rest
    # stay empty, and the element-wise max over ranks assembles [B, S·k]
    cells = torch.full((scores.shape[0], shards * k), _EMPTY, dtype=torch.int64)
    for s, b in zip(own, blocks):
        cells[:, s * k : (s + 1) * k] = local_topk(b, k, s * t).cpu()
    comp = _topk_desc(distributed.all_gather(cells).amax(dim=0), k)
    return decode(comp.to(mesh.local_devices[0]), False, exact=True)


__all__: List[str] = ["distributed_topk", "lift", "local_topk", "local_topk_merge_body", "merge"]
