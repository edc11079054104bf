"""The query path: tokenize (host) → encode (GRU kernel) → exact top-k
(top-k kernels) → rows mapped to ids (port of ``sse_tpu/serve/engine.py``),
on one GPU or over a ('data', 'model') grid of devices.

Routing carried over from the JAX package and NOT yet measured on the
H100: with the default ``pallas_variant="packed"``, batches of
``TWOPHASE_MIN_BATCH`` (1024) or more go to the two-phase kernels when the
index has room for them, smaller batches to one streaming launch; with
``"exact"`` (full float32 selection keys) every batch streams, as in JAX
(``pick_twophase_block_t`` takes only the packed variant). The JAX
package's TPU tuning (512-row batch chunking, DMA spans, block-size
pickers) is not carried over.

With a mesh (an index built or loaded onto one), each data replica takes
its B / data queries, encodes them on its devices, and scores them
against each row block of its grid row with the same kernels, on the
block's own ``num_real`` and first row (``_shard_topk``); the route is
chosen on the replica's batch, as JAX chooses it inside ``shard_map``.
The shards' composites are merged exactly (``parallel.topk``) on the
replica's first device, or, across processes, on every rank after an
exchange of the [B, S·k] composites.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sse_tpu_torch.text.subword import SubwordVocab
from sse_tpu_torch.index.sharded_index import ShardedIndex
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.ops.topk import (
    _EMPTY,
    TWOPHASE_MIN_BATCH,
    VARIANTS,
    _topk_desc,
    decode,
    fused_score_topk,
    fused_score_topk_twophase,
    twophase_block_t,
)
from sse_tpu_torch.parallel import distributed
from sse_tpu_torch.parallel.mesh import Mesh, RowShards, replicate
from sse_tpu_torch.parallel.topk import lift, merge


def _shard_topk(q: torch.Tensor, block: torch.Tensor, k: int, num_real: int, row0: int,
                variant: str) -> torch.Tensor:
    """One row block's top-k as composites with GLOBAL rows: the block
    holds rows [row0, row0 + t_local), of which the first
    clip(num_real - row0, 0, t_local) are real. The route is gated as in
    the unsharded function, on this call's batch and this block's rows."""
    t_local = block.shape[0]
    nr_local = min(max(num_real - row0, 0), t_local)
    if variant == "packed":
        bt = twophase_block_t(t_local, k)
        if q.shape[0] >= TWOPHASE_MIN_BATCH and bt is not None and 0 < k <= 128:
            return lift(fused_score_topk_twophase(q, block, k, nr_local, block_t=bt,
                                                  composites=True), row0)
    return lift(fused_score_topk(q, block, k, nr_local, variant=variant, composites=True), row0)


def _sharded_fn(model_cfg: SSEConfig, k: int, num_real: Optional[int], variant: str,
                mesh: Mesh) -> Callable:
    """The grid form of ``build_fused_query_fn`` (its docstring)."""
    data, shards = mesh.shape["data"], mesh.shape["model"]

    def fused(params, emb: RowShards, tokens, lengths, nr=None):
        nr = num_real if nr is None else nr
        b = tokens.shape[0]
        if b % data:
            raise ValueError(f"the batch ({b}) must divide over the 'data' axis ({data})")
        bl, t_local = b // data, emb.rows_per_shard
        copies = replicate(params, mesh)
        int_exact = emb.dtype == torch.int8
        groups = []  # per data replica: [(shard, composites)]
        with torch.no_grad():
            for d in range(data):
                q = {}  # this replica's queries, encoded once a device
                got = []
                for s in range(shards):
                    if not mesh.is_local(d, s):
                        continue
                    dev = mesh.devices[d, s]
                    if dev not in q:
                        q[dev] = sse.encode_source(
                            copies[dev], model_cfg, tokens[d * bl : (d + 1) * bl].to(dev),
                            lengths[d * bl : (d + 1) * bl].to(dev))
                    got.append((s, _shard_topk(q[dev], emb.block(s, dev), k, nr, s * t_local,
                                               variant)))
                groups.append(got)
        if not mesh.multi_process:
            out = mesh.devices[0, 0]
            comp = torch.cat([merge([c for _, c in got], k, mesh.devices[d, 0]).to(out)
                              for d, got in enumerate(groups)])
            return decode(comp, int_exact, variant == "exact")
        # across processes: each rank fills the cells of its own entries,
        # the rest stay empty, and the element-wise max over the ranks
        # assembles every replica's [B / data, S·k] candidates on each rank
        cells = torch.full((b, shards * k), _EMPTY, dtype=torch.int64, device=emb.device)
        for d, got in enumerate(groups):
            for s, c in got:
                cells[d * bl : (d + 1) * bl, s * k : (s + 1) * k] = c.to(emb.device)
        comp = _topk_desc(distributed.all_gather(cells).amax(dim=0), k)
        return decode(comp, int_exact, variant == "exact")

    return fused


def build_fused_query_fn(
    model_cfg: SSEConfig,
    k: int,
    num_real: Optional[int] = None,
    pallas_variant: str = "packed",
    mesh: Optional[Mesh] = None,
) -> Callable:
    """fused(params, emb, tokens, lengths[, num_real]) → (vals [B, k]
    float32, rows [B, k] int32). ``num_real`` is a runtime argument, so a
    growing or shrinking index needs no new function. ``pallas_variant``:
    ``packed`` (11-bit float keys, exact int8 keys) or ``exact`` (full
    float32 keys; always the streaming kernel).

    With ``mesh`` (the 2D serving grid, e.g. {data: 2, model: 4}), ``emb``
    is the index's ``RowShards`` and ``params`` a pytree or its
    ``parallel.replicate`` copies: queries are split over 'data' (B must
    divide the axis, as in JAX), each replica scores its slice against
    every row block of its grid row (``_shard_topk``: the two-phase route
    when the replica's batch is at least ``TWOPHASE_MIN_BATCH``), and the
    shards' candidates are merged exactly. The results lie on the grid's
    first device, in batch order; across processes every rank gets all
    of them, on its own first device."""
    if pallas_variant not in VARIANTS:
        raise ValueError(f"pallas_variant must be one of {VARIANTS}, got {pallas_variant!r}")
    if mesh is not None:
        return _sharded_fn(model_cfg, k, num_real, pallas_variant, mesh)

    def fused(params, emb, tokens, lengths, nr=None):
        nr = num_real if nr is None else nr
        with torch.no_grad():
            q = sse.encode_source(params, model_cfg, tokens, lengths)
            if pallas_variant == "packed":
                bt = twophase_block_t(emb.shape[0], k)
                if q.shape[0] >= TWOPHASE_MIN_BATCH and bt is not None and 0 < k <= 128:
                    return fused_score_topk_twophase(q, emb, k, nr, block_t=bt)
            return fused_score_topk(q, emb, k, nr, variant=pallas_variant)

    return fused


class QueryEngine:
    """Live query serving over an index on one GPU or on a grid (an index
    with a ``mesh``: its params are then replicated once on each distinct
    device). Queries are padded to a batch tier (``max_batch``, or
    ``bulk_batch`` for bulk calls) and a length bucket, as in the JAX
    engine; with a mesh, each tier must divide over the 'data' axis."""

    def __init__(
        self,
        params,
        model_cfg: SSEConfig,
        vocab: SubwordVocab,
        index: ShardedIndex,
        max_seq_length: int = 50,
        max_batch: int = 8,
        k: int = 10,
        bulk_batch: Optional[int] = None,
        pallas_variant: str = "packed",
    ):
        self.mesh = index.mesh
        if self.mesh is not None:
            # index rows live across the grid; params ride along replicated
            params = replicate(params, self.mesh)
        self.params = params
        self.model_cfg = model_cfg
        self.vocab = vocab
        self.index = index
        self.device = index.emb.device
        self.max_seq_length = max_seq_length
        self.max_batch = max_batch
        self.bulk_batch = (
            None if (bulk_batch is None or bulk_batch <= max_batch) else bulk_batch
        )
        # what the caller asked for: k rises toward it as the index grows
        self.requested_k = k
        self.k = min(k, index.num_real)
        self.pallas_variant = pallas_variant
        self._fused = self._build_fused(self.k)

    def _build_fused(self, k: int) -> Callable:
        return build_fused_query_fn(
            self.model_cfg, k=k, num_real=self.index.num_real,
            pallas_variant=self.pallas_variant, mesh=self.mesh,
        )

    # --------------------------------------------------------------- host
    # Length buckets: a batch is padded to the smallest bucket that holds
    # its longest query, so short queries skip most recurrent steps.
    _BUCKETS = (8, 16, 32)

    def _bucket_widths(self) -> List[int]:
        """Token widths the engine serves (shared by encode_queries and
        warmup, so every queried width is a warmed width)."""
        return [b for b in self._BUCKETS if b < self.max_seq_length] + [self.max_seq_length]

    def _batch_tiers(self) -> List[int]:
        tiers = [self.max_batch]
        if self.bulk_batch is not None:
            tiers.append(self.bulk_batch)
        return tiers

    @property
    def max_dispatch(self) -> int:
        """Largest batch tier — the most queries one device call takes."""
        return self._batch_tiers()[-1]

    def warmup(self, fused: Optional[Callable] = None) -> float:
        """Run every (batch tier, length bucket) shape once — this builds
        the CUDA kernels and warms the allocator before traffic arrives.
        Returns elapsed seconds."""
        import time as _time

        fn = self._fused if fused is None else fused
        t0 = _time.perf_counter()
        for b in self._batch_tiers():
            for w in self._bucket_widths():
                toks = torch.zeros((b, w), dtype=torch.int32, device=self.device)
                lengths = torch.ones((b,), dtype=torch.int32, device=self.device)
                vals, _ = fn(self.params, self.index.emb, toks, lengths)
                vals.cpu()  # completion barrier
        return _time.perf_counter() - t0

    def encode_queries(self, texts: Sequence[str]):
        """Tokenize and pad a query batch to a batch tier and length
        bucket (host side, the C++ encoder through ``batch_encode``)."""
        from sse_tpu_torch.data.corpus import batch_encode

        b = next((t for t in self._batch_tiers() if t >= len(texts)), self.max_dispatch)
        padded = list(texts[:b]) + [""] * (b - min(len(texts), b))
        tokens, lengths = batch_encode(self.vocab, padded, self.max_seq_length)
        longest = int(lengths.max()) if len(texts) else 1
        width = next(w for w in self._bucket_widths() if w >= longest)
        return (
            torch.from_numpy(np.ascontiguousarray(tokens[:, :width])).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )

    def add_documents(self, ids: Sequence[str], texts: Sequence[str]) -> int:
        """Encode and append new targets (tower modes). Returns the new
        num_real; k rises toward requested_k as the index grows."""
        if self.model_cfg.mode == NetworkMode.SOURCE_ENCODER_ONLY:
            raise ValueError(
                "source-encoder-only targets are learned table rows; "
                "adding documents requires a tower mode"
            )
        from sse_tpu_torch.data.corpus import batch_encode

        tokens, lengths = batch_encode(self.vocab, list(texts), self.max_seq_length)
        params = self.params if self.mesh is None else self.params[self.device]
        with torch.no_grad():
            emb = sse.target_embeddings(
                params, self.model_cfg,
                tokens=torch.from_numpy(tokens).to(self.device),
                lengths=torch.from_numpy(lengths).to(self.device),
            )
        self.index.add(emb, list(ids), list(texts))
        new_k = min(self.requested_k, self.index.num_real)
        if new_k != self.k:
            # warm the wider function before publishing it
            new_fused = self._build_fused(new_k)
            self.warmup(fused=new_fused)
            self.k, self._fused = new_k, new_fused
        return self.index.num_real

    def delete_documents(self, ids: Sequence[str]) -> int:
        """Swap-with-last removal (see ShardedIndex.delete). Returns the
        new num_real."""
        return self.index.delete(list(ids))

    def query(self, texts: Sequence[str]) -> List[List[Dict[str, Any]]]:
        """Query strings → per-query top-k
        [{'targetId', 'targetText', 'score', 'row'}, ...] best first."""
        if len(texts) > self.max_dispatch:
            out: List[List[Dict[str, Any]]] = []
            for lo in range(0, len(texts), self.max_dispatch):
                out.extend(self.query(texts[lo : lo + self.max_dispatch]))
            return out
        tokens, lengths = self.encode_queries(texts)
        # one snapshot of (emb, num_real, ids, texts): never a torn mix
        emb, nr, ids, texts_side = self.index.pub
        vals, rows = self._fused(self.params, emb, tokens, lengths, nr)
        vals = vals.cpu().numpy()
        rows = rows.cpu().numpy()
        results = []
        for i in range(len(texts)):
            hits = []
            # k from the output width: immune to a concurrent k rebuild
            for j in range(min(rows.shape[1], nr)):
                r = int(rows[i, j])
                hits.append(
                    {
                        "targetId": ids[r],
                        "targetText": texts_side[r],
                        "score": float(vals[i, j]),
                        "row": r,
                    }
                )
            results.append(hits)
        return results
