"""The query path: tokenize (host) → encode (GRU kernel) → exact top-k
(top-k kernels) → rows mapped to ids (port of ``sse_tpu/serve/engine.py``,
single GPU).

Routing carried over from the JAX package and NOT yet measured on the
H100: batches of ``TWOPHASE_MIN_BATCH`` (1024) or more go to the
two-phase kernels when the index has room for them, smaller batches to
one streaming launch. The JAX package's TPU tuning (512-row batch
chunking, DMA spans, block-size pickers) is not carried over.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sse_tpu.text.subword import SubwordVocab
from sse_tpu_torch.index.sharded_index import ShardedIndex
from sse_tpu_torch.models import sse
from sse_tpu_torch.models.sse import NetworkMode, SSEConfig
from sse_tpu_torch.ops.topk import (
    TWOPHASE_MIN_BATCH,
    fused_score_topk,
    fused_score_topk_twophase,
    twophase_block_t,
)


def build_fused_query_fn(
    model_cfg: SSEConfig, k: int, num_real: Optional[int] = None
) -> Callable:
    """fused(params, emb, tokens, lengths[, num_real]) → (vals [B, k]
    float32, rows [B, k] int32). ``num_real`` is a runtime argument, so a
    growing or shrinking index needs no new function."""

    def fused(params, emb, tokens, lengths, nr=None):
        nr = num_real if nr is None else nr
        with torch.no_grad():
            q = sse.encode_source(params, model_cfg, tokens, lengths)
            bt = twophase_block_t(emb.shape[0], k)
            if q.shape[0] >= TWOPHASE_MIN_BATCH and bt is not None and 0 < k <= 128:
                return fused_score_topk_twophase(q, emb, k, nr, block_t=bt)
            return fused_score_topk(q, emb, k, nr)

    return fused


class QueryEngine:
    """Live query serving over a single-GPU index. Queries are padded to
    a batch tier (``max_batch``, or ``bulk_batch`` for bulk calls) and a
    length bucket, as in the JAX engine."""

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
    ):
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
        self._fused = build_fused_query_fn(model_cfg, k=self.k, num_real=index.num_real)

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
        bucket (host side; the C++ encoder when available)."""
        from sse_tpu.data.corpus import batch_encode

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
        from sse_tpu.data.corpus import batch_encode

        tokens, lengths = batch_encode(self.vocab, list(texts), self.max_seq_length)
        with torch.no_grad():
            emb = sse.target_embeddings(
                self.params, self.model_cfg,
                tokens=torch.from_numpy(tokens).to(self.device),
                lengths=torch.from_numpy(lengths).to(self.device),
            )
        self.index.add(emb, list(ids), list(texts))
        new_k = min(self.requested_k, self.index.num_real)
        if new_k != self.k:
            # warm the wider function before publishing it
            new_fused = build_fused_query_fn(self.model_cfg, k=new_k, num_real=self.index.num_real)
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
