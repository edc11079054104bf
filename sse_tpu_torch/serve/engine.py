"""The query path: tokenize (host) → encode (GRU kernel) → exact top-k
(top-k kernels) → rows mapped to ids (port of ``sse_tpu/serve/engine.py``),
on one GPU or over a ('data', 'model') grid of devices.

On one card the query function is one program per shape, as the JAX
engine's ``jax.jit`` is: each (tokens shape, params) is captured once as a
CUDA graph (``QueryGraph``: the encode, the query quantization, the top-k
kernels, the mid-pass, the merge and the decode) and replayed from then
on. ``num_real`` is a device operand of the top-k kernels, so an ``add``
(rows written in place) needs no new capture; a ``delete`` copies the
index buffer, and its ``warmup`` replaces the graphs of the old buffer
(``GraphCache``); a query still on the old buffer then runs eagerly and
drops nothing. ``QueryEngine.warmup`` captures every (batch tier, length
bucket) before traffic arrives. CPU tensors run the plain versions
eagerly; the grid stays eager (it issues work to several cards from one
thread).

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

import collections
import threading
import time
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
from sse_tpu_torch.train.loop import tree_leaves
from sse_tpu_torch.utils.graphs import Captured, GraphStats

# graphs one query function keeps; an engine needs tiers x buckets (8 with
# a bulk tier and max_seq_length 50)
MAX_GRAPHS = 32


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


class GraphCache:
    """The graphs of one query function, one a key, all over one index
    buffer. ``get`` with another ``emb`` adopts it: every graph of the old
    buffer goes first (``CapturedQuery`` lets only the engine's warmup and
    a function's first call do that); past ``MAX_GRAPHS`` the least
    recently used goes. On a miss ``make()`` captures the graph; if it
    raises, nothing is cached and the caller sees the error. Capture and
    replay run under ``lock``: a graph's buffers are shared."""

    def __init__(self, stats: GraphStats) -> None:
        self.lock = threading.Lock()
        self.stats = stats
        self.graphs: "collections.OrderedDict[tuple, Any]" = collections.OrderedDict()
        self.emb = None  # the buffer every cached graph reads

    def get(self, emb, key: tuple, make: Callable[[], Any]):
        if emb is not self.emb:
            self.graphs.clear()
            self.emb = emb
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph
        graph = make()
        self.graphs[key] = graph
        self.stats.captured({"shape": key[0], "seconds": graph.seconds, "mib": graph.mib})
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return graph


class QueryGraph:
    """One query shape captured as a CUDA graph over fixed buffers
    (``utils.graphs.Captured``: a warm-up on the side stream ``side``,
    whose result ``take_first()`` hands to the capturing call, then the
    thread-local capture into ``pool``, so ``/api/reload`` can warm a new
    engine while the old one serves). Before each replay the caller's
    tokens, lengths and num_real are copied into the buffers the graph
    reads (num_real: a 0-d int32 tensor, filled from an int with no host
    copy); the graph's last op packs (vals, rows) into one int32 [2, B, k]
    buffer, and each call returns a clone of it, so a result outlives the
    next replay. ``seconds`` and ``mib``: the capture's readings."""

    def __init__(self, run: Callable, params, emb: torch.Tensor, tokens: torch.Tensor,
                 lengths: torch.Tensor, nr, pool, side: torch.cuda.Stream) -> None:
        dev = emb.device
        self.refs = (params, emb)  # the graph reads their memory
        self.tokens = torch.empty_like(tokens, device=dev)
        self.lengths = torch.empty_like(lengths, device=dev)
        self.nr = torch.zeros((), dtype=torch.int32, device=dev)
        self.rows = emb.shape[0]
        self.load(tokens, lengths, nr)
        self.captured = Captured(
            lambda: run(params, emb, self.tokens, self.lengths, self.nr), dev, pool, side,
            pack=lambda out: torch.stack([out[0].view(torch.int32), out[1]]))
        self.seconds, self.mib = self.captured.seconds, self.captured.mib

    def load(self, tokens: torch.Tensor, lengths: torch.Tensor, nr) -> None:
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        if torch.is_tensor(nr):
            self.nr.copy_(nr)
        else:
            self.nr.fill_(max(0, min(int(nr), self.rows)))

    def take_first(self):
        """The warm-up's (vals, rows), once: the capturing call's result."""
        return self.captured.take_first()

    def __call__(self, tokens: torch.Tensor, lengths: torch.Tensor, nr):
        self.load(tokens, lengths, nr)
        out = self.captured.replay().clone()
        return out[0].view(torch.float32), out[1]


class CapturedQuery:
    """``build_fused_query_fn``'s one-card function: ``run`` (the eager
    query path) on CPU tensors; on the card one ``QueryGraph`` a key —
    (tokens shape and type, lengths shape and type, the identity of the
    params' tensors) over the index buffer the graphs belong to — captured
    on the first call, which returns the result of the capture's warm-up,
    and replayed on every later call (``GraphCache``). ``stats`` counts
    captures and replays (an engine shares its own among the functions it
    builds).

    The buffer the graphs belong to changes only on the function's first
    call and through ``replay`` (the engine's ``warmup`` of a new buffer);
    a call with any other buffer (a query that read the index before a
    delete published its copy) runs ``run`` eagerly on the card, and
    captures and drops nothing, as the JAX engine never compiles on a
    delete. The graphs of one function share one memory pool and one
    capture stream (the allocator reuses a block only on the stream it was
    allocated on): their replays are serialized and their outputs cloned
    out, so each capture takes the blocks the ones before it left free."""

    def __init__(self, run: Callable, num_real: Optional[int],
                 stats: Optional[GraphStats] = None) -> None:
        self.run = run
        self.num_real = num_real
        self.stats = GraphStats() if stats is None else stats
        self.cache = GraphCache(self.stats)
        self._pools: Dict[torch.device, Any] = {}
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def __call__(self, params, emb, tokens, lengths, nr=None):
        nr = self.num_real if nr is None else nr
        if not emb.is_cuda:
            return self.run(params, emb, tokens, lengths, nr)
        return self.replay(params, emb, tokens, lengths, nr, adopt=False)

    def replay(self, params, emb, tokens, lengths, nr, adopt: bool = True):
        """The call through the graph of its key: a replay, or on a miss
        the capture, whose warm-up is this call's dispatch. ``emb`` becomes
        the buffer the graphs belong to unless ``adopt`` is false and the
        function already has one: then a call on another buffer runs
        ``run`` eagerly."""
        key = (tuple(tokens.shape), tokens.dtype, tuple(lengths.shape), lengths.dtype,
               tuple(id(x) for x in tree_leaves(params)))
        with self.cache.lock:
            stale = not adopt and self.cache.emb is not None and emb is not self.cache.emb
            if not stale:
                graph = self.cache.get(emb, key, lambda: self._capture(params, emb, tokens,
                                                                       lengths, nr))
                first = graph.take_first()
                if first is not None:
                    return first
                out = graph(tokens, lengths, nr)
        if stale:
            return self.run(params, emb, tokens, lengths, nr)
        self.stats.replayed()
        return out

    def _capture(self, params, emb, tokens, lengths, nr) -> QueryGraph:
        """A new graph in the function's pool on ``emb``'s card. A pool
        whose graphs are all gone (the cache is empty: a new index buffer)
        is released by the allocator, and one a capture failed in may be
        left inconsistent, so both are replaced by a new pool."""
        dev = emb.device
        if not self.cache.graphs or dev not in self._pools:
            self._pools[dev] = torch.cuda.graph_pool_handle()
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        try:
            return QueryGraph(self.run, params, emb, tokens, lengths, nr, self._pools[dev],
                              self._streams[dev])
        except BaseException:
            del self._pools[dev]
            raise


def build_fused_query_fn(
    model_cfg: SSEConfig,
    k: int,
    num_real: Optional[int] = None,
    pallas_variant: str = "packed",
    mesh: Optional[Mesh] = None,
    stats: Optional[GraphStats] = None,
) -> Callable:
    """fused(params, emb, tokens, lengths[, num_real]) → (vals [B, k]
    float32, rows [B, k] int32). ``num_real`` is a runtime argument (an
    int or a 0-d int32 tensor on the index's card), so a growing or
    shrinking index needs no new function. ``pallas_variant``: ``packed``
    (11-bit float keys, exact int8 keys) or ``exact`` (full float32 keys;
    always the streaming kernel).

    On one card the function is a ``CapturedQuery``: each input shape is
    captured once as a CUDA graph and replayed (``stats`` counts both),
    and the results are the caller's (clones, made before the next call
    may replay); ``.run`` is the same path issued eagerly. On CPU tensors
    it runs the plain versions.

    With ``mesh`` (the 2D serving grid, e.g. {data: 2, model: 4}), ``emb``
    is the index's ``RowShards`` and ``params`` a pytree or its
    ``parallel.replicate`` copies: queries are split over 'data' (B must
    divide the axis, as in JAX), each replica scores its slice against
    every row block of its grid row (``_shard_topk``: the two-phase route
    when the replica's batch is at least ``TWOPHASE_MIN_BATCH``), and the
    shards' candidates are merged exactly. The results lie on the grid's
    first device, in batch order; across processes every rank gets all
    of them, on its own first device. The grid runs eagerly."""
    if pallas_variant not in VARIANTS:
        raise ValueError(f"pallas_variant must be one of {VARIANTS}, got {pallas_variant!r}")
    if mesh is not None:
        return _sharded_fn(model_cfg, k, num_real, pallas_variant, mesh)

    def run(params, emb, tokens, lengths, nr):
        with torch.no_grad():
            q = sse.encode_source(params, model_cfg, tokens, lengths)
            if pallas_variant == "packed":
                bt = twophase_block_t(emb.shape[0], k)
                if q.shape[0] >= TWOPHASE_MIN_BATCH and bt is not None and 0 < k <= 128:
                    return fused_score_topk_twophase(q, emb, k, nr, block_t=bt)
            return fused_score_topk(q, emb, k, nr, variant=pallas_variant)

    return CapturedQuery(run, num_real, stats)


class QueryEngine:
    """Live query serving over an index on one GPU or on a grid (an index
    with a ``mesh``: its params are then replicated once on each distinct
    device). Queries are padded to a batch tier (``max_batch``, or
    ``bulk_batch`` for bulk calls) and a length bucket, as in the JAX
    engine; with a mesh, each tier must divide over the 'data' axis. On
    one card every (tier, bucket) is a CUDA graph, captured by
    ``warmup()`` and replayed by ``query``; ``graph_stats`` counts both
    (``graph_counts()``, in the HTTP server's /api/stats)."""

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
        self.graph_stats = GraphStats()
        self.last_warmup: Dict[str, Any] = {}
        self._fused = self._build_fused(self.k)

    def _build_fused(self, k: int) -> Callable:
        return build_fused_query_fn(
            self.model_cfg, k=k, num_real=self.index.num_real,
            pallas_variant=self.pallas_variant, mesh=self.mesh, stats=self.graph_stats,
        )

    @property
    def captures_graphs(self) -> bool:
        """Whether dispatches replay CUDA graphs: one card, not a grid."""
        return self.mesh is None and self.device.type == "cuda"

    def graph_counts(self) -> Dict[str, int]:
        """Graph captures and replays since the engine was built, and the
        graphs the current function holds."""
        fn = self._fused
        cached = len(fn.cache.graphs) if isinstance(fn, CapturedQuery) else 0
        return {**self.graph_stats.counts(), "graphs_cached": cached}

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
        """Run every (batch tier, length bucket) shape once on the
        published index, as the JAX engine compiles each program before
        traffic arrives: on one card this captures the shape's CUDA graph
        (and builds the kernels), elsewhere it builds the kernels and warms
        the allocator. The largest shape goes first: a function's graphs
        share one memory pool, so the smaller ones then take their
        buffers from the blocks the largest one left free; the graphs then
        belong to the published buffer (``CapturedQuery.replay``). ``fused``
        warms a function not yet published (a k rebuild). Returns elapsed
        seconds; ``last_warmup`` keeps the seconds, the captures it made
        and their readings."""
        fn = self._fused if fused is None else fused
        before = self.graph_stats.counts()["graph_captures"]
        t0 = time.perf_counter()
        emb, nr = self.index.pub[:2]
        call = fn.replay if self.captures_graphs else fn
        for b in reversed(self._batch_tiers()):
            for w in reversed(self._bucket_widths()):
                toks = torch.zeros((b, w), dtype=torch.int32, device=self.device)
                lengths = torch.ones((b,), dtype=torch.int32, device=self.device)
                vals, _ = call(self.params, emb, toks, lengths, nr)
                vals.cpu()  # completion barrier
        seconds = time.perf_counter() - t0
        made = self.graph_stats.counts()["graph_captures"] - before
        self.last_warmup = {"seconds": seconds, "captures": made,
                            "graphs": list(self.graph_stats.log)[-made:] if made else []}
        return seconds

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
        """Swap-with-last removal (see ShardedIndex.delete). The index
        buffer is copied, so on one card the graphs of the new snapshot are
        captured before this returns. Returns the new num_real."""
        n = self.index.delete(list(ids))
        if self.captures_graphs:
            self.warmup()
        return n

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
