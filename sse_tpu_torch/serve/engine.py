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
eagerly.

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
exchange of the [B, S·k] composites (``_across_ranks``).

On a grid of cards the query is one program a distinct card and shape,
as JAX's ``jax.jit(shard_map(...))`` is one program on every device
(``GridQuery``): each card's body (the encode of every replica slice it
holds, then the top-k of every grid entry on it, ``num_real - row0``
computed on the device, and the merge of every replica whose blocks all
lie on it) is captured once as a CUDA graph (``CardQuery``, through
``utils.graphs.PerCard``) and replayed. A call copies the token slices
into every card's buffers, replays every card's graph, and only then
copies the composites of the replicas that span cards to their merging
cards and merges them there eagerly; no graph holds a copy between
cards, and nothing waits on the host between the first replay and the
merge. Across processes over NCCL (``distributed.captures()``: a card a
rank) the exchange of the composites and the merge run inside the
rank's graph, after its shards, so a replay returns the merged [B, k]
rows on every rank; over gloo, whose collectives run on the host, they
stay eager after the replay.
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
from sse_tpu_torch.utils.graphs import Captured, GraphStats, PerCard, agree
from sse_tpu_torch.utils.profiling import span

# graphs one query function keeps; an engine needs tiers x buckets (8 with
# a bulk tier and max_seq_length 50)
MAX_GRAPHS = 32


def _shard_topk(q: torch.Tensor, block: torch.Tensor, k: int, num_real, row0: int,
                variant: str) -> torch.Tensor:
    """One row block's top-k as composites with GLOBAL rows: the block
    holds rows [row0, row0 + t_local), of which the first
    clip(num_real - row0, 0, t_local) are real. ``num_real``: an int (the
    local count is clipped on the host) or a 0-d int32 tensor on the
    block's device (``num_real - row0`` is computed there; the kernels
    clamp it to [0, t_local], the plain versions clip it). The route is
    gated as in the unsharded function, on this call's batch and this
    block's rows."""
    t_local = block.shape[0]
    if torch.is_tensor(num_real):
        nr_local = num_real - row0 if row0 else num_real
    else:
        nr_local = min(max(num_real - row0, 0), t_local)
    if variant == "packed":
        bt = twophase_block_t(t_local, k)
        if q.shape[0] >= TWOPHASE_MIN_BATCH and bt is not None and 0 < k <= 128:
            return lift(fused_score_topk_twophase(q, block, k, nr_local, block_t=bt,
                                                  composites=True), row0)
    return lift(fused_score_topk(q, block, k, nr_local, variant=variant, composites=True), row0)


def _pack(vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(float32 values, int32 rows) [B, k] → one int32 [2, B, k] tensor."""
    return torch.stack([vals.view(torch.int32), rows])


def _card_body(model_cfg: SSEConfig, k: int, variant: str, entries, t_local: int,
               merged: Sequence[int], rest, int_exact: bool) -> Callable:
    """One card's share of a grid query: each data replica with an entry
    on the card encodes its slice once, then each entry (d, s) of
    ``entries`` scores row block s (composites with global rows), and
    each replica of ``merged`` (whose every block lies on this card) is
    merged and decoded here too. ``body(params, blocks, tokens, lengths,
    nr)`` (this card's params copy, its blocks s → tensor, the replicas'
    slices d → tensor, all on the card) → (the merged replicas' (values,
    rows) packed, int32 [len(merged), 2, B / data, k]; the int64
    composites [len(rest), B / data, k] of the entries ``rest`` of the
    other replicas), either of size 0 where empty."""
    replicas = list(dict.fromkeys(d for d, _ in entries))

    def body(params, blocks, tokens, lengths, nr):
        dev = next(iter(blocks.values())).device
        with torch.no_grad():
            q = {d: sse.encode_source(params, model_cfg, tokens[d], lengths[d]) for d in replicas}
            comps = {(d, s): _shard_topk(q[d], blocks[s], k, nr, s * t_local, variant)
                     for d, s in entries}
            done = [_pack(*decode(merge([c for e, c in comps.items() if e[0] == d], k, dev),
                                  int_exact, variant == "exact")) for d in merged]
            return (torch.stack(done) if done else torch.empty(0, device=dev),
                    torch.stack([comps[e] for e in rest]) if rest else torch.empty(0, device=dev))

    return body


def _across_ranks(mesh: Mesh, k: int, b: int, got, dev: torch.device, int_exact: bool,
                  exact: bool):
    """(vals, rows) [b, k] of the whole batch, the same on every rank: each
    rank fills the cells of its own entries (``got``: (d, s) → composites
    [b / data, k]), the rest stay empty, and the element-wise max over the
    ranks (one ``distributed.all_gather``) assembles every replica's
    [b / data, S·k] candidates, merged on ``dev``."""
    data, shards = mesh.shape["data"], mesh.shape["model"]
    bl = b // data
    cells = torch.full((b, shards * k), _EMPTY, dtype=torch.int64, device=dev)
    for (d, s), c in got:
        cells[d * bl : (d + 1) * bl, s * k : (s + 1) * k] = c.to(dev)
    comp = _topk_desc(distributed.all_gather(cells).amax(dim=0), k)
    return decode(comp, int_exact, exact)


class GraphCache:
    """The graphs of one query function, one a key, all over one index
    buffer. ``get`` with another ``emb`` adopts it: every graph of the old
    buffer goes first (``CapturedQuery`` lets only the engine's warmup and
    a function's first call do that); past ``MAX_GRAPHS`` the least
    recently used goes. On a miss ``make()`` captures the graph; if it
    raises, nothing is cached and the caller sees the error. Capture and
    replay run under ``lock``: a graph's buffers are shared."""

    def __init__(self, stats: GraphStats, cards: int = 1) -> None:
        self.lock = threading.Lock()
        self.stats = stats
        self.cards = cards  # a grid keeps MAX_GRAPHS a distinct card
        self.graphs: "collections.OrderedDict[tuple, Any]" = collections.OrderedDict()
        self.emb = None  # the buffer every cached graph reads

    def get(self, emb, key: tuple, make: Callable[[], Any], label: Optional[dict] = None):
        if emb is not self.emb:
            self.graphs.clear()
            self.emb = emb
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph
        graph = make()
        self.graphs[key] = graph
        self.stats.captured({"shape": key[0], **(label or {}), "seconds": graph.seconds,
                             "mib": graph.mib})
        while len(self.graphs) > MAX_GRAPHS * self.cards:
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
            pack=lambda out: _pack(*out))
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
        with span("engine.load"):
            self.load(tokens, lengths, nr)
        with span("engine.replay"):
            out = self.captured.replay()
        with span("engine.out"):
            out = out.clone()
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
        with span("engine.call"):
            nr = self.num_real if nr is None else nr
            if not emb.is_cuda:
                return self.run(params, emb, tokens, lengths, nr)
            return self.replay(params, emb, tokens, lengths, nr, adopt=False)

    def replay(self, params, emb, tokens, lengths, nr, adopt: bool = True):
        """The call through the graph of its key: a replay, or on a miss
        the capture, whose warm-up is this call's dispatch. ``emb`` becomes
        the buffer the graphs belong to unless ``adopt`` is false and the
        function already has one: then a call on another buffer runs
        ``run`` eagerly (``stats`` counts it)."""
        lock = self.cache.lock
        with span("engine.key"):
            key = (tuple(tokens.shape), tokens.dtype, tuple(lengths.shape), lengths.dtype,
                   tuple(id(x) for x in tree_leaves(params)))
            lock.acquire()
            try:
                stale = not adopt and self.cache.emb is not None and emb is not self.cache.emb
                graph = None if stale else self.cache.get(
                    emb, key, lambda: self._capture(params, emb, tokens, lengths, nr))
            except BaseException:
                lock.release()
                raise
        try:
            if graph is not None:
                first = graph.take_first()
                if first is not None:
                    return first
                out = graph(tokens, lengths, nr)
        finally:
            lock.release()
        if graph is None:
            self.stats.ran_eagerly()
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


class CardQuery:
    """One card's share of a grid query shape, captured as a CUDA graph
    on that card (``utils.graphs.PerCard.capture``): the card's body
    (``_card_body``) over fixed buffers on the card, one tokens and one
    lengths buffer a data replica it serves and one 0-d int32 num_real
    (filled from an int with no host copy; the body computes each block's
    local count from it on the device). Its outputs (``_card_body``: the
    replicas merged on the card, and the other entries' composites) are
    overwritten by the next replay. ``seconds`` and ``mib``: the
    capture's readings."""

    def __init__(self, body: Callable, dev: torch.device, params, blocks: Dict[int, torch.Tensor],
                 tokens: Dict[int, torch.Tensor], lengths: Dict[int, torch.Tensor], nr,
                 rows: int, per_card: PerCard) -> None:
        self.refs = (params, blocks)  # the graph reads their memory
        self.tokens = {d: torch.empty_like(t, device=dev) for d, t in tokens.items()}
        self.lengths = {d: torch.empty_like(t, device=dev) for d, t in lengths.items()}
        self.nr = torch.zeros((), dtype=torch.int32, device=dev)
        self.rows = rows
        self.load(tokens, lengths, nr)
        self.captured = per_card.capture(
            dev, lambda: body(params, blocks, self.tokens, self.lengths, self.nr))
        self.seconds, self.mib = self.captured.seconds, self.captured.mib

    def load(self, tokens: Dict[int, torch.Tensor], lengths: Dict[int, torch.Tensor], nr) -> None:
        """Copy a call's slices (from any device) and num_real in."""
        for d, t in tokens.items():
            self.tokens[d].copy_(t)
            self.lengths[d].copy_(lengths[d])
        if torch.is_tensor(nr):
            self.nr.copy_(nr)
        else:
            self.nr.fill_(max(0, min(int(nr), self.rows)))


class GridQuery:
    """``build_fused_query_fn``'s function on a grid: one program a
    distinct card, as JAX's sharded query is one program on every device.
    ``run`` issues each card's body (``_card_body``) eagerly and merges
    (CPU tensors, and a stale index); on the card, ``replay`` keeps one
    ``CardQuery`` a card and key — (tokens shape and type, lengths shape
    and type, the card, the identity of the card's params copy's tensors,
    the identity of the card's row blocks) — captured on its first call,
    whose result is the capture's warm-up, and replayed after.

    A call copies every card's slices into its buffers, replays every
    card's graph (``PerCard.replay``), and only then copies the
    composites of a replica that spans cards to its first card, merges
    them there and gathers the replicas' rows on the grid's first
    device: every card is launched before the merge, no graph copies
    between cards, and nothing syncs the host. A replica whose blocks
    all lie on one card (every replica of a grid on one card) is merged
    and decoded inside that card's graph.

    The graphs belong to one ``RowShards``, as a ``CapturedQuery``'s to
    one buffer: ``replay(..., adopt=True)`` (the engine's warmup, a
    function's first call) adopts a new one and drops every graph of the
    old; a call on any other ``RowShards`` runs eagerly and drops
    nothing. ``stats`` counts a capture and a replay a card.

    Across processes each rank captures and replays its own cards'
    bodies, and the ranks call the function in lockstep (its exchange is a
    collective), so every rank captures on the same calls. The backend
    decides where the exchange runs: over NCCL, one card a rank
    (``distributed.captures()``), the card's body ends with the exchange
    of the composites and the merge (``_across_ranks``), so the rank's
    graph holds the collective and a replay returns the merged rows on
    every rank; the ranks agree on each capture (``utils.graphs.agree``)
    before any replays it. Over gloo, whose collectives run on the host,
    the exchange and the merge stay eager after the replays.

    ``params``: the ``parallel.replicate`` copies (the engine and the
    bench pass them); a plain pytree is copied to each other card on every
    call, and each such copy is a new key there."""

    def __init__(self, model_cfg: SSEConfig, k: int, num_real: Optional[int], variant: str,
                 mesh: Mesh, stats: Optional[GraphStats] = None) -> None:
        self.model_cfg, self.k, self.num_real, self.variant = model_cfg, k, num_real, variant
        self.mesh = mesh
        self.cards = mesh.entries_by_device()
        shards = mesh.shape["model"]
        # the replicas a card merges itself (all their blocks on it; one
        # process), and the entries whose composites leave the card
        self.merged = {dev: [] if mesh.multi_process else
                       [d for d in dict.fromkeys(d for d, _ in entries)
                        if sum(e[0] == d for e in entries) == shards]
                       for dev, entries in self.cards.items()}
        self.rest = {dev: [e for e in entries if e[0] not in self.merged[dev]]
                     for dev, entries in self.cards.items()}
        # across processes over NCCL: the exchange and merge inside the rank's graph
        self.exchange = (mesh.multi_process and distributed.captures()
                         and len(self.cards) == 1)
        self.stats = GraphStats() if stats is None else stats
        self.cache = GraphCache(self.stats, cards=len(self.cards))
        self.per_card = PerCard()

    def __call__(self, params, emb: RowShards, tokens, lengths, nr=None):
        nr = self.num_real if nr is None else nr
        if emb.device.type != "cuda":
            return self.run(params, emb, tokens, lengths, nr)
        return self.replay(params, emb, tokens, lengths, nr, adopt=False)

    def _slices(self, tokens, lengths):
        """The replicas' slices of the batch (views on the caller's
        device): d → tokens, d → lengths."""
        data = self.mesh.shape["data"]
        b = tokens.shape[0]
        if b % data:
            raise ValueError(f"the batch ({b}) must divide over the 'data' axis ({data})")
        bl = b // data
        return ({d: tokens[d * bl : (d + 1) * bl] for d in range(data)},
                {d: lengths[d * bl : (d + 1) * bl] for d in range(data)})

    def _body(self, emb: RowShards, dev: torch.device) -> Callable:
        int_exact = emb.dtype == torch.int8
        body = _card_body(self.model_cfg, self.k, self.variant, self.cards[dev],
                          emb.rows_per_shard, self.merged[dev], self.rest[dev], int_exact)
        if not self.exchange:
            return body
        mesh, k, entries, exact = self.mesh, self.k, self.rest[dev], self.variant == "exact"

        def exchanged(params, blocks, tokens, lengths, nr):
            """The card's shards, then the exchange and the merge: the whole
            batch's (values, rows), packed [2, B, k]."""
            _, rest = body(params, blocks, tokens, lengths, nr)
            b = next(iter(tokens.values())).shape[0] * mesh.shape["data"]
            with torch.no_grad():
                return _pack(*_across_ranks(mesh, k, b, zip(entries, rest), dev, int_exact,
                                            exact))

        return exchanged

    def run(self, params, emb: RowShards, tokens, lengths, nr):
        """The grid call issued eagerly, card by card."""
        copies = replicate(params, self.mesh)
        toks, lens = self._slices(tokens, lengths)
        outs = {}
        for dev, entries in self.cards.items():
            mine = {d for d, _ in entries}
            outs[dev] = self._body(emb, dev)(
                copies[dev], {s: emb.block(s, dev) for _, s in entries},
                {d: toks[d].to(dev) for d in mine}, {d: lens[d].to(dev) for d in mine},
                nr.to(dev) if torch.is_tensor(nr) else nr)
        return self._merge(outs, emb, tokens.shape[0])

    def replay(self, params, emb: RowShards, tokens, lengths, nr, adopt: bool = True):
        """The call through each card's graph of its key: a replay, or on
        a miss the capture, whose warm-up is this call's share on that
        card. ``emb`` becomes the index the graphs belong to unless
        ``adopt`` is false and the function already has one: then a call
        on another index runs ``run`` eagerly."""
        copies = replicate(params, self.mesh)
        toks, lens = self._slices(tokens, lengths)
        with self.cache.lock:
            stale = not adopt and self.cache.emb is not None and emb is not self.cache.emb
            if not stale:
                firsts, graphs = {}, {}
                for dev, entries in self.cards.items():
                    blocks = {s: emb.block(s, dev) for _, s in entries}
                    mine = {d for d, _ in entries}
                    card_toks, card_lens = {d: toks[d] for d in mine}, {d: lens[d] for d in mine}
                    key = (tuple(tokens.shape), dev, tokens.dtype, tuple(lengths.shape),
                           lengths.dtype, tuple(id(x) for x in tree_leaves(copies[dev])),
                           tuple(id(b) for b in blocks.values()))
                    graph = self.cache.get(
                        emb, key,
                        lambda: self._capture(dev, copies[dev], emb, blocks, card_toks,
                                              card_lens, nr),
                        {"card": str(dev)})
                    first = graph.captured.take_first()
                    if first is not None:
                        firsts[dev] = first
                    else:
                        graph.load(card_toks, card_lens, nr)
                        graphs[dev] = graph.captured
                outs = {**PerCard.replay(graphs), **firsts}
                for _ in graphs:
                    self.stats.replayed()
                # merged while the lock holds the graphs' outputs
                out = self._merge(outs, emb, tokens.shape[0])
        if stale:
            self.stats.ran_eagerly()
            return self.run(params, emb, tokens, lengths, nr)
        return out

    def _capture(self, dev, params, emb: RowShards, blocks, tokens, lengths, nr) -> CardQuery:
        """A new graph of ``dev``'s body in the card's pool: a card with
        no graph left in the cache (a new index, or all evicted) takes a
        new pool, as does one a capture failed in (``GraphPool``). With
        the exchange inside, every rank captures the same call and the
        ranks agree on it: a capture that failed on any rank raises on
        every rank, each of which drops the card's pool."""
        if not any(key[1] == dev for key in self.cache.graphs):
            self.per_card.drop(dev)
        make = lambda: CardQuery(self._body(emb, dev), dev, params, blocks, tokens,  # noqa: E731
                                 lengths, nr, emb.shape[0], self.per_card)
        if not self.exchange:
            return make()
        made, error = None, None
        try:
            distributed.check_capturable()
            made = make()
        except BaseException as e:  # noqa: BLE001 (raised below, on every rank)
            error = e
        try:
            agree(error, {} if made is None else {
                "shape": list(tokens[next(iter(tokens))].shape),
                "collectives": dict(made.captured.launches.collectives)},
                "a grid query's capture across processes")
        except BaseException:
            self.per_card.drop(dev)
            raise
        return made

    def _merge(self, outs: Dict[torch.device, tuple], emb: RowShards, b: int):
        """The cards' outputs → (vals, rows) of the whole batch on the
        grid's first device (a new tensor: it outlives the next replay).
        A replica no card merged has its shards' composites merged on its
        first card; across processes every rank assembles every replica's
        candidates after the exchange, and merges them (inside the rank's
        body where the exchange is captured)."""
        if self.exchange:  # merged inside the card's body, [2, B, k] on every rank
            (out,) = outs.values()
            out = out.clone()
            return out[0].view(torch.float32), out[1]
        mesh, k = self.mesh, self.k
        data = mesh.shape["data"]
        packed: Dict[int, torch.Tensor] = {}
        groups: Dict[int, list] = {d: [] for d in range(data)}
        for dev, (done, rest) in outs.items():
            for i, d in enumerate(self.merged[dev]):
                packed[d] = done[i]
            for (d, s), c in zip(self.rest[dev], rest):
                groups[d].append((s, c))
        int_exact, exact = emb.dtype == torch.int8, self.variant == "exact"
        if mesh.multi_process:  # each rank's candidates, exchanged after the replays
            got = [((d, s), c) for d, cs in groups.items() for s, c in cs]
            return _across_ranks(mesh, k, b, got, emb.device, int_exact, exact)
        for d, got in groups.items():
            if got:
                comp = merge([c for _, c in sorted(got, key=lambda x: x[0])], k,
                             mesh.devices[d, 0])
                packed[d] = _pack(*decode(comp, int_exact, exact))
        out = torch.cat([packed[d].to(mesh.devices[0, 0]) for d in range(data)], dim=1)
        return out[0].view(torch.float32), out[1]


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
    is the index's ``RowShards`` and ``params`` its ``parallel.replicate``
    copies (or a pytree): queries are split over 'data' (B must divide
    the axis, as in JAX), each replica scores its slice against every row
    block of its grid row (``_shard_topk``: the two-phase route when the
    replica's batch is at least ``TWOPHASE_MIN_BATCH``), and the shards'
    candidates are merged exactly. The results lie on the grid's first
    device, in batch order; across processes every rank gets all of
    them, on its own first device. The function is a ``GridQuery``: on
    cards, one CUDA graph a distinct card and shape, every card's graph
    replayed before the merge (across processes over NCCL, the exchange
    and the merge inside each rank's graph); ``.run`` is the same path
    eager."""
    if pallas_variant not in VARIANTS:
        raise ValueError(f"pallas_variant must be one of {VARIANTS}, got {pallas_variant!r}")
    if mesh is not None:
        return GridQuery(model_cfg, k, num_real, pallas_variant, mesh, stats)

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
    cards every (tier, bucket) is a CUDA graph (on a grid, one a distinct
    card), captured by ``warmup()`` and replayed by ``query``;
    ``graph_stats`` counts both (``graph_counts()``, in the HTTP server's
    /api/stats)."""

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
        """Whether dispatches replay CUDA graphs: an index on cards, one
        or a grid of them."""
        return self.device.type == "cuda"

    def graph_counts(self) -> Dict[str, int]:
        """Graph captures and replays since the engine was built, and the
        graphs the current function holds; on a grid each card's graph
        counts (a dispatch replays one a distinct card)."""
        fn = self._fused
        cached = len(fn.cache.graphs) if isinstance(fn, (CapturedQuery, GridQuery)) else 0
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
        traffic arrives: on cards this captures the shape's CUDA graph (on
        a grid, one on every distinct card; and builds the kernels), on
        the CPU it runs the shape once. The largest shape goes first: a function's graphs
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
        buffer (on a grid, each block it touches) is copied, so on cards
        the graphs of the new snapshot are captured before this returns.
        Returns the new num_real."""
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
