"""Fixed-shape programs as CUDA graphs, the port's counterpart of a
``jax.jit`` program a shape: captured once on the card, then replayed.

``Captured`` is one capture (PyTorch's whole-network recipe: a warm-up
on a side stream, then the capture into a memory pool), ``GraphPool``
the pool and capture stream that the graphs of one owner share, and
``Program`` a function over fixed input buffers that captures itself on
its first call on a card and replays after, or runs eagerly, and
``PerCard`` the graphs of a grid's program, one body a distinct card,
and ``Recorder`` a program that moves values between cards as per-card
graphs with the copies between them. The served query
(``serve/engine.py`` ``QueryGraph``, and ``CardQuery`` on a grid), the
Evaluator (``evals/recall.py``), the index build
(``index/sharded_index.py``, one ``Program`` a card on a grid), the
index bench (``bench.py``) and the grid's chain of train steps
(``train/loop.py`` ``_GridChain``, through a ``Recorder``) capture
through them. A capture that fails raises: nothing on the card falls
back to eager quietly.

Across processes (``parallel.distributed.captures``: NCCL, a card a
rank) a captured program holds its collectives, and a replay launches
them at once: every rank must replay the same collectives, or the ranks
that went first wait for the others. So the ranks agree on each capture
(``agree``): each tells every other, over the gloo group, whether it
captured and what (graphs, collectives), and if any rank failed or the
readings differ, every rank raises.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from sse_tpu_torch.ops import GraphLaunches
from sse_tpu_torch.utils.profiling import span


class GraphStats:
    """Captures and replays of an owner's graphs, the calls it ran eagerly
    on the card instead (a served query on an index buffer that a delete
    replaced), and the readings of the last captures (shape, seconds, MiB
    reserved). Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.eager = 0
        self.log: collections.deque = collections.deque(maxlen=64)

    def captured(self, reading: dict) -> None:
        with self._lock:
            self.captures += 1
            self.log.append(reading)

    def replayed(self) -> None:
        with self._lock:
            self.replays += 1

    def ran_eagerly(self) -> None:
        with self._lock:
            self.eager += 1

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"graph_captures": self.captures, "graph_replays": self.replays,
                    "graph_eager": self.eager}


def abandon_capture(graph: torch.cuda.CUDAGraph, dev: torch.device, pool) -> None:
    """End a capture that failed, and the allocator's recording into
    ``pool``, which ``capture_end`` skips when CUDA invalidated the
    capture; errors of either are dropped (the caller raises the one that
    broke the capture)."""
    try:
        graph.capture_end()
    except Exception:  # noqa: BLE001
        pass
    try:
        torch.cuda.memory._cuda_endAllocateToPool(dev.index, pool)
    except Exception:  # noqa: BLE001
        pass


def _tensors(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def agree(error: Optional[BaseException], reading: dict, what: str) -> None:
    """Every rank's outcome of one capture (``error``: this rank's, or
    None; ``reading``: what it captured, which must be the same on every
    rank), exchanged over the gloo group. Raises on every rank where any
    rank failed (this rank's own error where it failed) or where the
    readings differ; returns where every rank captured the same program.
    Every rank of the group must call it for the same capture."""
    from sse_tpu_torch.parallel import distributed

    said = None if error is None else f"{type(error).__name__}: {error}"[:2000]
    got = distributed.all_gather_object({"error": said, "reading": reading})
    if error is not None:
        raise error
    failed = [r for r, g in enumerate(got) if g["error"] is not None]
    if failed:
        raise RuntimeError(f"{what}: the capture failed on rank(s) {failed} "
                           f"({got[failed[0]]['error']}); no rank replays it")
    readings = [g["reading"] for g in got]
    if any(r != readings[0] for r in readings):
        raise RuntimeError(f"{what}: the ranks captured different programs {readings}; no rank "
                           f"replays it")


class Captured:
    """``run()`` captured as one CUDA graph on ``dev``; ``run`` reads only
    tensors that stay put between replays (its caller copies each call's
    inputs into them) and may read no device value on the host.

    ``run`` goes once on the side stream ``side`` (it builds the kernels
    and warms the allocator); ``take_first()`` hands that result to the
    capturing call, so each call launches its kernels once, eagerly or in
    a replay. Then the capture on ``side`` into ``pool``, thread-local:
    another thread may sync the card or run meanwhile; the cyclic garbage
    collector is off during it, as a CUDA graph it destroyed in this
    thread would invalidate the capture. ``pack`` maps
    ``run()``'s result, inside the capture, to the tensors a replay leaves
    its result in (``out``, overwritten by the next replay). A capture
    that fails is ended and raises. ``seconds`` and ``mib``: the host time
    of the warm-up and the capture, and what the capture added to the
    allocator's reserve; ``launches`` counts a replay's kernels."""

    def __init__(self, run: Callable[[], Any], dev: torch.device, pool,
                 side: torch.cuda.Stream, pack: Optional[Callable] = None) -> None:
        with span("graphs.capture"):
            t0 = time.perf_counter()
            self.launches = GraphLaunches()
            self.graph = torch.cuda.CUDAGraph()
            cur = torch.cuda.current_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.first = run()
            cur.wait_stream(side)
            for x in _tensors(self.first):  # the caller reads it on its own stream
                x.record_stream(cur)
            reserved = torch.cuda.memory_reserved(dev)
            collecting = gc.isenabled()
            gc.disable()  # a graph or buffer the collector frees here would end the capture
            try:
                with self.launches.capturing(), torch.cuda.stream(side):
                    self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        out = run()
                        self.out = out if pack is None else pack(out)
                    except BaseException:
                        abandon_capture(self.graph, dev, pool)
                        raise
                    self.graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            self.mib = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
            self.seconds = time.perf_counter() - t0

    def take_first(self):
        """The warm-up's result, once: the capturing call's."""
        out, self.first = self.first, None
        return out

    def replay(self):
        self.graph.replay()
        self.launches.replayed()
        return self.out


class GraphPool:
    """One memory pool and capture stream on a card, shared by graphs that
    replay one at a time on one stream (the allocator reuses a block only
    on the stream it was allocated on, so each capture takes the blocks
    the ones before it left free). A capture that fails may leave the pool
    inconsistent: the next capture takes a new pool."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self.handle = None
        self.side: Optional[torch.cuda.Stream] = None

    def capture(self, run: Callable[[], Any], pack: Optional[Callable] = None) -> Captured:
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        if self.side is None:
            self.side = torch.cuda.Stream(self.dev)
        try:
            return Captured(run, self.dev, self.handle, self.side, pack)
        except BaseException:
            self.handle = None
            raise


class PerCard:
    """The graphs of a program that a grid runs as one body a distinct
    card: one ``GraphPool`` a card, and a ``Captured`` a card and key.
    ``capture(dev, run)`` captures ``run`` (which touches only ``dev``'s
    memory: no copy between cards inside a capture) under
    ``torch.cuda.device(dev)`` into that card's pool and side stream;
    ``replay(graphs)`` launches every card's graph, in the order given,
    before it returns anything, and gives each card's outputs back on
    that card (each replay runs on its card's current stream, so copies
    between cards made after it are ordered after it). ``drop(dev)``
    forgets a card's pool: its next capture takes a new one, as a pool
    whose graphs are all gone may not take another capture."""

    def __init__(self) -> None:
        self.pools: Dict[torch.device, GraphPool] = {}

    def capture(self, dev: torch.device, run: Callable[[], Any],
                pack: Optional[Callable] = None) -> Captured:
        pool = self.pools.setdefault(dev, GraphPool(dev))
        with torch.cuda.device(dev):
            return pool.capture(run, pack)

    def drop(self, dev: torch.device) -> None:
        self.pools.pop(dev, None)

    def pool(self, dev: torch.device) -> GraphPool:
        """``dev``'s pool, its handle and side stream made."""
        pool = self.pools.setdefault(dev, GraphPool(dev))
        if pool.handle is None:
            pool.handle = torch.cuda.graph_pool_handle()
        if pool.side is None:
            pool.side = torch.cuda.Stream(dev)
        return pool

    @staticmethod
    def replay(graphs: Dict[torch.device, Captured]) -> Dict[torch.device, Any]:
        outs = {}
        for dev, graph in graphs.items():
            with torch.cuda.device(dev):
                outs[dev] = graph.replay()
        return outs


def pool_for(dev: torch.device, capture: bool = True) -> Optional[GraphPool]:
    """A new ``GraphPool`` where programs capture: a card, unless the
    caller asks for eager (``capture=False``); None elsewhere."""
    return GraphPool(dev) if capture and dev.type == "cuda" else None


class Program:
    """``run()`` over fixed input buffers: with a ``pool`` (a card), its
    first call captures it into the pool (that call returns the warm-up's
    result) and each later call replays it, returning the graph's output
    buffers; with ``pool=None`` each call runs ``run()`` eagerly (the CPU,
    or a caller that asks for eager). ``stats`` counts captures and
    replays; ``shape`` labels the capture's reading."""

    def __init__(self, run: Callable[[], Any], pool: Optional[GraphPool],
                 stats: Optional[GraphStats] = None, shape: Any = None) -> None:
        self.run, self.pool, self.shape = run, pool, shape
        self.stats = GraphStats() if stats is None else stats
        self.graph: Optional[Captured] = None

    def __call__(self):
        if self.pool is None:
            return self.run()
        if self.graph is None:
            graph = self.pool.capture(self.run)
            self.graph = graph
            self.stats.captured({"shape": self.shape, "seconds": graph.seconds,
                                 "mib": graph.mib})
            return graph.take_first()
        out = self.graph.replay()
        self.stats.replayed()
        return out


class _Eager:
    """A ``Recorder``'s interface that records nothing: work runs where it
    is issued and a copy is ``Tensor.to``."""

    @staticmethod
    def on(dev: torch.device, gens: Sequence[torch.Generator] = ()):
        return contextlib.nullcontext()

    @staticmethod
    def copy(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        return x.to(dev)

    @staticmethod
    def new_pass() -> None:
        pass


EAGER = _Eager()


class Recorder:
    """A program over several cards as per-card CUDA graphs and the copies
    between them. The program issues its work on a card inside ``on(dev,
    gens)`` and moves a value to another card by ``copy(x, dev)``; it may
    issue no other device work. ``record(run)`` runs ``run()`` once and
    captures it: consecutive work on one card with no copy between is one
    graph, captured in the card's pool (``PerCard.pool``) on its side
    stream, so the graphs that a card's work spans (a forward and the
    backward that reads what the forward saved, say) share the pool and
    replay in the order they were captured; a copy ends the open capture
    and is kept with a fixed destination buffer on the other card (the
    k-th copy of each pass, ``new_pass``, reuses the k-th buffer: a card's
    work runs in issue order on its stream, so a pass's copy follows every
    read of the buffer before it). ``gens``: generators the work draws
    from, registered with the graph it lands in; work that brings another
    generator opens a new graph (one ``on(dev, all_gens)`` around a whole
    program keeps it one graph). ``warm(run)`` runs ``run()`` eagerly on
    every card's side stream first (the kernels built, the allocator and
    the libraries' workspaces warmed). ``replay()`` replays every graph on
    its card's current stream and issues every copy (ordered against
    both cards' current streams by ``Tensor.copy_``) in the recorded
    order, and returns ``run()``'s result as recorded. ``graphs`` counts
    the graphs a card, ``seconds`` and ``mib`` (a card) are the host time
    of the warm-up and the recording and what the recording added to
    each card's reserve, and ``launches`` counts a replay's kernels and
    collectives. A capture that fails is ended and raises; its card's
    pool is dropped (``PerCard.drop``).

    A device collective issued inside ``on(dev)`` (NCCL, across
    processes) is work on the card: it stays in the open graph. With
    ``agree`` (a program across processes) the ranks agree on the
    recording (``agree``: every rank captured, and the same graphs,
    copies and collectives); where they do not, every rank drops its
    pools and raises."""

    def __init__(self, cards: Sequence[torch.device], per_card: Optional[PerCard] = None,
                 split: bool = False, agree: bool = False) -> None:
        self.cards = list(cards)
        self.split = split  # each ``on`` its own graph (a check of the graphs' order on one card)
        self.agree = agree
        self.per_card = PerCard() if per_card is None else per_card
        self.actions: List[tuple] = []
        self.launches = GraphLaunches()
        self.graphs: Dict[torch.device, int] = collections.Counter()
        self.buffers: List[torch.Tensor] = []
        self.out = None
        self.seconds = 0.0
        self.mib: Dict[torch.device, float] = {}
        self._open = None  # (dev, graph, registered generators)
        self._recording = False
        self._k = 0  # copies so far in this pass

    def _side(self, dev: torch.device):
        return self.per_card.pool(dev).side

    @contextlib.contextmanager
    def _sides(self):
        """Every card's side stream current, ordered after (and then before)
        the card's current stream."""
        sides = {dev: self._side(dev) for dev in self.cards}
        for dev, side in sides.items():
            side.wait_stream(torch.cuda.current_stream(dev))
        with contextlib.ExitStack() as stack:
            for side in sides.values():
                stack.enter_context(torch.cuda.stream(side))
            yield
        for dev, side in sides.items():
            torch.cuda.current_stream(dev).wait_stream(side)

    def warm(self, run: Callable[[], Any]) -> None:
        t0 = time.perf_counter()
        with self._sides():
            run()
        self.seconds += time.perf_counter() - t0

    @contextlib.contextmanager
    def on(self, dev: torch.device, gens: Sequence[torch.Generator] = ()):
        if not self._recording:
            yield
            return
        gens = [g for g in gens if g is not None]
        if self._open is not None and (self._open[0] != dev or
                                       any(g not in self._open[2] for g in gens)):
            self._close()
        if self._open is None:
            pool = self.per_card.pool(dev)
            with torch.cuda.device(dev):
                graph = torch.cuda.CUDAGraph()
                # a generator's first registration puts its graph-safe seed and
                # offset on the current card: it must be the generator's own, or
                # the graphs read them across cards, unordered with each replay's
                # refill of them
                for g in gens:
                    graph.register_generator_state(g)
                with torch.cuda.stream(pool.side):
                    graph.capture_begin(pool=pool.handle, capture_error_mode="thread_local")
            self._open = (dev, graph, gens)
        with torch.cuda.device(dev), torch.cuda.stream(self._side(dev)):
            yield
        if self.split and self._open is not None:
            self._close()

    def _close(self) -> None:
        dev, graph, _ = self._open
        self._open = None
        with torch.cuda.device(dev), torch.cuda.stream(self._side(dev)):
            graph.capture_end()
        self.actions.append(("graph", dev, graph))
        self.graphs[dev] += 1

    def copy(self, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if not self._recording:
            return x.to(dev)
        if self._open is not None:
            self._close()
        buf = self.buffers[self._k] if self._k < len(self.buffers) else None
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype or buf.device != dev:
            buf = torch.empty(x.shape, dtype=x.dtype, device=dev)
            if self._k < len(self.buffers):
                self.buffers[self._k] = buf
            else:
                self.buffers.append(buf)
        self._k += 1
        self.actions.append(("copy", x, buf))
        return buf

    def new_pass(self) -> None:
        self._k = 0

    def reading(self) -> dict:
        """What was recorded, the same on every rank of a program across
        processes: graphs, copies and collectives a replay."""
        return {"graphs": sum(self.graphs.values()),
                "copies": sum(a[0] == "copy" for a in self.actions),
                "collectives": dict(sorted(self.launches.collectives.items()))}

    def record(self, run: Callable[[], Any]):
        t0 = time.perf_counter()
        reserved = {dev: torch.cuda.memory_reserved(dev) for dev in self.cards}
        collecting = gc.isenabled()
        gc.disable()  # a graph or buffer the collector frees here would end a capture
        self._recording = True
        error = None
        try:
            with self.launches.capturing():
                if self.agree:
                    from sse_tpu_torch.parallel import distributed

                    distributed.check_capturable()
                self.out = run()
                if self._open is not None:
                    self._close()
        except BaseException as e:  # noqa: BLE001 (raised below, on every rank)
            error = e
            if self._open is not None:
                dev, graph, _ = self._open
                self._open = None
                with torch.cuda.device(dev), torch.cuda.stream(self._side(dev)):
                    abandon_capture(graph, dev, self.per_card.pool(dev).handle)
        finally:
            self._recording = False
            if collecting:
                gc.enable()
        try:
            if self.agree:
                agree(error, self.reading(), "a recording across processes")
            elif error is not None:
                raise error
        except BaseException:
            self.actions.clear()
            self.out = None
            for dev in self.cards:
                self.per_card.drop(dev)
            raise
        self.mib = {dev: (torch.cuda.memory_reserved(dev) - r) / 2**20
                    for dev, r in reserved.items()}
        self.seconds += time.perf_counter() - t0
        return self.out

    def replay(self):
        for action in self.actions:
            if action[0] == "graph":
                with torch.cuda.device(action[1]):
                    action[2].replay()
            else:
                action[2].copy_(action[1])
        self.launches.replayed()
        return self.out
