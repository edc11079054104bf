"""Hand-written Hopper kernels with their plain PyTorch versions (port of
``sse_tpu.ops``). Importing this package builds nothing; the CUDA library
is compiled on the first launch (``sse_tpu_torch.ops._build``)."""

import contextlib
from collections import Counter

from sse_tpu_torch.ops import embed, rnn, topk
from sse_tpu_torch.ops.rnn import (
    RNNLayer,
    rnn_layer,
    rnn_layer_bwd,
    rnn_layer_bwd_reference,
    rnn_layer_reference,
)
from sse_tpu_torch.ops.topk import (
    fused_score_topk,
    fused_score_topk_twophase,
    quantize_queries_int8,
    topk_reference,
)


def launch_counts() -> dict:
    """Launches of every kernel wrapper since the last reset."""
    return {**rnn.launches, **embed.launches,
            **{name: topk.launch_total(name) for name in topk.KERNELS}}


def reset_launch_counts() -> None:
    for counts in (rnn.launches, embed.launches):
        for name in counts:
            counts[name] = 0
    topk.launches.clear()


class GraphLaunches:
    """The launches of a captured CUDA graph, counted on each replay. A
    wrapper counts its launch while the graph is captured, where nothing
    runs; ``with g.capturing():`` around the capture takes those counts
    back out and keeps them, and ``g.replayed()`` adds them once a
    replay, so the counters see every launch a replay makes. The device
    collectives a graph holds (``parallel.distributed.collectives``, by
    op) are counted the same way, in ``collectives``."""

    def __init__(self) -> None:
        self.rnn: dict = {}
        self.embed: dict = {}
        self.topk: Counter = Counter()
        self.collectives: Counter = Counter()

    @contextlib.contextmanager
    def capturing(self):
        from sse_tpu_torch.parallel import distributed  # not at import: parallel imports ops

        rnn0, embed0, topk0 = dict(rnn.launches), dict(embed.launches), Counter(topk.launches)
        coll0 = Counter(distributed.collectives)
        try:
            yield self
        finally:
            self.rnn = {k: rnn.launches[k] - rnn0[k] for k in rnn0}
            self.embed = {k: embed.launches[k] - embed0[k] for k in embed0}
            self.topk = topk.launches - topk0
            self.collectives = distributed.collectives - coll0
            rnn.launches.update(rnn0)
            embed.launches.update(embed0)
            topk.launches.clear()
            topk.launches.update(topk0)
            distributed.collectives.clear()
            distributed.collectives.update(coll0)

    def replayed(self) -> None:
        from sse_tpu_torch.parallel import distributed

        for counts, made in ((rnn.launches, self.rnn), (embed.launches, self.embed)):
            for name, n in made.items():
                counts[name] += n
        topk.launches.update(self.topk)
        distributed.collectives.update(self.collectives)


__all__ = [
    "GraphLaunches",
    "RNNLayer",
    "fused_score_topk",
    "fused_score_topk_twophase",
    "launch_counts",
    "quantize_queries_int8",
    "reset_launch_counts",
    "rnn_layer",
    "rnn_layer_bwd",
    "rnn_layer_bwd_reference",
    "rnn_layer_reference",
    "topk_reference",
]
