"""Hand-written Hopper kernels with their plain PyTorch versions (port of
``sse_tpu.ops``). Importing this package builds nothing; the CUDA library
is compiled on the first launch (``sse_tpu_torch.ops._build``)."""

from sse_tpu_torch.ops import rnn, topk
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
    return {**rnn.launches, **{name: topk.launch_total(name) for name in topk.KERNELS}}


def reset_launch_counts() -> None:
    for name in rnn.launches:
        rnn.launches[name] = 0
    topk.launches.clear()


__all__ = [
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
