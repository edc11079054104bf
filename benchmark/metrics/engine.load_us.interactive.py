"""The engine's load in the interactive cell: mean host microseconds a request
spends copying its tokens, lengths and row count into the graph's
buffers (``QueryGraph.load``: self time of the ``engine.load`` span a
``engine.call``), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "engine.load", "engine.call", 1e6)
