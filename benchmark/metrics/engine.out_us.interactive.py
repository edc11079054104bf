"""The engine's copy-out in the interactive cell: mean host microseconds a
request spends cloning the graph's output buffer and splitting it into
scores and rows (self time of the ``engine.out`` span a
``engine.call``), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "engine.out", "engine.call", 1e6)
