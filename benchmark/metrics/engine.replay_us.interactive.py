"""The engine's replay in the interactive cell: mean host microseconds a
request spends launching its CUDA graph and counting its launches
(``Captured.replay``: self time of the ``engine.replay`` span a
``engine.call``), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "engine.replay", "engine.call", 1e6)
