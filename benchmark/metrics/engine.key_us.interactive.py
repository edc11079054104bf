"""The engine's key in the interactive cell: mean host microseconds a request
spends building its graph key (the identity of every param tensor), taking
the lock and looking the graph up (self time of the ``engine.key`` span
a ``engine.call``), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "engine.key", "engine.call", 1e6)
