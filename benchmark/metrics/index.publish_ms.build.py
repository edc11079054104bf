"""The index build's publish: mean host milliseconds a build spends making
its ``ShardedIndex`` (the ids' and texts' copies; self time of the
``index.publish`` span a ``index.build``), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "index.publish", "index.build", 1e3)
