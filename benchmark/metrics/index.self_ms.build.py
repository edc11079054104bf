"""The index build's unnamed host time: mean milliseconds of a build that no
child span names (self time of the ``index.build`` span: buffers, the
chunk program made, progress calls), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "index.build", "index.build", 1e3)
