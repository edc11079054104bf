"""The index build's encode calls: mean host milliseconds a build spends in
its chunk program's calls and the rows' copies into the index (self time
of the ``index.encode`` spans a ``index.build``, the first chunk's
capture left out; a replay that waits on a full launch queue shows
here), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "index.encode", "index.build", 1e3)
