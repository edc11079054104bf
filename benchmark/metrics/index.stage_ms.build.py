"""The index build's staging: mean host milliseconds a build spends slicing,
padding, pinning and uploading its chunks' tokens (self time of the
``index.stage`` spans a ``index.build``), in the traced window."""

from benchmark import spans


def read(run):
    return spans.self_per_call(run, "index.stage", "index.build", 1e3)
