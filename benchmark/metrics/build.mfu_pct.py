"""The index build against the card's peak: the target tower forward
over every passage's valid tokens, of the traced window's builds, over
the window's seconds."""

from benchmark import readers


def read(run):
    if run.trace is None:
        return None
    return readers.mfu_pct(run, readers.build_flops(run.record))
