"""The training step against the card's peak: both towers forward (4-gate
LSTM, attention readout, projection), the similarity product, the
backward counted as twice the forward, and the mining's scores against
every target, of the traced window's steps, over the window's seconds."""

from benchmark import readers


def read(run):
    if run.trace is None:
        return None
    return readers.mfu_pct(run, readers.train_flops(run.record))
