"""The model step of the bulk query cell against the card's peak: the
source tower over the queries' valid tokens and the scores against every
index row, of the traced window's batches, over the window's seconds."""

from benchmark import readers


def read(run):
    if run.trace is None:
        return None
    return readers.mfu_pct(run, readers.query_model_flops(run.record))
