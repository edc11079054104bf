"""The card in the bulk cell: the share of the traced window in which no
kernel, copy or set ran on it."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
