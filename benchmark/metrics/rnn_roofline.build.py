"""Recurrent kernels in the index-build cell: the least time for the
target tower's LSTM forward over every passage's valid tokens, of the
traced window's builds, over the summed device time of the recurrent
kernels."""

from benchmark import readers

KERNELS = ("gru_fwd_kernel", "rnn_scan", "gates_product_kernel", "gru_bwd_dh", "lstm_bwd_dh",
           "dxs_product_kernel", "dw_product_kernel", "bwd_reduce_kernel")


def read(run):
    if run.trace is None:
        return None
    return readers.roofline_pct(run, KERNELS, *readers.build_rnn_work(run.record))
