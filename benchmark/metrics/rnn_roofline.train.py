"""Recurrent kernels in the training cell: the least time for both towers'
LSTM layers forward and backward over the steps of the traced window (the
questions' and the candidates' valid tokens; a candidate drawn or mined
counted at the target space's mean length) over the summed device time of
the recurrent kernels (scan, x-product, dh loops, backward products)."""

from benchmark import readers

KERNELS = ("gru_fwd_kernel", "rnn_scan", "gates_product_kernel", "gru_bwd_dh", "lstm_bwd_dh",
           "dxs_product_kernel", "dw_product_kernel", "bwd_reduce_kernel")


def read(run):
    if run.trace is None:
        return None
    return readers.roofline_pct(run, KERNELS, *readers.rnn_train_work(run.record))
