"""Top-k kernels in the bulk query cell: the least time for the scores of
every query against every index row and the k best of each (work.score_topk
over the traced window's batches) over the summed device time of the
hand-written top-k kernels (two-phase phases 1 and 2, the streaming
kernel, its select)."""

from benchmark import readers

KERNELS = ("blockmax_kernel", "pairs_kernel", "stream_kernel", "topk_select_kernel")


def read(run):
    if run.trace is None:
        return None
    return readers.roofline_pct(run, KERNELS, *readers.query_topk_work(run.record))
