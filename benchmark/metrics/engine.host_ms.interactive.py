"""The engine's host path in the interactive cell: mean host milliseconds
from a request's send (its token upload issued) to the return of the
captured query function's call, over the requests of the untraced
window that a traced run makes before its traced one (the mix's
``untraced_seconds``), so the profiler's own host cost is not in it."""

import statistics


def read(run):
    host = (run.untraced or {}).get("host_s")
    if run.trace is None or not host:
        return None
    return 1e3 * statistics.fmean(host)
