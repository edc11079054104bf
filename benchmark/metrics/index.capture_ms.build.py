"""The index layer's graph capture: mean milliseconds a build spends
capturing its chunk graph, as ``build_index(graph_stats=)`` records it,
over the builds of the untraced window that a traced run makes before
its traced one (the mix's ``untraced_seconds``), so the profiler's own
host cost is not in it."""

import statistics


def read(run):
    got = (run.untraced or {}).get("captures_s")
    if run.trace is None or not got:
        return None
    return 1e3 * statistics.fmean(got)
