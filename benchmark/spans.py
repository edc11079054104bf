"""Per-layer readings of the program's host spans
(``sse_tpu_torch.utils.profiling``: ``span``, whose totals the profiler
turns on): a span's self seconds over the run's traced windows, per
span of the cell's outer call (``engine.call`` a request,
``index.build`` a build), so a reading is the same whether the totals
hold one traced window or the harness's retries. Read under the
profiler, so each reading holds what the profiler adds to the host path.

None where the run is untraced or the program records no such spans (a
program without them, or a path that does not reach them, as a query
on the CPU, which replays no graph)."""

from __future__ import annotations

from typing import Optional


def self_per_call(run, name: str, outer: str, scale: float) -> Optional[float]:
    """``scale`` x the self seconds of the span ``sse.<name>`` / the count
    of ``sse.<outer>``."""
    if run.trace is None:
        return None
    try:
        from sse_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    got = span_totals()
    mine, calls = got.get("sse." + name), got.get("sse." + outer)
    if mine is None or calls is None or not calls[0]:
        return None
    return scale * mine[2] / calls[0]
