"""A traced window read from torch.profiler: the device's busy time (the
union of every kernel, copy and set on the card), each kernel's time by
name, the heaviest device operations, and the idle gaps named by the
benchmark's own host range (``bench.*``) that was open when each began.

Now and then torch.profiler loses kernel records. ``lost`` holds the
trace against the launches the program's wrappers counted in the same
window (``sse_tpu_torch.ops.launch_counts``, which counts a replayed
graph's launches too): where the trace holds fewer events of a kernel
than were launched, the window is profiled again."""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# counter of the program's launches → a name fragment of each kernel it
# launches once a counted call
LAUNCH_PATTERNS = {
    "gru_fwd": "gru_fwd_kernel",
    "rnn_scan": "rnn_scan",
    "gru_bwd": "gru_bwd_dh",
    "lstm_bwd": "lstm_bwd_dh",
    "twophase_p1": "blockmax_kernel",
    "twophase_p2": "pairs_kernel",
    "topk_stream": "stream_kernel",
    "topk_exact": "stream_kernel",
}
WINDOW = "bench.window"
_ANNOTATION_PREFIXES = ("sse.", "bench.", "ProfilerStep")


def span(on: bool):
    """A host range factory: ``record_function`` while tracing, else a
    context that costs nothing."""
    if on:
        return torch.profiler.record_function
    return lambda name: contextlib.nullcontext()


class Trace:
    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window: Tuple[float, float]) -> None:
        self.device = device  # (name, start µs, end µs) of every device operation
        self.host = host  # (name, start µs, end µs) of the bench.* host ranges
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) / 1e6
        self.busy = self._union()
        self._host_sorted = sorted((ev for ev in host if ev[0] != WINDOW), key=lambda ev: ev[1])
        self._starts = [ev[1] for ev in self._host_sorted]

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        device, host, window = [], [], None
        for ev in prof.events():
            name = ev.name
            start, end = ev.time_range.start, ev.time_range.end
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if (name.startswith(_ANNOTATION_PREFIXES)
                        or getattr(ev, "is_user_annotation", False)):
                    continue
                device.append((name, start, end))
            elif name.startswith("bench."):
                if name == WINDOW:
                    window = (start, end)
                host.append((name, start, end))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        return cls(device, host, window)

    def _union(self) -> List[Tuple[float, float]]:
        spans = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.device
                       if e > self.t0 and s < self.t1)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def matching(self, patterns: Iterable[str]) -> List[Tuple[str, float, float]]:
        pats = tuple(patterns)
        return [ev for ev in self.device if any(p in ev[0] for p in pats)]

    def seconds(self, patterns: Iterable[str]) -> float:
        """Summed device seconds of the operations whose names hold one of
        ``patterns``."""
        return sum(e - s for _, s, e in self.matching(patterns)) / 1e6

    def lost(self, launched: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
        """Kernel name fragment → (events in the trace, launches counted),
        where the trace holds fewer."""
        want: Dict[str, int] = {}
        for counter, n in launched.items():
            if n and counter in LAUNCH_PATTERNS:
                want[LAUNCH_PATTERNS[counter]] = want.get(LAUNCH_PATTERNS[counter], 0) + n
        seen = {p: len(self.matching([p])) for p in want}
        return {p: (seen[p], n) for p, n in want.items() if seen[p] < n}

    def device_ops(self, top: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for name, s, e in self.device:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def _host_at(self, t: float) -> str:
        """The innermost bench.* range open at ``t`` (the window itself
        where no other is), among the last ranges begun before ``t``."""
        best: Optional[Tuple[str, float, float]] = None
        i = bisect.bisect_right(self._starts, t)
        for ev in self._host_sorted[max(0, i - 32) : i]:
            if ev[1] <= t < ev[2] and (best is None or ev[2] - ev[1] < best[2] - best[1]):
                best = ev
        return best[0] if best else WINDOW

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the window summed by the host range open when
        each gap began, largest first."""
        gaps, at = [], self.t0
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        total: Dict[str, float] = {}
        for s, e in gaps:
            name = self._host_at(s)
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(total.items(), key=lambda x: -x[1])[:top]]
