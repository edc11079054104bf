"""Serving observability: request counters + latency percentiles.

A copy of ``sse_tpu/serve/stats.py`` (stdlib only): importing that module
runs ``sse_tpu/serve/__init__.py``, which imports the JAX engine. Exposed
by ``sse_tpu_torch.serve.http`` as GET /api/stats (JSON) and GET /metrics
(Prometheus text). Thread-safe; the latency reservoir is a fixed ring so
memory stays O(1) at any QPS.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List


class ServingStats:
    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._window = window
        self._lat: List[float] = []  # ring buffer, seconds
        self._pos = 0
        self.queries = 0  # individual queries answered (batch = N queries)
        self.requests = 0  # HTTP query requests served
        self.errors = 0
        self.adds = 0  # /api/add calls
        self.docs_added = 0
        self.reloads = 0  # /api/reload hot model/index swaps

    # ------------------------------------------------------------ record
    def record_query(self, latency_s: float, n_queries: int = 1) -> None:
        with self._lock:
            self.requests += 1
            self.queries += n_queries
            if len(self._lat) < self._window:
                self._lat.append(latency_s)
            else:
                self._lat[self._pos] = latency_s
                self._pos = (self._pos + 1) % self._window

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_add(self, n_docs: int) -> None:
        with self._lock:
            self.adds += 1
            self.docs_added += n_docs

    def record_reload(self) -> None:
        with self._lock:
            self.reloads += 1

    # ---------------------------------------------------------- snapshot
    @staticmethod
    def _pct(sorted_lat: List[float], p: float) -> float:
        if not sorted_lat:
            return 0.0
        i = min(len(sorted_lat) - 1, int(p * (len(sorted_lat) - 1) + 0.5))
        return sorted_lat[i]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat)
            uptime = time.time() - self._t0
            snap = {
                "uptime_s": round(uptime, 3),
                "requests": self.requests,
                "queries": self.queries,
                "errors": self.errors,
                "adds": self.adds,
                "docs_added": self.docs_added,
                "reloads": self.reloads,
                "qps_lifetime": round(self.queries / max(uptime, 1e-9), 2),
                "latency_p50_ms": round(self._pct(lat, 0.50) * 1e3, 3),
                "latency_p90_ms": round(self._pct(lat, 0.90) * 1e3, 3),
                "latency_p99_ms": round(self._pct(lat, 0.99) * 1e3, 3),
                "latency_max_ms": round(max(lat) * 1e3, 3) if lat else 0.0,
                "latency_window": len(lat),
            }
        return snap

    def prometheus(self, extra: Dict[str, float] | None = None) -> str:
        """Prometheus text exposition format (type annotations included
        so a scraper ingests it without config)."""
        s = self.snapshot()
        if extra:
            s.update(extra)
        gauges = {
            "latency_p50_ms", "latency_p90_ms", "latency_p99_ms",
            "latency_max_ms", "latency_window", "qps_lifetime", "uptime_s",
            "index_num_targets", "graphs_cached",
        }
        lines = []
        for k, v in s.items():
            name = f"sse_{k}"
            kind = "gauge" if k in gauges else "counter"
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {v}")
        return "\n".join(lines) + "\n"
