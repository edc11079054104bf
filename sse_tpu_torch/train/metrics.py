"""Structured metric writing: stdout + JSONL (port of
``sse_tpu/train/metrics.py``, which cannot be imported without JAX
because ``sse_tpu/train/__init__.py`` imports the JAX train loop)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional, TextIO


class MetricWriter:
    """One human-readable ``[sse] k=v ...`` line per record on ``stream``
    and, with ``jsonl_path``, one JSON object per line appended there."""

    def __init__(self, jsonl_path: Optional[str] = None, stream: TextIO = sys.stdout):
        self._stream = stream
        self._f = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._f = open(jsonl_path, "a", encoding="utf-8")

    def write(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        parts = [
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
            if k != "time"
        ]
        print("[sse] " + " ".join(parts), file=self._stream, flush=True)
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
