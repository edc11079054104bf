"""Profiler trace of a run (port of ``sse_tpu/utils/profiling.py``'s
``trace``, which ``train --profile_dir`` uses): a ``torch.profiler``
context that writes a Chrome trace (open it in Perfetto or
chrome://tracing) into a directory."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the host and, where there is a card, the device, and write
    ``<log_dir>/trace_<pid>_<time>.json`` on exit::

        with sse_tpu_torch.utils.trace("/tmp/trace"):
            state = train(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the device work of the run ends inside
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    )
