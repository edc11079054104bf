"""Profiler trace of a run and a steps/sec timer (port of
``sse_tpu/utils/profiling.py``'s ``trace``, which ``train --profile_dir``
uses, and ``StepTimer``). ``trace`` is a ``torch.profiler`` context that
writes a Chrome trace (open it in Perfetto or chrome://tracing) into a
directory."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator

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


def wait_for(out: Any) -> None:
    """Block until the device work that produced ``out`` (a tensor, or a
    tuple, list or dict of them) has finished: ``torch.cuda.synchronize``
    of each CUDA device it lives on. CPU tensors are ready when returned."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            wait_for(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            wait_for(v)


class StepTimer:
    """Wall-clock steps/sec with an explicit completion barrier: PyTorch
    returns before the card finishes, so callers pass the step output and
    ``step`` waits for the device it lives on."""

    def __init__(self):
        self.reset()

    def step(self, out: Any = None) -> None:
        if out is not None:
            wait_for(out)
        self._steps += 1

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
