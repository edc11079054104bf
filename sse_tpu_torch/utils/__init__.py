"""Aux helpers (port of ``sse_tpu.utils``): the profiler trace and the
steps/sec timer."""

from sse_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
