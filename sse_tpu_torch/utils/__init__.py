"""Aux helpers (port of ``sse_tpu.utils``): the profiler trace, the live
profiler endpoint, the steps/sec timer and the debug checks."""

from sse_tpu_torch.utils.debug import enable_debug_checks
from sse_tpu_torch.utils.profiling import StepTimer, start_profiler_server, trace

__all__ = ["StepTimer", "enable_debug_checks", "start_profiler_server", "trace"]
