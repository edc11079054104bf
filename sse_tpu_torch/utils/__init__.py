"""Aux helpers (port of ``sse_tpu.utils``): the profiler trace."""

from sse_tpu_torch.utils.profiling import trace

__all__ = ["trace"]
