"""Debug toggles (port of ``sse_tpu/utils/debug.py``)."""

from __future__ import annotations

import torch


def enable_debug_checks(nans: bool = True, tracer_leaks: bool = True) -> None:
    """Turn on expensive runtime checks for debugging training blowups.

    * ``nans``: ``torch.autograd.set_detect_anomaly(True)``, the
      counterpart of ``jax_debug_nans``: a backward op that returns a NaN
      raises, with the stack trace of the forward op it differentiates.
      Unlike JAX's check it watches the backward only; a NaN loss shows in
      the forward's own values.
    * ``tracer_leaks``: JAX's ``jax_check_tracer_leaks`` catches tracers
      that escape a traced function. Eager PyTorch traces nothing, so it
      has no counterpart: the argument is accepted and changes nothing.
    """
    if nans:
        torch.autograd.set_detect_anomaly(True)
    del tracer_leaks


__all__ = ["enable_debug_checks"]
