"""Where an entry point runs: the card, unless ``SSE_PLATFORM=cpu``
asks for the CPU (the counterpart of the JAX package's ``SSE_PLATFORM``,
which picks JAX's backend)."""

from __future__ import annotations

import os

import torch


def env_device() -> torch.device:
    """The card, or the CPU with ``SSE_PLATFORM=cpu`` (a ``:N`` device
    count suffix, which the JAX CLI takes, is accepted and ignored).
    Raises where there is no card and the CPU was not asked for."""
    platform = os.environ.get("SSE_PLATFORM", "").partition(":")[0].lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu", "cuda"):
        raise ValueError(f"SSE_PLATFORM must be cpu or gpu, got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (set SSE_PLATFORM=cpu to run on the CPU)")
    return torch.device("cuda")
