"""JAX params / index arrays → torch tensors.

``params_from_jax`` takes the pytree that ``sse_tpu.models.sse.init_params``
returns (or restored ``inference_params``), with leaves as numpy arrays or
anything ``np.asarray`` accepts, and returns the same nesting of dicts and
lists with torch tensors. Layouts are kept as they are: the fused RNN
weight stays [(in+H), G·H] with gate order (z, r, n) for the GRU, so the
port's ``_split_weights`` reads it exactly like the JAX one. This module
imports no JAX: callers hand it host arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def array_from_jax(a: Any, device: torch.device | str = "cpu") -> torch.Tensor:
    """One host array (float32, bfloat16, int8, int32, ...) → tensor.

    numpy's bfloat16 is ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    rejects, so its bits travel as uint16 and are viewed back."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree: Any, device: torch.device | str = "cpu") -> Any:
    """Convert a params pytree (dicts, lists, tuples of arrays)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return array_from_jax(tree, device)
