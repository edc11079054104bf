"""JAX params / index arrays → torch tensors, and back.

``params_from_jax`` takes the pytree that ``sse_tpu.models.sse.init_params``
returns (or restored ``inference_params``), with leaves as numpy arrays or
anything ``np.asarray`` accepts, and returns the same nesting of dicts and
lists with torch tensors. Layouts are kept as they are: the fused RNN
weight stays [(in+H), G·H] with gate order (z, r, n) for the GRU and
(i, f, g, o) for the LSTM, and the attention readout keeps ``attn_w``
[H, H], ``attn_b`` and ``attn_v`` [H], so the port's
``ops.rnn.split_weights`` reads a layer exactly like the JAX
``_split_weights``.
``params_to_numpy`` is the inverse, so that the JAX package can load and
evaluate params the port trained. ``train_state_from_jax`` maps a whole
JAX TrainState (restored from an Orbax checkpoint by ``sse_tpu``) onto the
port's, which ``sse_tpu_torch.train.checkpoint`` then saves. This module
imports no JAX: callers hand it, and get back, host arrays.
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


def train_state_from_jax(state: Any, device: torch.device | str = "cpu"):
    """A JAX ``TrainState`` (``params``, ``opt_state`` = optax
    ``(clip state, ScaleByAdamState | EmptyState)``, ``step``, ``lr``,
    ``ema_params``; leaves as anything ``np.asarray`` takes) → the port's
    ``TrainState`` on ``device``."""
    from sse_tpu_torch.train.loop import ScaleByAdamState, TrainState, adam_count

    adam = state.opt_state[-1] if isinstance(state.opt_state, (list, tuple)) else None
    opt = None
    if adam is not None and hasattr(adam, "mu"):
        opt = ScaleByAdamState(
            count=adam_count(int(np.asarray(adam.count)), device),
            mu=params_from_jax(adam.mu, device),
            nu=params_from_jax(adam.nu, device),
        )
    ema = state.ema_params
    return TrainState(
        params=params_from_jax(state.params, device),
        opt_state=opt,
        step=int(np.asarray(state.step)),
        lr=torch.tensor(float(np.asarray(state.lr)), dtype=torch.float32, device=device),
        ema_params=None if ema is None else params_from_jax(ema, device),
    )


def array_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor → host array of the same dtype. bf16 travels as its
    uint16 bits and comes back as ``ml_dtypes.bfloat16`` (numpy's bf16,
    which JAX reads), the inverse of ``array_from_jax``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only where a bf16 tensor appears

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(tree: Any) -> Any:
    """Convert a params tree (dicts, lists, tuples of tensors) to host
    arrays, keeping its nesting."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return array_to_numpy(tree)
