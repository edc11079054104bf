"""One fused GRU layer forward (port of ``sse_tpu/ops/pallas_rnn.py``
``rnn_layer`` forward, the ``_layer_fwd_pallas`` → ``_fwd_gru_kernel``
kernel).

Per step ``gates_t = xs_t·Wx + b + bf16(h_{t-1})·Wh`` (bf16 operands,
float32 sums), the fused-reset GRU cell, and the masked carry freeze
``h = m·h_new + (1-m)·h``. Returns ``(ys [T,B,H] bf16, fin [B,H] fp32)``.

On a CUDA tensor ``rnn_layer`` launches ``csrc/gru_fwd.cu`` (built on
first use) or raises; on a CPU tensor it runs ``rnn_layer_reference``,
the plain PyTorch version of the same function. See the kernel source
for what bounds it on the H100.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sse_tpu_torch.ops import _build

# Launches of the CUDA kernel (incremented only where it is launched).
launches = {"gru_fwd": 0}

_MAX_SMEM = 232_448  # opt-in dynamic shared memory per block on sm_90


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bf16-rounded operands, summed in float32 (a bf16
    ``torch.matmul`` would round its result to bf16)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def gru_cell(gates: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Elementwise GRU update from combined pre-activations [B, 3H]. The
    reset gate scales the WHOLE candidate pre-activation, its x-part and
    bias included: h' = (1-z)·tanh(r·n_pre) + z·h — not the textbook GRU."""
    z, r, n_pre = torch.chunk(gates, 3, dim=-1)
    z = torch.sigmoid(z)
    r = torch.sigmoid(r)
    n = torch.tanh(n_pre * r)
    return (1.0 - z) * n + z * h


def rnn_layer_reference(
    xs: torch.Tensor,  # [T, B, E]
    mask: torch.Tensor,  # [T, 1, B] float 1/0
    wx: torch.Tensor,  # [E, 3H]
    wh: torch.Tensor,  # [H, 3H]
    b: torch.Tensor,  # [3H]
    cell: str = "gru",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch GRU layer with the kernel's numerics; any device."""
    if cell != "gru":
        raise NotImplementedError(f"cell={cell!r} is not ported yet (see ROADMAP.md)")
    T, B, _ = xs.shape
    H = wh.shape[0]
    ax = bf16_matmul(xs.reshape(T * B, -1), wx).reshape(T, B, -1) + b.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(T):
        h_new = gru_cell(ax[t] + bf16_matmul(h, wh), h)
        m = mask[t, 0][:, None].float()
        h = m * h_new + (1.0 - m) * h
        ys.append(h.to(torch.bfloat16))
    return torch.stack(ys), h


def _check_cuda_args(xs, mask, wx, wh, b):
    T, B, E = xs.shape
    H = wh.shape[0]
    want = {
        "xs": (xs, torch.bfloat16, (T, B, E)),
        "mask": (mask, torch.float32, (T, 1, B)),
        "wx": (wx, torch.bfloat16, (E, 3 * H)),
        "wh": (wh, torch.bfloat16, (H, 3 * H)),
        "b": (b, torch.float32, (3 * H,)),
    }
    for name, (t, dtype, shape) in want.items():
        if not t.is_cuda or t.device != xs.device:
            raise ValueError(f"gru_fwd: {name} must be on {xs.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"gru_fwd: {name} must be contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    if E % 16 or H % 16 or H > 512:
        raise ValueError(f"gru_fwd: needs E, H multiples of 16 and H <= 512 (E={E}, H={H})")


def rnn_layer(
    xs: torch.Tensor,
    mask: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    cell: str = "gru",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU layer: the Hopper kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not xs.is_cuda:
        return rnn_layer_reference(xs, mask, wx, wh, b, cell)
    if cell != "gru":
        raise NotImplementedError(f"cell={cell!r} is not ported yet (see ROADMAP.md)")
    xs = xs.to(torch.bfloat16).contiguous()
    mask = mask.to(torch.float32).contiguous()
    wx = wx.to(torch.bfloat16).contiguous()
    wh = wh.to(torch.bfloat16).contiguous()
    b = b.to(torch.float32).reshape(-1).contiguous()
    _check_cuda_args(xs, mask, wx, wh, b)
    T, B, E = xs.shape
    H = wh.shape[0]
    smem_bytes = _build.library().sse_gru_fwd_smem_bytes
    smem_bytes.restype = ctypes.c_int
    smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    smem = smem_bytes(E, H)
    if smem > _MAX_SMEM:
        raise ValueError(f"gru_fwd: E={E}, H={H} needs {smem} B of shared memory")
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xs.device)
    fin = torch.empty((B, H), dtype=torch.float32, device=xs.device)
    if T == 0 or B == 0:
        return ys, fin.zero_()
    _build.launch(
        "sse_gru_fwd", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4, xs.device,
        xs.data_ptr(), mask.data_ptr(), wx.data_ptr(), wh.data_ptr(),
        b.data_ptr(), ys.data_ptr(), fin.data_ptr(), T, B, E, H,
    )
    launches["gru_fwd"] += 1
    return ys, fin


__all__ = ["bf16_matmul", "gru_cell", "launches", "rnn_layer", "rnn_layer_reference"]
