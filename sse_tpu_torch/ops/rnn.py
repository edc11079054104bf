"""One fused GRU layer, forward and backward (port of
``sse_tpu/ops/pallas_rnn.py`` ``rnn_layer``: the ``_layer_fwd_pallas`` →
``_fwd_gru_kernel`` forward and the ``_layer_bwd_pallas`` → ``_bwd_kernel``
backward, GRU branch).

Forward, per step: ``gates_t = xs_t·Wx + b + bf16(h_{t-1})·Wh`` (bf16
operands, float32 sums), the fused-reset GRU cell, and the masked carry
freeze ``h = m·h_new + (1-m)·h``. Returns ``(ys [T,B,H] bf16, fin [B,H]
fp32)``. Backward: reverse time, gates recomputed from ``xs`` and the
bf16 ``ys``; ``dxs`` in bf16, ``dWx``, ``dWh``, ``db`` in fp32.
``RNNLayer`` is the ``torch.autograd.Function`` that joins the two, as
``jax.custom_vjp`` does in the JAX package.

On a CUDA tensor ``rnn_layer`` and ``rnn_layer_bwd`` launch
``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu`` (built on first use) or
raise; on a CPU tensor they run ``rnn_layer_reference`` and
``rnn_layer_bwd_reference``, the plain PyTorch versions of the same
functions. See the kernel sources for what bounds them on the H100.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sse_tpu_torch.ops import _build

# Launches of each CUDA kernel wrapper (incremented only where it launches).
launches = {"gru_fwd": 0, "gru_bwd": 0}

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


def _h_prev(ys: torch.Tensor) -> torch.Tensor:
    """[h_{-1}=0, ys[0], ..., ys[T-2]] as float32: the bf16 state each
    step's forward matmul consumed."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).float()


def gru_gates(xs, h_prev, wx, wh, b) -> torch.Tensor:
    """The recomputed pre-activations ``xs_t·Wx + b + h_{t-1}·Wh`` [T, B, 3H]
    fp32 (bf16 operands), with ``h_prev`` as ``_h_prev`` gives it."""
    T, B, E = xs.shape
    H = wh.shape[0]
    return (
        bf16_matmul(xs.reshape(T * B, E), wx) + b.float()
        + bf16_matmul(h_prev.reshape(T * B, H), wh)
    ).reshape(T, B, 3 * H)


def gru_bwd_chain(
    gates: torch.Tensor,  # [T, B, 3H] fp32
    h_prev: torch.Tensor,  # [T, B, H]
    mask: torch.Tensor,  # [T, 1, B]
    wh: torch.Tensor,  # [H, 3H]
    dys: torch.Tensor,  # [T, B, H]
    dfin: torch.Tensor,  # [B, H]
    drive: torch.Tensor | None = None,  # [T, B, 3H] bf16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serial reverse loop of the backward: returns (dgates_b [T,B,3H]
    bf16, db [3H] fp32). Each step's fp32 dgates come from the cell's
    backward at ``dh_t = dh + dys_t``, ``g = m·dh_t``; dgates_b rounds
    them and ``dh = (1-m)·dh_t + g·z + dgates_b·Whᵀ``; db sums the
    unrounded dgates.

    ``drive`` replaces this loop's own dgates_b in the dh product. Given
    another implementation's dgates_b, each step then starts from the dh
    that implementation's rounding produced, so the two dgates_b differ
    only by one step's fp32 sums (a bf16 value at a rounding edge), not by
    the drift that one such flip carries down the chain."""
    T, B, _ = gates.shape
    wh_t = wh.to(torch.bfloat16).float().t()
    dh = dfin.float()
    db = torch.zeros((gates.shape[2],), dtype=torch.float32, device=gates.device)
    dgb = torch.empty(gates.shape, dtype=torch.bfloat16, device=gates.device)
    for t in range(T - 1, -1, -1):
        m = mask[t, 0][:, None].float()
        dh_t = dh + dys[t].float()
        g = m * dh_t  # d h_new
        z_pre, r_pre, n_pre = torch.chunk(gates[t], 3, dim=-1)
        z = torch.sigmoid(z_pre)
        r = torch.sigmoid(r_pre)
        n = torch.tanh(n_pre * r)
        # h_new = (1-z)·n + z·h_prev
        dn = g * (1.0 - z)
        dz_pre = g * (h_prev[t] - n) * z * (1.0 - z)
        dtanh = dn * (1.0 - n * n)
        dn_pre = dtanh * r
        dr_pre = dtanh * n_pre * r * (1.0 - r)
        dgates = torch.cat([dz_pre, dr_pre, dn_pre], dim=1)
        dgb[t] = dgates.to(torch.bfloat16)
        dg_t = dgb[t] if drive is None else drive[t]
        dh = (1.0 - m) * dh_t + g * z + dg_t.float() @ wh_t
        db += dgates.sum(0)
    return dgb, db


def gru_bwd_products(
    xs: torch.Tensor, h_prev: torch.Tensor, wx: torch.Tensor, dgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The products over all T·B rows: (dxs = bf16(dgates_b·Wxᵀ) [T,B,E],
    dWx = xsᵀ·dgates_b [E,3H], dWh = h_prevᵀ·dgates_b [H,3H]), fp32 sums."""
    T, B, E = xs.shape
    dg = dgb.float().reshape(T * B, dgb.shape[2])
    dxs = (dg @ wx.to(torch.bfloat16).float().t()).to(torch.bfloat16).reshape(T, B, E)
    dwx = xs.to(torch.bfloat16).float().reshape(T * B, E).t() @ dg
    dwh = h_prev.reshape(T * B, h_prev.shape[2]).t() @ dg
    return dxs, dwx, dwh


def rnn_layer_bwd_reference(
    xs: torch.Tensor,  # [T, B, E]
    ys: torch.Tensor,  # [T, B, H] bf16, the forward's output
    mask: torch.Tensor,  # [T, 1, B]
    wx: torch.Tensor,  # [E, 3H]
    wh: torch.Tensor,  # [H, 3H]
    b: torch.Tensor,  # [3H]
    dys: torch.Tensor,  # [T, B, H]
    dfin: torch.Tensor,  # [B, H]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch GRU layer backward with ``_bwd_kernel``'s numerics
    (``pallas_rnn.py:217-265, 290-314``); any device. Returns (dxs [T,B,E]
    bf16, dWx [E,3H], dWh [H,3H], db [3H] fp32).

    Gates are recomputed from ``xs`` and the bf16 ``ys[t-1]``; the
    products (dh, dxs, dWx, dWh) take ``dgates_b = bf16(dgates)`` and sum
    in fp32; ``db`` sums the unrounded fp32 ``dgates``."""
    h_prev = _h_prev(ys.to(torch.bfloat16))  # [T, B, H]
    gates = gru_gates(xs, h_prev, wx, wh, b)
    dgb, db = gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin)
    dxs, dwx, dwh = gru_bwd_products(xs, h_prev, wx, dgb)
    return dxs, dwx, dwh, db


def _check_bwd_args(args) -> None:
    xs = args["xs"][0]
    for name, (t, dtype, shape) in args.items():
        if not t.is_cuda or t.device != xs.device:
            raise ValueError(f"gru_bwd: {name} must be on {xs.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"gru_bwd: {name} must be contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"gru_bwd: {name} must start on a 16-byte boundary")


def _dw_splits(rows: int) -> int:
    """Slices of the T·B reduction for the dW product: ~2048 rows each, at
    most 16, so that T=50, B=256..384 gives 7-10 x 24 output tiles."""
    return max(1, min(16, -(-rows // 2048)))


def rnn_layer_bwd(
    xs: torch.Tensor,
    ys: torch.Tensor,
    mask: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    dys: torch.Tensor,
    dfin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GRU layer backward: the Hopper kernels on CUDA tensors (which
    must be contiguous and 16-byte aligned: xs, ys, dys, wx, wh bf16;
    mask, b, dfin fp32), the plain version on CPU tensors. Returns (dxs
    bf16, dWx, dWh, db fp32)."""
    if not xs.is_cuda:
        return rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys, dfin)
    return gru_bwd_launch(xs, ys, mask, wx, wh, b, dys, dfin)[:4]


def gru_bwd_launch(xs, ys, mask, wx, wh, b, dys, dfin) -> Tuple[torch.Tensor, ...]:
    """``rnn_layer_bwd`` on CUDA tensors, which also returns the kernels'
    intermediates: (dxs, dWx, dWh, db, gates [T,B,3H] fp32, dgates_b
    [T,B,3H] bf16), for checks that hold each rounding point."""
    T, B, E = xs.shape
    H = wh.shape[0]
    N = 3 * H
    _check_bwd_args({
        "xs": (xs, torch.bfloat16, (T, B, E)),
        "ys": (ys, torch.bfloat16, (T, B, H)),
        "mask": (mask, torch.float32, (T, 1, B)),
        "wx": (wx, torch.bfloat16, (E, N)),
        "wh": (wh, torch.bfloat16, (H, N)),
        "b": (b, torch.float32, (N,)),
        "dys": (dys, torch.bfloat16, (T, B, H)),
        "dfin": (dfin, torch.float32, (B, H)),
    })
    if E % 16 or H % 16:
        raise ValueError(f"gru_bwd: needs E, H multiples of 16 (E={E}, H={H})")
    lib = _build.library()
    lib.sse_gru_bwd_smem_bytes.restype = ctypes.c_int
    lib.sse_gru_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.sse_gru_bwd_block_rows.restype = ctypes.c_int
    lib.sse_gru_bwd_block_rows.argtypes = []
    smem = lib.sse_gru_bwd_smem_bytes(H)
    if smem > _MAX_SMEM:
        raise ValueError(f"gru_bwd: H={H} needs {smem} B of shared memory")
    dev = xs.device
    dxs = torch.empty((T, B, E), dtype=torch.bfloat16, device=dev)
    dw = torch.empty((E + H, N), dtype=torch.float32, device=dev)  # [dWx; dWh]
    db = torch.empty((N,), dtype=torch.float32, device=dev)
    M = T * B
    gates = torch.empty((T, B, N), dtype=torch.float32, device=dev)
    dgb = torch.empty((T, B, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return dxs, dw[:E].zero_(), dw[E:].zero_(), db.zero_(), gates, dgb
    nblk = -(-B // lib.sse_gru_bwd_block_rows())
    splits = _dw_splits(M)
    # scratch: the db and dW partial sums
    db_part = torch.empty((nblk, N), dtype=torch.float32, device=dev)
    w_part = torch.empty((splits, E + H, N), dtype=torch.float32, device=dev)
    wt = torch.cat([wx, wh]).t().contiguous()  # [Wx;Wh]ᵀ, as the TPU kernel's wxᵀ/whᵀ
    _build.launch(
        "sse_gru_bwd", [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5, dev,
        xs.data_ptr(), ys.data_ptr(), mask.data_ptr(), wt.data_ptr(),
        wx.data_ptr(), wh.data_ptr(), b.data_ptr(), dys.data_ptr(),
        dfin.data_ptr(), gates.data_ptr(), dgb.data_ptr(), db_part.data_ptr(),
        w_part.data_ptr(), dxs.data_ptr(), dw.data_ptr(), db.data_ptr(),
        T, B, E, H, splits,
    )
    launches["gru_bwd"] += 1
    return dxs, dw[:E], dw[E:], db, gates, dgb


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and starting on a 16-byte boundary (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class RNNLayer(torch.autograd.Function):
    """Differentiable GRU layer: ``RNNLayer.apply(xs, mask, wx, wh, b)`` →
    (ys bf16, fin fp32). Forward is ``rnn_layer``, backward
    ``rnn_layer_bwd`` (port of the ``jax.custom_vjp`` at
    ``pallas_rnn.py:441-466``). The float32 weights are cast to bf16
    inside, so their gradients come back in float32, unrounded; ``dxs``
    is bf16 and is cast to the dtype ``xs`` came in; ``mask`` gets none."""

    @staticmethod
    def forward(ctx, xs, mask, wx, wh, b):
        ctx.xs_dtype, ctx.b_shape = xs.dtype, b.shape
        xs_c = _aligned(xs.to(torch.bfloat16))
        mask = mask.to(torch.float32).contiguous()
        wx_c = _aligned(wx.to(torch.bfloat16))
        wh_c = _aligned(wh.to(torch.bfloat16))
        b_c = _aligned(b.to(torch.float32).reshape(-1))
        ys, fin = rnn_layer(xs_c, mask, wx_c, wh_c, b_c)
        ctx.save_for_backward(xs_c, ys, mask, wx_c, wh_c, b_c)
        return ys, fin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys, dfin):
        xs, ys, mask, wx, wh, b = ctx.saved_tensors
        # an output that fed nothing (ys of a lone final-readout layer)
        if dys is None:
            dys = torch.zeros_like(ys)
        if dfin is None:
            dfin = torch.zeros(ys.shape[1:], dtype=torch.float32, device=ys.device)
        dxs, dwx, dwh, db = rnn_layer_bwd(
            xs, ys, mask, wx, wh, b,
            _aligned(dys.to(torch.bfloat16)), _aligned(dfin.to(torch.float32)),
        )
        return dxs.to(ctx.xs_dtype), None, dwx, dwh, db.reshape(ctx.b_shape)


__all__ = [
    "RNNLayer",
    "bf16_matmul",
    "gru_bwd_chain",
    "gru_bwd_launch",
    "gru_bwd_products",
    "gru_cell",
    "gru_gates",
    "launches",
    "rnn_layer",
    "rnn_layer_bwd",
    "rnn_layer_bwd_reference",
    "rnn_layer_reference",
]
