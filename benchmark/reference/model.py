"""Plain PyTorch towers: the GRU and LSTM cells, the final and attention
readouts, the tanh projection and the L2 norm, in float32 throughout.

Written from the model's equations, not from the program: the GRU's
reset gate scales the whole candidate pre-activation (x-part and bias
included), the LSTM's forget gate carries a +1 bias, gate orders are
(z, r, n) and (i, f, g, o) over one fused [(E+H), G·H] weight on [x; h],
a row's carry stops at its length, and the attention readout is
``softmax_t(v·tanh(W h_t + b)) · h`` over the valid steps plus the final
state.

``Precision`` rounds the operands of every product. ``exact()`` rounds
nothing and turns TF32 off, the reference; ``fp8()`` rounds each operand
(and, in a backward, each incoming gradient) to float8 e4m3 with a
per-tensor scale, one step below the bfloat16 products the configurations
state: the control that a sound comparison has to fail. ``bf16()`` rounds
to bfloat16, the configurations' own precision: a second witness of how
far a sound run at that precision lies from the reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

GATES = {"gru": 3, "lstm": 4}


def no_tf32() -> None:
    """float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """How the operands of a product are rounded before it (None: not at
    all)."""

    def __init__(self, dtype: Optional[torch.dtype] = None, scaled: bool = False) -> None:
        self.dtype, self.scaled = dtype, scaled

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        if not self.scaled:
            return x.to(self.dtype).float()
        top = torch.finfo(self.dtype).max
        scale = top / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(self.dtype).float() / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., K] @ b [K, N] with both operands rounded."""
        if self.dtype is None:
            return a @ b
        return _RoundedMM.apply(a, b, self)


def exact() -> Precision:
    no_tf32()
    return Precision(None)


def fp8() -> Precision:
    no_tf32()
    return Precision(torch.float8_e4m3fn, scaled=True)


def bf16() -> Precision:
    no_tf32()
    return Precision(torch.bfloat16)


class _RoundedMM(torch.autograd.Function):
    """a @ b on rounded operands; the backward rounds the incoming
    gradient as well."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ra, rb = prec.round(a), prec.round(b)
        ctx.save_for_backward(ra, rb)
        ctx.prec = prec
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.prec.round(g)
        da = rg @ rb.t()
        db = ra.reshape(-1, ra.shape[-1]).t() @ rg.reshape(-1, rg.shape[-1])
        return da, db, None


def _step(cell: str, gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    if cell == "gru":
        z, r, n = torch.chunk(gates, 3, dim=-1)
        z = torch.sigmoid(z)
        return (1.0 - z) * torch.tanh(torch.sigmoid(r) * n) + z * h, c
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def encode(p: Dict, tower: Dict, tokens: torch.Tensor, lengths: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """Token ids [B, L] and lengths [B] → L2-normalized [B, D] float32."""
    cell, readout = tower["cell"], tower["readout"]
    g = GATES[cell]
    x = p["embed"][tokens.long()]  # [B, L, E]
    b, length, _ = x.shape
    valid = (torch.arange(length, device=x.device)[None, :] < lengths[:, None].long()).float()
    for layer in p["layers"]:
        w, bias = layer["w"], layer["b"]
        hidden = w.shape[1] // g
        e = w.shape[0] - hidden
        ax = prec.mm(x.reshape(b * length, e), w[:e]).reshape(b, length, g * hidden) + bias
        h = x.new_zeros((b, hidden))
        c = x.new_zeros((b, hidden))
        states = []
        for t in range(length):
            h_new, c_new = _step(cell, ax[:, t] + prec.mm(h, w[e:]), h, c)
            m = valid[:, t : t + 1]
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            states.append(h)
        x = torch.stack(states, dim=1)  # [B, L, H]
    final = h
    if readout == "final":
        feats = final
    elif readout == "attention":
        hidden = x.shape[-1]
        proj = torch.tanh(prec.mm(x.reshape(b * length, hidden), p["attn_w"])
                          .reshape(b, length, hidden) + p["attn_b"])
        scores = (proj * p["attn_v"]).sum(-1)
        scores = torch.where(valid > 0, scores, torch.finfo(torch.float32).min)
        alpha = torch.softmax(scores, dim=-1)
        feats = (alpha[:, :, None] * x).sum(1) + final
    else:
        raise ValueError(f"readout {readout!r} has no reference")
    out = torch.tanh(prec.mm(feats, p["proj_w"]) + p["proj_b"])
    return out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp(min=1e-6)


@torch.no_grad()
def encode_blocks(p: Dict, tower: Dict, tokens: torch.Tensor, lengths: torch.Tensor,
                  prec: Precision, block: int = 65536) -> torch.Tensor:
    """``encode`` of many rows, ``block`` rows at a time."""
    return torch.cat([encode(p, tower, tokens[lo : lo + block], lengths[lo : lo + block], prec)
                      for lo in range(0, tokens.shape[0], block)])
