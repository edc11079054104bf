"""Encoder towers → fixed-size L2-normalized vectors (port of
``sse_tpu/models/towers.py``).

Every tower of the JAX package: the recurrent towers — the GRU cell
(fused-reset form) and the LSTM cell (+1 forget bias), stacked layers
with optional identity residuals, each layer one ``rnn.RNNLayer`` (the
hand-written kernels on the card) — the pre-LN transformer (RoPE,
learned or sinusoid positions) and the bag-of-subwords tower, with the
final, mean and attention readouts, the tanh projection, the L2 norm and
the train-only dropout. Every tower is differentiable end to end.

Precision policy, as in the JAX package: matmul operands are bfloat16,
accumulation and the recurrent carry are float32. The tower's products
(``_dot``) are chosen by device at the call: on the card they run on the
bf16 tensor cores with a float32 result (``torch.mm``/``torch.bmm`` with
``out_dtype=float32`` inside ``_TensorCoreDot``, since autograd does not
reach through that overload); on the CPU they are ``bf16_matmul``, a
float32 product of bf16-rounded operands (a bf16 ``torch.matmul`` would
round its result to bf16 and lose the float32 accumulation). The
attention readout's two einsums take float32 operands in full float32,
as the JAX package's default-precision ``einsum`` does on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sse_tpu_torch.ops import embed, rnn
from sse_tpu_torch.ops.rnn import bf16_matmul, gru_cell, lstm_cell, split_weights
from sse_tpu_torch.utils.profiling import span

Params = Dict[str, Any]

_COMPUTE_DTYPE = torch.bfloat16
_CELLS = ("gru", "lstm", "transformer", "bow")
_READOUTS = ("final", "mean", "attention")
_POS_ENCODINGS = ("rope", "learned", "sinusoid")
# TowerConfig.embed_grad values (towers.py:105-185): the forward is the
# same gather for all; the table's cotangent is the float32 sum of the
# per-token rows ('take', 'segment', 'sort_segment', 'spread8': only the
# order of the sums differs), of bf16-rounded rows ('onehot'), summed in
# bfloat16 ('take_bf16'), or none ('zero_debug', a measurement floor that
# freezes the table). 'presorted_cost' serves but refuses a gradient: its
# cotangent is deliberately wrong (a measurement of the JAX package).
_EMBED_GRADS = ("take", "segment", "sort_segment", "onehot", "take_bf16", "spread8",
                "zero_debug", "presorted_cost")


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """Mirror of ``sse_tpu.models.towers.TowerConfig``: same fields, same
    defaults (see that class for what each one means)."""

    vocab_size: int
    embed_dim: int = 128
    hidden: int = 128
    num_layers: int = 1
    encoding_dim: int = 64
    cell: str = "gru"
    readout: str = "final"
    num_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512
    pos_encoding: str = "rope"
    use_pallas_scan: Optional[bool] = None
    dropout: float = 0.0
    residual: bool = False
    embed_grad: str = "take"


def _check_supported(cfg: TowerConfig) -> None:
    """Raise ValueError on what the JAX package refuses or cannot shape."""
    if cfg.cell not in _CELLS:
        raise ValueError(f"unknown cell {cfg.cell!r}")
    if cfg.readout not in _READOUTS:
        raise ValueError(f"unknown readout {cfg.readout!r}")
    if cfg.embed_grad not in _EMBED_GRADS:
        raise ValueError(f"unknown embed_grad impl {cfg.embed_grad!r}")
    if cfg.cell in ("transformer", "bow") and cfg.embed_dim != cfg.hidden:
        raise ValueError(f"{cfg.cell} tower requires embed_dim == hidden")
    if cfg.cell == "transformer":
        if cfg.pos_encoding not in _POS_ENCODINGS:
            raise ValueError(f"unknown pos_encoding {cfg.pos_encoding!r}")
        if cfg.hidden % cfg.num_heads:
            raise ValueError(f"hidden {cfg.hidden} is not a multiple of num_heads "
                             f"{cfg.num_heads}")


def _glorot(gen: torch.Generator, shape, device) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(device)


def _normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(device)


def init_tower(
    cfg: TowerConfig,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> Params:
    """Random tower params in the JAX checkpoint layout
    (``towers.py:195-267``): ``embed`` [V, E], ``proj_w`` [H, D],
    ``proj_b`` [D]; with the attention readout ``attn_w`` [H, H],
    ``attn_b`` [H] and ``attn_v`` [H]. Then by cell: per recurrent layer
    one fused ``w`` [(in+H), G·H] over [x; h] with ``b`` [G·H], gate order
    (z, r, n) for the GRU (G=3) and (i, f, g, o) for the LSTM (G=4); per
    transformer block ``ln1_scale/bias``, ``qkv_w`` [d, 3d], ``qkv_b``,
    ``attn_out_w/b``, ``ln2_scale/bias``, ``mlp_in_w`` [d, r·d],
    ``mlp_in_b``, ``mlp_out_w`` [r·d, d], ``mlp_out_b``, then
    ``ln_f_scale/bias`` and, for learned positions, ``pos_embed``
    [max_len, d] (std 0.02); the bag-of-subwords tower has no sequence
    params. The numbers differ from ``sse_tpu``'s init for the same seed;
    parity tests convert JAX params with ``sse_tpu_torch.convert``
    instead."""
    _check_supported(cfg)
    gen = generator if generator is not None else torch.Generator()
    p: Params = {
        "embed": _normal(gen, (cfg.vocab_size, cfg.embed_dim), 0.05, device),
        "proj_w": _glorot(gen, (cfg.hidden, cfg.encoding_dim), device),
        "proj_b": torch.zeros((cfg.encoding_dim,), device=device),
    }
    if cfg.readout == "attention":
        p["attn_w"] = _glorot(gen, (cfg.hidden, cfg.hidden), device)
        p["attn_b"] = torch.zeros((cfg.hidden,), device=device)
        p["attn_v"] = _normal(gen, (cfg.hidden,), 0.05, device)
    if cfg.cell in ("gru", "lstm"):
        n = (3 if cfg.cell == "gru" else 4) * cfg.hidden
        layers = []
        for l in range(cfg.num_layers):
            in_dim = cfg.embed_dim if l == 0 else cfg.hidden
            layers.append(
                {
                    "w": torch.cat(
                        [_glorot(gen, (in_dim, n), device),
                         _glorot(gen, (cfg.hidden, n), device)],
                        dim=0,
                    ),
                    "b": torch.zeros((n,), device=device),
                }
            )
        p["layers"] = layers
    elif cfg.cell == "transformer":
        d, r = cfg.embed_dim, cfg.mlp_ratio
        ones = lambda n: torch.ones((n,), device=device)  # noqa: E731
        zeros = lambda n: torch.zeros((n,), device=device)  # noqa: E731
        p["blocks"] = [
            {
                "ln1_scale": ones(d),
                "ln1_bias": zeros(d),
                "qkv_w": _glorot(gen, (d, 3 * d), device),
                "qkv_b": zeros(3 * d),
                "attn_out_w": _glorot(gen, (d, d), device),
                "attn_out_b": zeros(d),
                "ln2_scale": ones(d),
                "ln2_bias": zeros(d),
                "mlp_in_w": _glorot(gen, (d, r * d), device),
                "mlp_in_b": zeros(r * d),
                "mlp_out_w": _glorot(gen, (r * d, d), device),
                "mlp_out_b": zeros(d),
            }
            for _ in range(cfg.num_layers)
        ]
        p["ln_f_scale"] = ones(d)
        p["ln_f_bias"] = zeros(d)
        if cfg.pos_encoding == "learned":
            p["pos_embed"] = _normal(gen, (cfg.max_len, d), 0.02, device)
    return p


# ------------------------------------------------------------ products
def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b ([K, N], or [..., K, N] with a's leading dims) on
    bf16 operands with a float32 result, on the card's tensor cores."""
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    else:
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _TensorCoreDot(torch.autograd.Function):
    """``_dot`` on the card: both operands cast to bf16, the product summed
    in float32 on the tensor cores (``_mm_f32``). Backward rounds each
    operand's cotangent to bf16 and returns it in the operand's dtype, as
    ``bf16_matmul``'s autograd (its casts) and JAX's transposed
    ``dot_general`` do. The incoming float32 cotangent is rounded to bf16
    too, because the tensor cores take bf16 operands: the one rounding
    point where this backward differs from ``bf16_matmul``'s, which keeps
    it in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(_COMPUTE_DTYPE), b.to(_COMPUTE_DTYPE)
        ctx.save_for_backward(a16, b16)
        ctx.dtypes = a.dtype, b.dtype
        return _mm_f32(a16, b16)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(_COMPUTE_DTYPE)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g16, b16.transpose(-1, -2))
            da = da.to(_COMPUTE_DTYPE).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            if b16.dim() == 2:  # a weight: sum over every row of a
                db = _mm_f32(a16.reshape(-1, a16.shape[-1]).t(), g16.reshape(-1, g16.shape[-1]))
            else:
                db = _mm_f32(a16.transpose(-1, -2), g16)
            db = db.to(_COMPUTE_DTYPE).to(ctx.dtypes[1])
        return da, db


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tower's product, ``jnp.dot``/``einsum`` on bf16 operands with
    ``preferred_element_type=float32``: a [..., M, K] @ b ([K, N] or
    batched like a). The route is chosen by the operand's device: the bf16
    tensor cores on the card (``_TensorCoreDot``), ``bf16_matmul`` on the
    CPU."""
    return _TensorCoreDot.apply(a, b) if a.is_cuda else bf16_matmul(a, b)


# ------------------------------------------------------------ embedding
class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` with the table cotangent of ``cfg.embed_grad``
    (port of ``_embed_lookup``, ``towers.py:105-185``; see _EMBED_GRADS)."""

    @staticmethod
    def forward(ctx, table, tokens, impl):
        ctx.save_for_backward(tokens)
        ctx.impl, ctx.vocab = impl, table.shape[0]
        return table[tokens]

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        if ctx.impl == "take":
            return embed.table_grad(tokens, dy, ctx.vocab), None, None
        tok = tokens.reshape(-1)
        dy2 = dy.reshape(-1, dy.shape[-1])
        shape = (ctx.vocab, dy2.shape[1])
        if ctx.impl == "zero_debug":
            return torch.zeros(shape, dtype=dy.dtype, device=dy.device), None, None
        if ctx.impl == "take_bf16":
            dt = torch.zeros(shape, dtype=_COMPUTE_DTYPE, device=dy.device)
            return dt.index_add_(0, tok, dy2.to(_COMPUTE_DTYPE)).to(dy.dtype), None, None
        if ctx.impl == "onehot":
            dy2 = dy2.to(_COMPUTE_DTYPE).to(dy.dtype)
        dt = torch.zeros(shape, dtype=dy.dtype, device=dy.device)
        return dt.index_add_(0, tok, dy2), None, None


def _embed(table: torch.Tensor, tokens: torch.Tensor, impl: str) -> torch.Tensor:
    """[B, L] ids → [B, L, E] rows of ``table`` (``towers.py:597-600``).
    ``take`` is the gather with autograd's own backward, except where a
    table on the card takes a gradient: there its cotangent is
    ``ops.embed.table_grad``'s deterministic segmented sum."""
    if impl == "take":
        if table.is_cuda and table.requires_grad and torch.is_grad_enabled():
            return _EmbedLookup.apply(table, tokens, impl)
        return table[tokens]
    if impl == "presorted_cost" and torch.is_grad_enabled() and table.requires_grad:
        raise ValueError("embed_grad='presorted_cost' is measurement-only: its table "
                         "gradient is deliberately wrong")
    return _EmbedLookup.apply(table, tokens, impl)


# ----------------------------------------------------- transformer tower
def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim, biased variance, ``eps`` inside the
    rsqrt (``towers.py:365-368``; eps 1e-6, not F.layer_norm's 1e-5)."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _sinusoid_table(max_len: int, dim: int) -> np.ndarray:
    """[max_len, dim] float32 sinusoids, sin on even and cos on odd
    columns, computed in float64 by numpy (``towers.py:371-378``: the
    same table, bit for bit)."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2.0 * i / dim)
    table = np.zeros((max_len, dim), np.float32)
    table[:, 0::2] = np.sin(ang)
    table[:, 1::2] = np.cos(ang)
    return table


@functools.lru_cache(maxsize=None)
def _sinusoid_on(max_len: int, dim: int, device: torch.device) -> torch.Tensor:
    """``_sinusoid_table`` on ``device``, uploaded once: a step captured in
    a CUDA graph may not copy from the host."""
    return torch.from_numpy(_sinusoid_table(max_len, dim)).to(device)


def _rope_tables(positions: torch.Tensor, hd: int):
    """RoPE cos/sin tables for int ``positions`` [L] → two [L, hd/2]
    float32 tensors, 10000-base frequencies ``10000^(-2i/hd)`` in float32
    (``towers.py:381-388``)."""
    i = torch.arange(hd // 2, dtype=torch.float32, device=positions.device)
    inv_freq = torch.pow(10000.0, -2.0 * i / hd)  # [hd/2]
    ang = positions.to(torch.float32)[:, None] * inv_freq[None]  # [L, hd/2]
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate head vectors x [..., L, hd] by per-position angles, the
    rotate-half pairing (x[..., :hd/2], x[..., hd/2:]) (``towers.py:391-400``)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


@dataclasses.dataclass(frozen=True)
class SeqShards:
    """A transformer encode with its sequence split over shards (context
    parallelism, ``parallel.context``): ``offsets``, the first global
    position of each of this process's shards; ``length``, the global
    sequence length; ``gather(parts, dim)``, the local shards' tensors (a
    list in shard order, each on its shard's device) → for each local shard
    the tensor of every shard concatenated along ``dim`` in global order,
    on that shard's device."""

    offsets: Sequence[int]
    length: int
    gather: Callable[[List[torch.Tensor], int], List[torch.Tensor]]


def _transformer_encode(
    p, cfg: TowerConfig, x, valid, dot: Callable = _dot, cp: Optional[SeqShards] = None,
):
    """x [B, L, E] float32 embeddings, valid [B, L] float 0/1 → states
    [B, L, H] float32: pre-LN blocks (``towers.py:403-525``). Per block: LN,
    ``qkv = bf16(y)·bf16(W) + b``, heads [B, nh, L, hd]; RoPE rotates q and
    k in float32 before their bf16 cast (nothing is added to the residual
    stream), learned positions are added to x, sinusoids to x·√d; logits on
    bf16 operands with float32 sums, then / √hd, plus the key mask as an
    additive finfo(float32).min bias (a row of length 0 gets a uniform
    softmax and stays finite); a float32 softmax; ``bf16(attn)·bf16(v)``;
    the out-projection and the residual; LN, the MLP with the tanh GELU
    (``jax.nn.gelu``'s default), the residual; then a final LN. ``dot`` is
    the product (``_dot`` picks by device; a check on the card passes
    ``bf16_matmul``).

    With ``cp`` (the JAX tower's ``cp_axis``) ``p``, ``x`` and ``valid``
    are lists, one entry a local shard of the sequence (its params copy,
    its [B, Lc, E] chunk and [B, Lc] mask, on its device), and so is the
    result. The per-token work (LN, QKV, the MLP) runs on each chunk; K, V
    and the key-side mask are gathered in global order, so the local
    queries attend to every key; queries rotate at their global positions
    (offset + i) and the gathered keys at 0..L-1; the position tables are
    sliced at each shard's offset."""
    if cp is None:
        return _encode_shards([p], cfg, [x], [valid], dot, None)[0]
    return _encode_shards(p, cfg, x, valid, dot, cp)


def _encode_shards(ps, cfg, xs, valids, dot, cp):
    B, L, d = xs[0].shape  # L: each shard's chunk length
    nh = cfg.num_heads
    hd = d // nh
    offsets = cp.offsets if cp is not None else (0,)
    length = cp.length if cp is not None else L
    rope = cfg.pos_encoding == "rope"
    xs = list(xs)
    if rope:
        q_tabs = [_rope_tables(off + torch.arange(L, device=x.device), hd)
                  for off, x in zip(offsets, xs)]
        k_tabs = q_tabs if cp is None else [
            _rope_tables(torch.arange(length, device=x.device), hd) for x in xs]
    else:
        for i, (off, x) in enumerate(zip(offsets, xs)):
            if cfg.pos_encoding == "learned":
                table, in_scale = ps[i]["pos_embed"], 1.0
            else:
                table = _sinusoid_on(cfg.max_len, d, x.device)
                in_scale = math.sqrt(d)
            if length > table.shape[0]:
                raise ValueError(f"{length} tokens exceed the {table.shape[0]}-row position "
                                 f"table (max_len)")
            xs[i] = x * in_scale + table[off : off + L][None]
    valid_g = valids if cp is None else cp.gather(valids, 1)
    biases = [torch.where(v[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
              for v in valid_g]
    for bi in range(len(ps[0]["blocks"])):
        qs, ks, vs = [], [], []
        for i, x in enumerate(xs):
            blk = ps[i]["blocks"][bi]
            y = _layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
            qkv = dot(y, blk["qkv_w"]) + blk["qkv_b"]
            qkv = qkv.reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)  # [3, B, nh, L, hd]
            qs.append(qkv[0])
            ks.append(qkv[1])
            vs.append(qkv[2])
        if cp is not None:  # keys and values go global; queries stay local
            ks, vs = cp.gather(ks, 2), cp.gather(vs, 2)
        for i, x in enumerate(xs):
            blk = ps[i]["blocks"][bi]
            q, k, v = qs[i], ks[i], vs[i]
            if rope:
                q = _rope_rotate(q, *q_tabs[i])
                k = _rope_rotate(k, *k_tabs[i])
            logits = dot(q, k.transpose(-1, -2)) / math.sqrt(hd) + biases[i]
            attn = torch.softmax(logits, dim=-1)
            ctx = dot(attn, v).transpose(1, 2).reshape(B, L, d)
            x = x + (dot(ctx, blk["attn_out_w"]) + blk["attn_out_b"])
            y = _layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
            h = F.gelu(dot(y, blk["mlp_in_w"]) + blk["mlp_in_b"], approximate="tanh")
            xs[i] = x + (dot(h, blk["mlp_out_w"]) + blk["mlp_out_b"])
    return [_layer_norm(x, p["ln_f_scale"], p["ln_f_bias"]) for p, x in zip(ps, xs)]


# ----------------------------------------------------------- readouts
@dataclasses.dataclass(frozen=True)
class RowDraw:
    """A dropout generator for some rows of a larger batch (a data
    replica's rows on a grid): each mask is drawn for all ``rows`` rows
    from ``generator``, as the one-device step draws it, and the rows of
    ``segments`` ((first row, count) pairs, in the order of the rows
    encoded) are kept. So a replica's masks equal the one-device step's
    masks of its rows."""

    generator: torch.Generator
    rows: int
    segments: Tuple[Tuple[int, int], ...]


def _dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """Inverted dropout (scale-at-train, identity-at-eval), as
    ``towers.py:576-580``; the keep mask is drawn from ``gen`` (a
    ``torch.Generator``, or a ``RowDraw``)."""
    keep = 1.0 - rate
    if isinstance(gen, RowDraw):
        u = torch.rand((gen.rows, *x.shape[1:]), generator=gen.generator, device=x.device)
        u = torch.cat([u[a : a + n] for a, n in gen.segments])
    else:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def _masked_mean(states: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """states [B, L, H], valid [B, L] → [B, H] (``towers.py:529-532``)."""
    denom = torch.clamp(valid.sum(1, keepdim=True), min=1.0)
    return (states * valid[:, :, None]).sum(1) / denom


def _attention_readout(
    p: Params, states: torch.Tensor, valid: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """Self-attentive pooling with the pooled-summary residual
    (``towers.py:535-561``): ``score_t = v·tanh(W·h_t + b)`` (W·h_t on bf16
    operands, float32 sums), masked softmax over the valid steps, the
    weighted sum of the float32 states, plus ``residual``."""
    proj = torch.tanh(_dot(states, p["attn_w"]) + p["attn_b"])  # [B, L, H]
    scores = torch.einsum("blh,h->bl", proj, p["attn_v"])
    scores = torch.where(valid > 0, scores, torch.finfo(torch.float32).min)
    alpha = torch.softmax(scores, dim=-1)  # [B, L]
    return torch.einsum("bl,blh->bh", alpha, states) + residual


def _rnn_features(params: Params, cfg: TowerConfig, emb: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """The recurrent stack and its readout → [B, H] float32 features. Each
    layer is one ``rnn.RNNLayer`` call: the hand-written kernels on a CUDA
    device, their plain versions on the CPU."""
    xs = emb.transpose(0, 1).to(_COMPUTE_DTYPE).contiguous()  # [L, B, E]
    mask = valid.T[:, None, :].contiguous()  # [L, 1, B]
    final = None
    for li, layer in enumerate(params["layers"]):
        ys, fin = rnn.RNNLayer.apply(xs, mask, *split_weights(layer, cfg.cell), cfg.cell)
        if cfg.residual and li > 0:
            # identity skip; carry-freezing makes the stream's last step
            # each row's value at its own length (towers.py:628-637)
            final = fin + xs[-1].float()
            xs = xs + ys
        else:
            final, xs = fin, ys
    if cfg.readout == "final":
        return final  # [B, H] fp32: the state at each row's own length
    with span("tower.readout"):
        states = xs.transpose(0, 1).float()  # [B, L, H]
        if cfg.readout == "mean":
            return _masked_mean(states, valid)
        return _attention_readout(params, states, valid, final)


def encode_raw(
    params: Params,
    cfg: TowerConfig,
    tokens: torch.Tensor,  # [B, L] int
    lengths: torch.Tensor,  # [B] int
    dropout_generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Token ids → L2-normalized [B, encoding_dim] float32 embeddings
    (``towers.py:583-676``): ``project(encode_features(...))``. Recurrent
    towers read out the final state, the masked mean or the attention
    readout; the bag-of-subwords tower (its embeddings are its states) and
    the transformer read out the masked mean, or the attention readout
    with the masked mean as its residual. Then the tanh projection and the
    L2 norm.

    ``dropout_generator`` (a ``torch.Generator`` on the tokens' device,
    or a ``RowDraw`` of one) turns on ``cfg.dropout`` on the embeddings
    and on the readout features (training only); None, what eval and
    serving pass, keeps the forward deterministic."""
    return project(params, encode_features(params, cfg, tokens, lengths, dropout_generator))


def encode_features(
    params: Params,
    cfg: TowerConfig,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    dropout_generator=None,
) -> torch.Tensor:
    """``encode_raw`` up to the projection: the readout's [B, H] float32
    features, after the train-time dropout."""
    _check_supported(cfg)
    train = dropout_generator is not None and cfg.dropout > 0.0
    L = tokens.shape[1]
    with span("tower.embed"):
        emb = _embed(params["embed"], tokens.long(), cfg.embed_grad)  # [B, L, E] fp32
        if train:
            emb = _dropout(emb, cfg.dropout, dropout_generator)
    pos = torch.arange(L, device=tokens.device)[None, :]
    valid = (pos < lengths[:, None]).float()  # [B, L]
    if cfg.cell in ("gru", "lstm"):
        feats = _rnn_features(params, cfg, emb, valid)
    else:
        states = emb
        if cfg.cell == "transformer":
            with span("tower.transformer"):
                states = _transformer_encode(params, cfg, emb, valid)
        with span("tower.readout"):
            feats = _masked_mean(states, valid)
            if cfg.readout == "attention":
                feats = _attention_readout(params, states, valid, feats)
    if train:
        feats = _dropout(feats, cfg.dropout, dropout_generator)
    return feats


# the params that project the readout's features (``project``)
PROJECTION = ("proj_b", "proj_w")


def project(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """The tanh projection of [B, H] features and the L2 norm → [B,
    encoding_dim] float32."""
    out = torch.tanh(_dot(feats, params["proj_w"]) + params["proj_b"])
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-6)


__all__ = [
    "PROJECTION",
    "RowDraw",
    "SeqShards",
    "TowerConfig",
    "encode_features",
    "encode_raw",
    "gru_cell",
    "init_tower",
    "lstm_cell",
    "project",
]
