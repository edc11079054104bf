"""Exact top-k of q·embᵀ without a [B, T] score matrix (port of
``sse_tpu/ops/fused_topk.py``).

Selection contract of the packed variant, which both entry points keep:

* float index: key = ``to_sortable(score) & ~0xFFF`` (11 mantissa bits);
  value = ``from_sortable(key)``;
* int8 index: float queries are 127-scale quantized, scores are exact
  int32 sums, key = ``clip(score, ±(2^18-1)) << 12``; value = score/127²;
* order: key descending, then global row ascending;
* rows at or past the runtime ``num_real`` are never chosen; with fewer
  real rows than k the remaining slots hold a finite sink value (< -1e37)
  with row 0.

Both orders ride one signed int64 composite, ``key << 32 | (0xFFFFFFFF -
row)``: one max picks (key desc, row asc), and the plain versions get the
contract's tie order from ``torch.topk`` over the composites.

``fused_score_topk`` (streaming, ``csrc/topk_stream.cu``) and
``fused_score_topk_twophase`` (``csrc/topk_twophase.cu``, phase 1 and
phase 2; the mid-pass and the merge are plain torch, as the JAX package
does them in plain XLA) launch the Hopper kernels on CUDA tensors or raise,
and run their plain PyTorch versions on CPU tensors. ``topk_reference``
and the ``*_reference`` phase functions are the plain versions; they run
on either device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from sse_tpu_torch.ops import _build

NEG = -3.0e38
_INT8_INV = 1.0 / (127 * 127)
_IDX_MASK = 4095
_INT_MIN = -(2**31)
_b = np.asarray(NEG, np.float32).view(np.int32)
_NEG_SINK = int((_b ^ ((_b >> 31) & np.int32(0x7FFFFFFF))) & ~np.int32(_IDX_MASK))
_INT_SCORE_CLIP = (1 << 18) - 1
_INT_SINK = -(1 << 30)
_EMPTY = -(2**63)  # composite of an empty slot
_LOW32 = 0xFFFFFFFF

# Carried over from the JAX package's routing (fused_topk.py:586 and
# engine.py:168-199), NOT yet measured on the H100: batches of at least
# TWOPHASE_MIN_BATCH go to the two-phase kernels, smaller ones to one
# streaming launch. TWOPHASE_BLOCK_T is the port's own index block size.
TWOPHASE_MIN_BATCH = 1024
TWOPHASE_BLOCK_T = 2048
PAIR_TILE = 64  # queries per phase-2 tile (the kernel's block of 4 warps)
_TILE_ROWS = 64  # index rows per kernel step
_REF_ELEMS = 1 << 26  # score elements per chunk of the plain versions

# Launches of each CUDA kernel wrapper (incremented only where it launches).
launches = {"topk_stream": 0, "twophase_p1": 0, "twophase_p2": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# ------------------------------------------------------------ key helpers
def to_sortable(f32: torch.Tensor) -> torch.Tensor:
    """float32 → int32 whose signed order is the float order."""
    bits = f32.to(torch.float32).contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def from_sortable(key: torch.Tensor) -> torch.Tensor:
    bits = key ^ ((key >> 31) & 0x7FFFFFFF)
    return bits.contiguous().view(torch.float32)


def enc_key(scores: torch.Tensor, int_exact: bool) -> torch.Tensor:
    """Sortable int32 selection key with the low 12 bits cleared."""
    if int_exact:
        s = torch.clamp(scores.to(torch.int32), -_INT_SCORE_CLIP, _INT_SCORE_CLIP)
        return s * (1 << 12)
    return to_sortable(scores) & ~_IDX_MASK


def dec_val(key: torch.Tensor, int_exact: bool) -> torch.Tensor:
    """Cosine-range float32 value of a cleared key; sinks decode finite."""
    if int_exact:
        inv = torch.tensor(_INT8_INV, dtype=torch.float32, device=key.device)
        v = (key >> 12).to(torch.float32) * inv
        neg = torch.tensor(NEG, dtype=torch.float32, device=key.device)
        return torch.where(key == _INT_SINK, neg, v)
    return from_sortable(key)


def quantize_queries_int8(q: torch.Tensor) -> torch.Tensor:
    """Symmetric 127-scale int8 quantization (round half to even)."""
    return torch.clamp(torch.round(q.to(torch.float32) * 127.0), -127, 127).to(torch.int8)


def _prep_queries(q: torch.Tensor, emb: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    if emb.dtype == torch.int8:
        return (q if q.dtype == torch.int8 else quantize_queries_int8(q)), True
    return q.to(emb.dtype), False


def _scores(q: torch.Tensor, emb: torch.Tensor, int_exact: bool) -> torch.Tensor:
    """Plain q·embᵀ: exact int32 sums for int8 (through float64, which
    holds them exactly), float32 sums of the stored operands otherwise."""
    if int_exact:
        return torch.round(q.double() @ emb.double().T).to(torch.int32)
    return q.float() @ emb.float().T


def _composite(key: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return key.to(torch.int64) * (1 << 32) + (_LOW32 - rows.to(torch.int64))


def decode(comp: torch.Tensor, int_exact: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composites → (float32 values, int32 rows); empty slots → sinks."""
    empty = comp == _EMPTY
    key = (comp >> 32).to(torch.int32)
    key = torch.where(empty, _INT_SINK if int_exact else _NEG_SINK, key)
    rows = (_LOW32 - (comp & _LOW32)).to(torch.int32)
    return dec_val(key, int_exact), torch.where(empty, 0, rows)


def _topk_desc(comp: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest composites along the last dim, best first (pads
    with empty slots when the dim is shorter than k)."""
    n = comp.shape[-1]
    if n < k:
        pad = comp.new_full(comp.shape[:-1] + (k - n,), _EMPTY)
        comp = torch.cat([comp, pad], dim=-1)
    return torch.topk(comp, k, dim=-1, sorted=True).values


def _query_chunk(t: int) -> int:
    return max(1, _REF_ELEMS // max(t, 1))


# ------------------------------------------------------- plain reference
def topk_reference(
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of both kernels' contract, on any device:
    all scores in float32 (exact int32 on int8), the composite key, and
    ``torch.topk``. Chunked over queries, so it never holds more than
    ~64M scores at once."""
    q, int_exact = _prep_queries(q, emb)
    t = emb.shape[0]
    nr = max(0, min(int(num_real), t))
    low = torch.arange(t, device=emb.device)
    out = []
    for lo in range(0, q.shape[0], _query_chunk(t)):
        key = enc_key(_scores(q[lo : lo + _query_chunk(t)], emb, int_exact), int_exact)
        comp = _composite(key, low)
        comp[:, nr:] = _EMPTY
        out.append(_topk_desc(comp, k))
    if not out:
        comp = torch.empty((0, k), dtype=torch.int64, device=emb.device)
    else:
        comp = torch.cat(out)
    return decode(comp, int_exact)


# ------------------------------------------------------------ CUDA glue
_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_cuda(q: torch.Tensor, emb: torch.Tensor, k: int, name: str) -> None:
    if not (q.is_cuda and q.device == emb.device):
        raise ValueError(f"{name}: q and emb must be on one CUDA device")
    if emb.dim() != 2 or q.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"{name}: q [B, D] and emb [T, D] expected, got {tuple(q.shape)} and {tuple(emb.shape)}")
    if emb.dtype not in _DTYPE_CODE or q.dtype != emb.dtype:
        raise ValueError(f"{name}: emb must be float32, bfloat16 or int8, q of the same type")
    if not (q.is_contiguous() and emb.is_contiguous()):
        raise ValueError(f"{name}: q and emb must be contiguous")
    row_bytes = emb.shape[1] * emb.element_size()
    if emb.dtype != torch.float32 and row_bytes not in (128, 256):
        raise ValueError(f"{name}: bf16/int8 rows must be 128 or 256 bytes, got {row_bytes}")
    if not 0 <= k <= 128:
        raise ValueError(f"{name}: needs k <= 128, got {k}")


def _queries_per_block(b: int) -> int:
    """Query-tile width of the streaming and phase-1 kernels: 16 for the
    interactive tier (B <= 16), 64 otherwise (not tuned on the H100)."""
    return 16 if b <= 16 else 64


def _split(n: int, b: int, qb: int, device: torch.device) -> Tuple[int, int]:
    """Cut n units (64-row tiles or index blocks) into (units per block,
    number of parts) so that the grid holds ~4 blocks per SM."""
    qtiles = max(1, -(-b // qb))
    want = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-n // max(1, min(n, -(-want // qtiles))))
    return per, -(-n // per)


def _select(comp: torch.Tensor, k: int, mode: int):
    """CUDA warp select of the k best composites per row (see
    topk_stream.cu: mode 0 composites, 1/2 decoded float/int8)."""
    r, n = comp.shape
    dev = comp.device
    out = torch.empty((r, k), dtype=torch.int64, device=dev) if mode == 0 else None
    vals = torch.empty((r, k), dtype=torch.float32, device=dev) if mode else None
    rows = torch.empty((r, k), dtype=torch.int32, device=dev) if mode else None
    _build.launch(
        "sse_topk_select", [_P, _I, _I, _I, _I, _P, _P, _P], dev,
        comp.data_ptr(), r, n, k, mode,
        out.data_ptr() if out is not None else None,
        vals.data_ptr() if vals is not None else None,
        rows.data_ptr() if rows is not None else None,
    )
    return out if mode == 0 else (vals, rows)


# ------------------------------------------------------------- streaming
def fused_score_topk(
    q: torch.Tensor,  # [B, D] queries
    emb: torch.Tensor,  # [T_pad, D] index rows: float32, bfloat16 or int8
    k: int,
    num_real: int,  # rows >= num_real are padding
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (float32 values [B, k], int32 rows [B, k]) of q·embᵀ: one
    streaming kernel launch plus the split merge on CUDA tensors, the plain
    version on CPU tensors."""
    if not emb.is_cuda:
        return topk_reference(q, emb, k, num_real)
    q, int_exact = _prep_queries(q, emb)
    q = q.contiguous()
    _check_cuda(q, emb, k, "fused_score_topk")
    b, d = q.shape
    t = emb.shape[0]
    nr = max(0, min(int(num_real), t))
    if b == 0 or k == 0:
        return decode(torch.empty((b, k), dtype=torch.int64, device=emb.device), int_exact)
    qb = _queries_per_block(b)
    tiles_per_split, splits = _split(max(1, -(-t // _TILE_ROWS)), b, qb, emb.device)
    partial = torch.empty((b, splits, k), dtype=torch.int64, device=emb.device)
    _build.launch(
        "sse_topk_stream", [_P, _P] + [_I] * 9 + [_P], emb.device,
        q.data_ptr(), emb.data_ptr(), _DTYPE_CODE[emb.dtype], b, t, d, nr, k,
        qb, splits, tiles_per_split * _TILE_ROWS, partial.data_ptr(),
    )
    launches["topk_stream"] += 1
    return _select(partial.reshape(b, splits * k), k, 2 if int_exact else 1)


# ------------------------------------------------------------- two-phase
def twophase_block_t(t_pad: int, k: int) -> Optional[int]:
    """The port's two-phase block size for this index, or None when the
    index is too small for it (the engine then streams)."""
    bt = TWOPHASE_BLOCK_T
    return bt if t_pad % bt == 0 and k <= t_pad // bt else None


def twophase_phase1_reference(
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int, block_t: int
) -> torch.Tensor:
    """Plain phase 1: per query the k best composites
    ``key(block max) << 32 | (0xFFFFFFFF - block)`` (ties to the earlier
    block); blocks with no real row are empty. q is already in emb's
    type (int8-quantized for an int8 index)."""
    int_exact = emb.dtype == torch.int8
    t = emb.shape[0]
    nblocks = t // block_t
    nr = max(0, min(int(num_real), t))
    blk_low = _LOW32 - torch.arange(nblocks, device=emb.device, dtype=torch.int64)
    out = []
    for lo in range(0, q.shape[0], _query_chunk(t)):
        key = enc_key(_scores(q[lo : lo + _query_chunk(t)], emb, int_exact), int_exact)
        key[:, nr:] = _INT_MIN
        bmax = key.view(key.shape[0], nblocks, block_t).amax(dim=2).to(torch.int64)
        comp = torch.where(bmax == _INT_MIN, _EMPTY, bmax * (1 << 32) + blk_low)
        out.append(_topk_desc(comp, k))
    if not out:
        return torch.empty((0, k), dtype=torch.int64, device=emb.device)
    return torch.cat(out)


def twophase_phase1(
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int, block_t: int
) -> torch.Tensor:
    """Phase 1 [B, k] int64: the block-max kernel plus the warp select on
    CUDA tensors, the plain version on CPU tensors."""
    if not emb.is_cuda:
        return twophase_phase1_reference(q, emb, k, num_real, block_t)
    _check_cuda(q, emb, k, "twophase_phase1")
    if block_t % _TILE_ROWS:
        raise ValueError(f"twophase_phase1: block_t must be a multiple of {_TILE_ROWS}")
    b, d = q.shape
    t = emb.shape[0]
    nblocks = t // block_t
    nr = max(0, min(int(num_real), t))
    qb = _queries_per_block(b)
    blocks_per_cta, _ = _split(nblocks, b, qb, emb.device)
    bkeys = torch.empty((b, nblocks), dtype=torch.int64, device=emb.device)
    _build.launch(
        "sse_twophase_blockmax", [_P, _P] + [_I] * 9 + [_P], emb.device,
        q.data_ptr(), emb.data_ptr(), _DTYPE_CODE[emb.dtype], b, t, d, nr,
        block_t, nblocks, qb, blocks_per_cta, bkeys.data_ptr(),
    )
    launches["twophase_p1"] += 1
    return _select(bkeys, k, 0)


def pair_schedule(bkeys: torch.Tensor, nblocks: int):
    """The mid-pass (plain torch, no host sync): the B·k (query, block)
    pairs grouped by block into tiles of PAIR_TILE queries. Returns
    (tile_query int32 [ntile·PAIR_TILE], tile_block int32 [ntile], pos
    int64 [B·k]: each pair's row in the phase-2 output, -1 for an empty
    pair). ntile is a static bound; spare tiles have block -1."""
    b, k = bkeys.shape
    dev = bkeys.device
    p = b * k
    flat = bkeys.reshape(p)
    valid = flat != _EMPTY
    blk = torch.where(valid, _LOW32 - (flat & _LOW32), nblocks)
    qrow = torch.arange(b, device=dev).repeat_interleave(k)
    order = torch.argsort(blk, stable=True)
    sblk = blk[order]
    srow = qrow[order]
    counts = torch.bincount(sblk, minlength=nblocks + 1)[:nblocks]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    tile_base = torch.cat([zero, torch.cumsum((counts + PAIR_TILE - 1) // PAIR_TILE, 0)])
    start = torch.cat([zero, torch.cumsum(counts, 0)])
    in_range = sblk < nblocks
    sb = torch.clamp(sblk, max=nblocks - 1)
    rank = torch.arange(p, device=dev) - start[sb]
    tile = tile_base[sb] + rank // PAIR_TILE
    ntile = min(nblocks, p) + -(-p // PAIR_TILE)
    spos = torch.where(in_range, tile * PAIR_TILE + rank % PAIR_TILE, -1)
    # out-of-range pairs scatter into one spare slot, dropped afterwards
    tile_query = torch.full((ntile * PAIR_TILE + 1,), -1, dtype=torch.int32, device=dev)
    tile_query[torch.where(in_range, spos, ntile * PAIR_TILE)] = srow.to(torch.int32)
    tile_block = torch.full((ntile + 1,), -1, dtype=torch.int32, device=dev)
    tile_block[torch.where(in_range, tile, ntile)] = sb.to(torch.int32)
    pos = torch.empty(p, dtype=torch.int64, device=dev)
    pos[order] = spos
    tile_query[-1] = -1
    tile_block[-1] = -1
    return tile_query[:-1].contiguous(), tile_block[:-1].contiguous(), pos


def twophase_phase2_reference(
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int, block_t: int,
    tile_query: torch.Tensor, tile_block: torch.Tensor,
) -> torch.Tensor:
    """Plain phase 2 [ntile·PAIR_TILE, k] int64: each scheduled pair's
    block-local top-k composites, empty past num_real and for empty
    pairs."""
    int_exact = emb.dtype == torch.int8
    t, d = emb.shape
    nblocks = t // block_t
    nr = max(0, min(int(num_real), t))
    ntile = tile_block.shape[0]
    blocks = emb[: nblocks * block_t].view(nblocks, block_t, d)
    tq_all = tile_query.view(ntile, PAIR_TILE).long()
    col = torch.arange(block_t, device=emb.device)
    step = max(1, _REF_ELEMS // (PAIR_TILE * block_t))
    out = []
    for lo in range(0, ntile, step):
        tb = tile_block[lo : lo + step].long()
        tq = tq_all[lo : lo + step]
        eb = blocks[tb.clamp(min=0)]  # [n, bt, D]
        qg = q[tq.clamp(min=0)]  # [n, 64, D]
        if int_exact:
            s = torch.round(torch.bmm(qg.double(), eb.double().transpose(1, 2))).to(torch.int32)
        else:
            s = torch.bmm(qg.float(), eb.float().transpose(1, 2))
        grow = tb.clamp(min=0)[:, None] * block_t + col  # [n, bt]
        comp = _composite(enc_key(s, int_exact), grow[:, None, :])
        ok = (grow < nr)[:, None, :] & (tb >= 0)[:, None, None] & (tq >= 0)[:, :, None]
        out.append(_topk_desc(torch.where(ok, comp, _EMPTY), k).reshape(-1, k))
    if not out:
        return torch.empty((0, k), dtype=torch.int64, device=emb.device)
    return torch.cat(out)


def twophase_phase2(
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int, block_t: int,
    tile_query: torch.Tensor, tile_block: torch.Tensor,
) -> torch.Tensor:
    """Phase 2: the pair kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not emb.is_cuda:
        return twophase_phase2_reference(
            q, emb, k, num_real, block_t, tile_query, tile_block
        )
    _check_cuda(q, emb, k, "twophase_phase2")
    for name, x in (("tile_query", tile_query), ("tile_block", tile_block)):
        if not (x.device == emb.device and x.dtype == torch.int32 and x.is_contiguous()):
            raise ValueError(f"twophase_phase2: {name} must be contiguous int32 on {emb.device}")
    b, d = q.shape
    t = emb.shape[0]
    ntile = tile_block.shape[0]
    if tile_query.shape[0] != ntile * PAIR_TILE:
        raise ValueError("twophase_phase2: tile_query must hold PAIR_TILE ids per tile")
    nr = max(0, min(int(num_real), t))
    out = torch.empty((ntile * PAIR_TILE, k), dtype=torch.int64, device=emb.device)
    _build.launch(
        "sse_twophase_pairs", [_P, _P] + [_I] * 7 + [_P, _P, _I, _P], emb.device,
        q.data_ptr(), emb.data_ptr(), _DTYPE_CODE[emb.dtype], b, t, d, nr,
        block_t, ntile, tile_query.data_ptr(), tile_block.data_ptr(), k,
        out.data_ptr(),
    )
    launches["twophase_p2"] += 1
    return out


def fused_score_topk_twophase(
    q: torch.Tensor,  # [B, D] queries
    emb: torch.Tensor,  # [T_pad, D], T_pad % block_t == 0
    k: int,
    num_real: int,
    block_t: int = TWOPHASE_BLOCK_T,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the two-phase block-max algorithm: selection
    identical to ``fused_score_topk``. Needs k <= nblocks = T_pad/block_t.
    Phase 1 and phase 2 are kernels on CUDA tensors (plain versions on
    CPU tensors); the mid-pass and the merge are plain torch."""
    t_pad = emb.shape[0]
    if t_pad % block_t:
        raise ValueError(f"T_pad {t_pad} not a multiple of block_t {block_t}")
    nblocks = t_pad // block_t
    if k > nblocks:
        raise ValueError(f"twophase needs k <= nblocks ({k} > {nblocks})")
    q, int_exact = _prep_queries(q, emb)
    q = q.contiguous()
    b = q.shape[0]
    if b == 0 or k == 0:
        return decode(torch.empty((b, k), dtype=torch.int64, device=emb.device), int_exact)
    bkeys = twophase_phase1(q, emb, k, num_real, block_t)
    tile_query, tile_block, pos = pair_schedule(bkeys, nblocks)
    cand = twophase_phase2(q, emb, k, num_real, block_t, tile_query, tile_block)
    # merge: each query's k pairs x k candidates, contract order
    got = cand[pos.clamp(min=0)]
    got = torch.where((pos >= 0)[:, None], got, _EMPTY)
    return decode(_topk_desc(got.view(b, k * k), k), int_exact)


__all__ = [
    "NEG",
    "PAIR_TILE",
    "TWOPHASE_BLOCK_T",
    "TWOPHASE_MIN_BATCH",
    "dec_val",
    "decode",
    "enc_key",
    "from_sortable",
    "fused_score_topk",
    "fused_score_topk_twophase",
    "launches",
    "pair_schedule",
    "quantize_queries_int8",
    "to_sortable",
    "topk_reference",
    "twophase_block_t",
    "twophase_phase1",
    "twophase_phase1_reference",
    "twophase_phase2",
    "twophase_phase2_reference",
]
