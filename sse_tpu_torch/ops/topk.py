"""Exact top-k of q·embᵀ without a [B, T] score matrix (port of
``sse_tpu/ops/fused_topk.py``).

Selection contract of the packed variant (``variant="packed"``, the
default), which both entry points keep:

* float index: key = ``to_sortable(score) & ~0xFFF`` (11 mantissa bits);
  value = ``from_sortable(key)``;
* int8 index: float queries are 127-scale quantized, scores are exact
  int32 sums, key = ``clip(score, ±(2^18-1)) << 12``; value = score/127²;
* order: key descending, then global row ascending;
* rows at or past the runtime ``num_real`` are never chosen; with fewer
  real rows than k the remaining slots hold a finite sink value (< -1e37)
  with row 0.

``num_real`` is an int or a 0-d int32 tensor on the index's card. The
kernels read it from device memory (an int becomes one filled 0-d
tensor, no host copy), so a CUDA graph that captured a call serves a
growing index: its replays read the count from the buffer it captured.
The plain versions take an int (or a tensor, which they read).

The exact variant (``variant="exact"``, streaming only; the JAX
``_kernel`` + ``_topk_passes``) selects on the full-precision float32
scores: key = ``to_sortable(score + 0.0)`` with no bits cleared (``+ 0.0``
maps -0.0 to +0.0, a tie to the lower row as JAX's ``scores == max``
treats it); for int8 the score is ``float(int32 sum) * float32(1/127²)``
with 127-quantized queries. Values are those scores; with fewer real rows
than k the remaining slots hold exactly ``float32(-3e38)`` with row 0.

Both orders ride one signed int64 composite, ``key << 32 | (0xFFFFFFFF -
row)``: one max picks (key desc, row asc), and the plain versions get the
contract's tie order from ``torch.topk`` over the composites.

``fused_score_topk`` (streaming, either variant, ``csrc/topk_stream.cu``:
bf16 and int8 indexes on the wgmma kernel shaped by ``_stream_plan``,
float32 on the FMA kernel) and
``fused_score_topk_twophase`` (``csrc/topk_twophase.cu``, phase 1 and
phase 2; the mid-pass and the merge are plain torch, as the JAX package
does them in plain XLA) launch the Hopper kernels on CUDA tensors or raise,
and run their plain PyTorch versions on CPU tensors. ``topk_reference``
and the ``*_reference`` phase functions are the plain versions; they run
on either device.
"""

from __future__ import annotations

import ctypes
from collections import Counter
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
_SCORE_TILE = 128  # index rows per wgmma score tile (csrc/topk_tile.cuh)
_MAX_BLOCK_T = 4096
_REF_ELEMS = 1 << 26  # score elements per chunk of the plain versions
# the streaming kernel's shared memory (csrc/topk_stream.cu stream_smem)
_SMEM_MAX = 232_448  # bytes a block may use on the H100
_MAX_CAP = 256  # candidate-list entries a query

# Launches of each CUDA kernel wrapper by batch size, (name, B) → count,
# incremented only where the wrapper launches its kernel.
KERNELS = ("topk_stream", "topk_exact", "twophase_p1", "twophase_p2")
launches: Counter = Counter()


def launch_total(name: str) -> int:
    """Launches of kernel ``name`` at every batch size."""
    return sum(n for (kernel, _), n in launches.items() if kernel == name)
VARIANTS = ("packed", "exact")

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
        # Python scalars, as jnp's weak types: float32 arithmetic, and no
        # host-to-device copy (which would sync the stream)
        v = (key >> 12).to(torch.float32) * _INT8_INV
        return torch.where(key == _INT_SINK, NEG, v)
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


def _exact_scores(q: torch.Tensor, emb: torch.Tensor, int_exact: bool) -> torch.Tensor:
    """The exact variant's float32 scores (``_block_scores``): int8 sums
    times float32(1/127²), float32 sums otherwise; -0.0 becomes +0.0."""
    s = _scores(q, emb, int_exact)
    if int_exact:
        s = s.to(torch.float32) * torch.tensor(_INT8_INV, dtype=torch.float32, device=s.device)
    return torch.where(s == 0, torch.zeros((), dtype=s.dtype, device=s.device), s)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def _composite(key: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return key.to(torch.int64) * (1 << 32) + (_LOW32 - rows.to(torch.int64))


def decode(
    comp: torch.Tensor, int_exact: bool, exact: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composites → (float32 values, int32 rows); empty slots → sinks
    (row 0; the exact variant's sink value is float32(-3e38))."""
    empty = comp == _EMPTY
    key = (comp >> 32).to(torch.int32)
    rows = torch.where(empty, 0, (_LOW32 - (comp & _LOW32)).to(torch.int32))
    if exact:
        neg = torch.full((), NEG, dtype=torch.float32, device=comp.device)  # no host copy
        return torch.where(empty, neg, from_sortable(key)), rows
    key = torch.where(empty, _INT_SINK if int_exact else _NEG_SINK, key)
    return dec_val(key, int_exact), rows


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
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int, variant: str = "packed"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernels' contract, on any device:
    all scores in float32 (exact int32 on int8), the variant's composite
    key (packed: low 12 bits cleared; exact: the full key of the float32
    score), and ``torch.topk``. Chunked over queries, so it never holds
    more than ~64M scores at once."""
    comp = reference_composites(q, emb, k, num_real, variant)
    return decode(comp, emb.dtype == torch.int8, variant == "exact")


def reference_composites(
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real: int, variant: str = "packed"
) -> torch.Tensor:
    """``topk_reference`` before the decode: int64 [B, k] composites, best
    first, empty slots ``_EMPTY``."""
    _check_variant(variant)
    exact = variant == "exact"
    q, int_exact = _prep_queries(q, emb)
    t = emb.shape[0]
    nr = max(0, min(int(num_real), t))
    low = torch.arange(t, device=emb.device)
    out = []
    for lo in range(0, q.shape[0], _query_chunk(t)):
        qc = q[lo : lo + _query_chunk(t)]
        if exact:
            key = to_sortable(_exact_scores(qc, emb, int_exact))
        else:
            key = enc_key(_scores(qc, emb, int_exact), int_exact)
        comp = _composite(key, low)
        comp[:, nr:] = _EMPTY
        out.append(_topk_desc(comp, k))
    if not out:
        return torch.empty((0, k), dtype=torch.int64, device=emb.device)
    return torch.cat(out)


def rows_off_reference(
    q: torch.Tensor, emb: torch.Tensor, rows: torch.Tensor, num_real: int,
    variant: str = "packed",
) -> Tuple[int, list]:
    """Top-k ``rows`` [B, k] of the queries ``q`` held against
    ``topk_reference`` on the same inputs. The kernels and the reference
    sum in different orders, so on a float index a differing position is
    allowed where the two rows' scores lie within one key bucket (2^-11
    relative; packed variant) or within 2e-6 (exact variant, full float32
    keys); on an int8 index the sums are exact and none is allowed.
    Returns (the count of differing positions, those beyond the tolerance
    as (i, j, score of rows[i, j], score of the reference's row), the
    scores None on int8)."""
    _, ref = topk_reference(q, emb, rows.shape[1], num_real, variant)
    diff = (rows != ref).nonzero().tolist()
    if emb.dtype == torch.int8:
        return len(diff), [(i, j, None, None) for i, j in diff]
    qd = q.to(emb.dtype).double()
    bad = []
    for i, j in diff:
        a = float(qd[i] @ emb[rows[i, j]].double())
        b = float(qd[i] @ emb[ref[i, j]].double())
        if abs(a - b) > (2e-6 if variant == "exact" else 2.0**-11 * max(abs(a), abs(b))):
            bad.append((i, j, a, b))
    return len(diff), bad


# ------------------------------------------------------------ CUDA glue
_P, _I = ctypes.c_void_p, ctypes.c_int


def _num_real_on(num_real, emb: torch.Tensor, name: str) -> torch.Tensor:
    """``num_real`` as the kernels read it, one int32 in the index's
    device memory: a 0-d int32 tensor on the index's card as it is (the
    kernels clamp it to [0, T]), an int clamped to [0, T] and filled into
    a new 0-d tensor (one fill kernel, no host copy)."""
    if torch.is_tensor(num_real):
        if num_real.dim() or num_real.dtype != torch.int32 or num_real.device != emb.device:
            raise ValueError(f"{name}: num_real must be an int or a 0-d int32 tensor on "
                             f"{emb.device}, got {num_real.dtype} {tuple(num_real.shape)} on "
                             f"{num_real.device}")
        return num_real
    nr = max(0, min(int(num_real), emb.shape[0]))
    return torch.full((), nr, dtype=torch.int32, device=emb.device)


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
    if emb.dtype != torch.float32 and row_bytes not in (64, 128, 256):
        raise ValueError(f"{name}: bf16/int8 rows must be 64, 128 or 256 bytes, got {row_bytes}")
    if not 0 <= k <= 128:
        raise ValueError(f"{name}: needs k <= 128, got {k}")


def _queries_per_block(b: int) -> int:
    """Query-tile width of the float32 streaming and phase-1 kernels: 16
    for the interactive tier (B <= 16), 64 otherwise (not tuned on the
    H100)."""
    return 16 if b <= 16 else 64


def _split(n: int, b: int, qb: int, device: torch.device) -> Tuple[int, int]:
    """Cut n units (64-row tiles or index blocks) into (units per block,
    number of parts) so that the grid holds ~4 blocks per SM."""
    qtiles = max(1, -(-b // qb))
    want = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-n // max(1, min(n, -(-want // qtiles))))
    return per, -(-n // per)


def _stream_smem(row_bytes: int, groups: int, stages: int, cap: int, rows: int) -> int:
    """Dynamic shared memory of the streaming kernel: alignment slack, the
    64·groups queries, the ring of 128-row tiles, the candidate lists of
    ``rows`` queries (8-byte entries, both variants) and the mbarriers."""
    return (1024 + 64 * groups * row_bytes + stages * _SCORE_TILE * row_bytes
            + rows * cap * 8 + 2 * stages * 8)


def _stream_plan(row_bytes: int, k: int, b: int, rows: int, sms: int) -> dict:
    """The bf16 / int8 streaming kernel's shape for B=b queries over an
    index of ``rows`` rows (T: the kernel reads num_real on the device, and
    the CTAs of splits past it exit at once) on ``sms`` SMs:

    * ``groups``: consumer warpgroups of 64 queries a CTA sharing each
      index tile (2 above B=64, where the lists leave room);
    * ``stages``: 128-row tiles in the TMA ring: 4 down to 2 for one
      group (small batches are bound by the bytes in flight), 2 for two
      (the selection bounds them; the room goes to the lists, whose
      merges it makes rarer);
    * ``cap``: candidate-list entries a query, a multiple of 32 and at
      least k + 64 (after a merge half a tile fits); lists exist for
      min(64·groups, B) queries a CTA;
    * ``splits``: each CTA walks tiles split, split + splits, ...; about
      one CTA an SM, never more splits than tiles;
    * ``smem``: the dynamic shared memory, at most _SMEM_MAX.
    """
    tiles = -(-rows // _SCORE_TILE)
    for groups in (2, 1) if b > 64 else (1,):
        lists = min(64 * groups, b)
        for stages in (2,) if groups == 2 else (4, 3, 2):
            free = _SMEM_MAX - _stream_smem(row_bytes, groups, stages, 0, lists)
            cap = min(_MAX_CAP, free // (lists * 8) // 32 * 32)
            if cap >= k + _SCORE_TILE // 2:
                nqg = -(-b // (64 * groups))
                splits = max(1, min(tiles, sms // nqg))
                return dict(groups=groups, stages=stages, cap=cap, splits=splits,
                            smem=_stream_smem(row_bytes, groups, stages, cap, lists))
    raise ValueError(f"no streaming plan for {row_bytes}-byte rows and k={k}")


def _select(comp: torch.Tensor, k: int, mode: int):
    """CUDA warp select of the k best composites per row (see
    topk_stream.cu: mode 0 composites, 1/2 decoded float/int8 packed
    keys, 3 decoded exact keys)."""
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
    num_real,  # rows >= num_real are padding: an int or a 0-d int32 tensor
    variant: str = "packed",  # packed | exact (see the module doc)
    composites: bool = False,
):
    """Top-k (float32 values [B, k], int32 rows [B, k]) of q·embᵀ: one
    streaming kernel launch plus the split merge on CUDA tensors (counter
    ``topk_stream``, or ``topk_exact`` for the exact variant), the plain
    version on CPU tensors. ``composites=True`` returns the int64 [B, k]
    composites instead (best first, empty slots ``_EMPTY``), which
    ``decode`` turns into the values and rows: what a cross-shard merge
    (``sse_tpu_torch.parallel.topk``) takes."""
    _check_variant(variant)
    if not emb.is_cuda:
        if composites:
            return reference_composites(q, emb, k, num_real, variant)
        return topk_reference(q, emb, k, num_real, variant)
    exact = variant == "exact"
    q, int_exact = _prep_queries(q, emb)
    q = q.contiguous()
    _check_cuda(q, emb, k, "fused_score_topk")
    b, d = q.shape
    t = emb.shape[0]
    if b == 0 or k == 0:
        empty = torch.empty((b, k), dtype=torch.int64, device=emb.device)
        return empty if composites else decode(empty, int_exact, exact)
    nr = _num_real_on(num_real, emb, "fused_score_topk")
    if emb.dtype == torch.float32:
        qb = _queries_per_block(b)
        tiles_per_split, splits = _split(max(1, -(-t // _TILE_ROWS)), b, qb, emb.device)
        partial = torch.empty((b, splits, k), dtype=torch.int64, device=emb.device)
        _build.launch(
            "sse_topk_stream_f32", [_P, _P, _I, _I, _I, _P] + [_I] * 5 + [_P], emb.device,
            q.data_ptr(), emb.data_ptr(), b, t, d, nr.data_ptr(), k, int(exact), qb, splits,
            tiles_per_split * _TILE_ROWS, partial.data_ptr(),
        )
    else:
        sms = torch.cuda.get_device_properties(emb.device).multi_processor_count
        plan = _stream_plan(d * emb.element_size(), k, b, t, sms)
        splits = plan["splits"]
        partial = torch.empty((b, splits, k), dtype=torch.int64, device=emb.device)
        _build.launch(
            "sse_topk_stream", [_P, _P, _I, _I, _I, _I, _P] + [_I] * 6 + [_P], emb.device,
            q.data_ptr(), emb.data_ptr(), _DTYPE_CODE[emb.dtype], b, t, d, nr.data_ptr(), k,
            int(exact),
            plan["groups"], plan["stages"], plan["cap"], splits, partial.data_ptr(),
        )
    launches["topk_exact" if exact else "topk_stream", b] += 1
    mode = 0 if composites else (3 if exact else (2 if int_exact else 1))
    return _select(partial.reshape(b, splits * k), k, mode)


# ------------------------------------------------------------- two-phase
def twophase_block_t(t_pad: int, k: int) -> Optional[int]:
    """The port's two-phase block size for this index, or None when the
    index is too small for it (the engine then streams)."""
    bt = TWOPHASE_BLOCK_T
    return bt if t_pad % bt == 0 and k <= t_pad // bt else None


def _check_block_t(emb: torch.Tensor, block_t: int, name: str) -> None:
    """What the phase kernels take: bf16 and int8 blocks of whole 128-row
    score tiles, at most 4096 rows (a row's place in its block rides in a
    phase-2 candidate's 12 low bits); float32 blocks of 64-row steps."""
    if emb.dtype == torch.float32:
        if block_t % _TILE_ROWS:
            raise ValueError(f"{name}: block_t must be a multiple of {_TILE_ROWS}")
    elif block_t % _SCORE_TILE or block_t > _MAX_BLOCK_T:
        raise ValueError(
            f"{name}: bf16/int8 block_t must be a multiple of {_SCORE_TILE} and at most "
            f"{_MAX_BLOCK_T}, got {block_t}")


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
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real, block_t: int
) -> torch.Tensor:
    """Phase 1 [B, k] int64: the block-max kernel plus the warp select on
    CUDA tensors, the plain version on CPU tensors. ``num_real``: an int
    or a 0-d int32 tensor on the index's card."""
    if not emb.is_cuda:
        return twophase_phase1_reference(q, emb, k, num_real, block_t)
    _check_cuda(q, emb, k, "twophase_phase1")
    _check_block_t(emb, block_t, "twophase_phase1")
    b, d = q.shape
    t = emb.shape[0]
    nblocks = t // block_t
    nr = _num_real_on(num_real, emb, "twophase_phase1")
    # the float32 kernel's grid; the bf16 / int8 kernel shapes its own
    qb = _queries_per_block(b)
    blocks_per_cta = _split(nblocks, b, qb, emb.device)[0] if emb.dtype == torch.float32 else 0
    bkeys = torch.empty((b, nblocks), dtype=torch.int64, device=emb.device)
    _build.launch(
        "sse_twophase_blockmax", [_P, _P, _I, _I, _I, _I, _P] + [_I] * 4 + [_P], emb.device,
        q.data_ptr(), emb.data_ptr(), _DTYPE_CODE[emb.dtype], b, t, d, nr.data_ptr(),
        block_t, nblocks, qb, blocks_per_cta, bkeys.data_ptr(),
    )
    launches["twophase_p1", b] += 1
    return _select(bkeys, k, 0)


def pair_schedule(bkeys: torch.Tensor, nblocks: int):
    """The mid-pass (plain torch, no host sync: it runs under
    ``torch.cuda.set_sync_debug_mode("error")``): the B·k (query, block)
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
    order = torch.argsort(blk, stable=True)
    sblk = blk[order]
    srow = order // k  # the query of each sorted pair
    # sblk is sorted, so each block's first pair is a binary search: no
    # bincount, whose CUDA version reads the input's range back to the host
    start = torch.searchsorted(sblk, torch.arange(nblocks + 1, device=dev))
    counts = start.diff()
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    tile_base = torch.cat([zero, torch.cumsum((counts + PAIR_TILE - 1) // PAIR_TILE, 0)])
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
    q: torch.Tensor, emb: torch.Tensor, k: int, num_real, block_t: int,
    tile_query: torch.Tensor, tile_block: torch.Tensor,
) -> torch.Tensor:
    """Phase 2: the pair kernel on CUDA tensors, the plain version on CPU
    tensors. ``num_real`` as in phase 1."""
    if not emb.is_cuda:
        return twophase_phase2_reference(
            q, emb, k, num_real, block_t, tile_query, tile_block
        )
    _check_cuda(q, emb, k, "twophase_phase2")
    _check_block_t(emb, block_t, "twophase_phase2")
    for name, x in (("tile_query", tile_query), ("tile_block", tile_block)):
        if not (x.device == emb.device and x.dtype == torch.int32 and x.is_contiguous()):
            raise ValueError(f"twophase_phase2: {name} must be contiguous int32 on {emb.device}")
    b, d = q.shape
    t = emb.shape[0]
    ntile = tile_block.shape[0]
    if tile_query.shape[0] != ntile * PAIR_TILE:
        raise ValueError("twophase_phase2: tile_query must hold PAIR_TILE ids per tile")
    nr = _num_real_on(num_real, emb, "twophase_phase2")
    out = torch.empty((ntile * PAIR_TILE, k), dtype=torch.int64, device=emb.device)
    _build.launch(
        "sse_twophase_pairs", [_P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _P], emb.device,
        q.data_ptr(), emb.data_ptr(), _DTYPE_CODE[emb.dtype], b, t, d, nr.data_ptr(),
        block_t, ntile, tile_query.data_ptr(), tile_block.data_ptr(), k,
        out.data_ptr(),
    )
    launches["twophase_p2", b] += 1
    return out


def fused_score_topk_twophase(
    q: torch.Tensor,  # [B, D] queries
    emb: torch.Tensor,  # [T_pad, D], T_pad % block_t == 0
    k: int,
    num_real,  # an int or a 0-d int32 tensor (see fused_score_topk)
    block_t: int = TWOPHASE_BLOCK_T,
    composites: bool = False,
):
    """Exact top-k with the two-phase block-max algorithm: selection
    identical to ``fused_score_topk``. Needs k <= nblocks = T_pad/block_t.
    Phase 1 and phase 2 are kernels on CUDA tensors (plain versions on
    CPU tensors); the mid-pass and the merge are plain torch.
    ``composites=True`` returns the int64 composites, as
    ``fused_score_topk`` does."""
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
        empty = torch.empty((b, k), dtype=torch.int64, device=emb.device)
        return empty if composites else decode(empty, int_exact)
    if emb.is_cuda:  # one device copy of the count for both phases
        num_real = _num_real_on(num_real, emb, "fused_score_topk_twophase")
    bkeys = twophase_phase1(q, emb, k, num_real, block_t)
    tile_query, tile_block, pos = pair_schedule(bkeys, nblocks)
    cand = twophase_phase2(q, emb, k, num_real, block_t, tile_query, tile_block)
    # merge: each query's k pairs x k candidates, contract order
    got = cand[pos.clamp(min=0)]
    got = torch.where((pos >= 0)[:, None], got, _EMPTY)
    comp = _topk_desc(got.view(b, k * k), k)
    return comp if composites else decode(comp, int_exact)


__all__ = [
    "KERNELS",
    "NEG",
    "PAIR_TILE",
    "TWOPHASE_BLOCK_T",
    "TWOPHASE_MIN_BATCH",
    "VARIANTS",
    "dec_val",
    "decode",
    "enc_key",
    "from_sortable",
    "fused_score_topk",
    "fused_score_topk_twophase",
    "launch_total",
    "launches",
    "pair_schedule",
    "quantize_queries_int8",
    "reference_composites",
    "rows_off_reference",
    "to_sortable",
    "topk_reference",
    "twophase_block_t",
    "twophase_phase1",
    "twophase_phase1_reference",
    "twophase_phase2",
    "twophase_phase2_reference",
]
