"""Recurrent layers, forward and backward: GRU and LSTM (port of
``sse_tpu/ops/pallas_rnn.py``).

Four TPU kernels have their Hopper counterparts here:

* ``rnn_layer`` — one fused layer forward (``_layer_fwd_pallas``): per
  step ``gates_t = xs_t·Wx + b + bf16(h_{t-1})·Wh`` (bf16 operands,
  float32 sums), the cell, and the masked carry freeze ``h = m·h_new +
  (1-m)·h`` (and ``c`` likewise for the LSTM). Returns ``(ys [T,B,H]
  bf16, fin [B,H] fp32)``; the LSTM also keeps ``cs = bf16(c)`` for its
  backward. GRU: ``csrc/gru_fwd.cu`` where it holds [Wx;Wh]ᵀ; LSTM, and
  the GRU elsewhere: ``csrc/rnn_scan.cu`` ``sse_rnn_fwd`` (x-product,
  then the scan).
* ``scan_layer`` — the recurrence over precomputed x-side pre-activations
  ``ax`` (``scan_layer``, kernel 1), either cell: ``csrc/rnn_scan.cu``.
  ``rnn_encode`` stacks it into a forward-only multi-layer encode.
* ``rnn_layer_bwd`` — one layer backward (``_layer_bwd_pallas`` →
  ``_bwd_kernel``): reverse time, gates recomputed from ``xs`` and the
  bf16 ``ys`` (and ``cs``); ``dxs`` in bf16, ``dWx``, ``dWh``, ``db`` in
  fp32. GRU: ``csrc/gru_bwd.cu``; LSTM: ``csrc/lstm_bwd.cu``.
* ``RNNLayer`` is the ``torch.autograd.Function`` that joins forward and
  backward, as ``jax.custom_vjp`` does in the JAX package.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version of the same function
(``*_reference``, ``*_chain``). See the kernel sources for what bounds
them on the H100.

Widths. ``layer_plan(cell, E, H)`` places every layer the JAX package
trains (H up to 384) on a kernel instance before anything launches: E
padded to a multiple of 16, H to a multiple of 16·C, where C is the
number of blocks of a thread-block cluster that split Whᵀ (the scan) or
Wh (the backward's dh loop) between their shared memories, the
smallest of 1, 2, 4, 8 whose layout fits one SM. The padding is exact
(zero weights, bias and carry keep a padded unit at 0) and happens
inside the CUDA route (``pad_layer``, ``unpad_grads``); the CPU route
runs unpadded. A cluster of the scan, and of the dh loop, carries R
batch rows, a tile the launch picks from B and the clusters the card
holds at once (``scan_tile``, ``dh_tile``); the tile changes no output
bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sse_tpu_torch.ops import _build

# Launches of each CUDA kernel wrapper (incremented only where it launches).
# ``rnn_scan`` counts every launch of the scan: ``scan_layer``'s and the
# one inside each split layer forward (``sse_rnn_fwd`` runs it after the
# x-product: every LSTM forward, counted in ``lstm_fwd``, and the GRU
# forwards that ``gru_fwd.cu`` cannot hold, in ``gru_fwd_split``).
# ``gru_fwd`` counts ``gru_fwd.cu`` alone. The ``*_cluster`` counters count
# the launches, among those, whose scan or dh loop ran on the cluster
# instance (C >= 2).
launches = {"gru_fwd": 0, "gru_bwd": 0, "lstm_fwd": 0, "lstm_bwd": 0, "rnn_scan": 0,
            "gru_fwd_split": 0, "rnn_scan_cluster": 0, "gru_bwd_cluster": 0,
            "lstm_bwd_cluster": 0}

_MAX_SMEM = 232_448  # opt-in dynamic shared memory per block on sm_90
_GATES = {"gru": 3, "lstm": 4}


def _n_gates(cell: str) -> int:
    if cell not in _GATES:
        raise ValueError(f"unknown recurrent cell {cell!r} (gru | lstm)")
    return _GATES[cell]


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bf16-rounded operands, summed in float32 (a bf16
    ``torch.matmul`` would round its result to bf16)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def split_weights(layer, cell: str):
    """The fused [(in+H), G·H] kernel of the checkpoint layout → (x-part,
    h-part, bias), as ``towers.py:301-307``."""
    h = layer["w"].shape[1] // _n_gates(cell)
    in_dim = layer["w"].shape[0] - h
    return layer["w"][:in_dim], layer["w"][in_dim:], layer["b"]


def gru_cell(gates: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Elementwise GRU update from combined pre-activations [B, 3H]. The
    reset gate scales the WHOLE candidate pre-activation, its x-part and
    bias included: h' = (1-z)·tanh(r·n_pre) + z·h — not the textbook GRU."""
    z, r, n_pre = torch.chunk(gates, 3, dim=-1)
    z = torch.sigmoid(z)
    r = torch.sigmoid(r)
    n = torch.tanh(n_pre * r)
    return (1.0 - z) * n + z * h


def lstm_cell(
    gates: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise LSTM update from combined pre-activations [B, 4H], gate
    order (i, f, g, o), the forget gate biased by +1 (``towers.py:293-298``).
    Returns (h_new, c_new)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


# ------------------------------------------------------------ plain forward
def _scan_reference(ax, mask, wh, cell):
    """(ys bf16, fin fp32, cs bf16 | None): the recurrence of kernel 1 and
    of the fused layer forward, ``gates_t = ax_t + bf16(h)·Wh``."""
    _n_gates(cell)
    T, B, _ = ax.shape
    H = wh.shape[0]
    h = torch.zeros((B, H), dtype=torch.float32, device=ax.device)
    c = torch.zeros_like(h)
    ys, cs = [], []
    for t in range(T):
        gates = ax[t].float() + bf16_matmul(h, wh)
        m = mask[t, 0][:, None].float()
        if cell == "gru":
            h = m * gru_cell(gates, h) + (1.0 - m) * h
        else:
            h_new, c_new = lstm_cell(gates, h, c)
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            cs.append(c.to(torch.bfloat16))
        ys.append(h.to(torch.bfloat16))
    empty = torch.empty((0, B, H), dtype=torch.bfloat16, device=ax.device)
    ys = torch.stack(ys) if ys else empty
    if cell == "gru":
        return ys, h, None
    return ys, h, torch.stack(cs) if cs else empty


def scan_layer_reference(
    ax: torch.Tensor,  # [T, B, G·H] fp32
    mask: torch.Tensor,  # [T, 1, B] float 1/0
    wh: torch.Tensor,  # [H, G·H]
    cell: str = "gru",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel 1 (``pallas_rnn.scan_layer``); any device.
    Returns (ys [T,B,H] bf16, fin [B,H] fp32)."""
    return _scan_reference(ax, mask, wh, cell)[:2]


def _x_product(xs, wx, b) -> torch.Tensor:
    """ax = bf16(xs)·bf16(Wx) + b over all T·B rows, [T, B, G·H] fp32."""
    T, B, E = xs.shape
    return (bf16_matmul(xs.reshape(T * B, E), wx) + b.float()).reshape(T, B, wx.shape[1])


def rnn_layer_reference(
    xs: torch.Tensor,  # [T, B, E]
    mask: torch.Tensor,  # [T, 1, B] float 1/0
    wx: torch.Tensor,  # [E, G·H]
    wh: torch.Tensor,  # [H, G·H]
    b: torch.Tensor,  # [G·H]
    cell: str = "gru",
):
    """Plain PyTorch layer forward with the kernels' numerics; any device.
    GRU: (ys, fin); LSTM: (ys, fin, cs), as ``_layer_fwd_pallas`` emits.
    Summed as ``(xs·Wx + b) + h·Wh``, the fp32 order of ``_fwd_core``."""
    ys, fin, cs = _scan_reference(_x_product(xs, wx, b), mask, wh, cell)
    return (ys, fin) if cell == "gru" else (ys, fin, cs)


# ------------------------------------------------------------ the layer plan
# The kernels' shared-memory layouts, mirrored from the sources (a GPU test
# holds each mirror against the library's ``sse_*_smem_bytes``): bf16 rows
# padded by KPAD, fp32 rows by 4, 8 batch rows (one n8 tile) a block, 16
# hidden units a warp.
_KPAD, _FPAD, _BN, _WH = 8, 4, 8, 16
CLUSTERS = (1, 2, 4, 8)  # blocks a cluster: 8 is the portable most
CLUSTER_UNITS = 128  # units a cluster block owns at most: 8 warps
# The cluster scan's blocks: threads a block takes at most when its warps
# carry NJ n8 row groups each (what an SM's registers hold), and the most
# groups a warp carries (G gates → groups)
CLUSTER_THREADS = {1: 512, 2: 384, 3: 256, 4: 256}
CLUSTER_GROUPS = {3: 4, 4: 3}
# The cluster dh loop's blocks (csrc/dh_cluster.cuh kThreadsMost): one n8
# row group a warp, threads a block at most
DH_CLUSTER_THREADS = 512
# The rows whose tile the plan's test of a dh cluster width holds in
# shared memory (dh_cluster.cuh kPlanRows): three n8 groups
DH_PLAN_ROWS = 24
# Units a single-block instance takes at most: its threads' launch bound
# (2H threads: 352 for the scan, the GRU forward and the GRU dh loop, 288
# for the LSTM dh loop)
_ONE_BLOCK_UNITS = {"scan": 176, "gru_dh": 176, "lstm_dh": 144, "gru_fwd": 176}


def gru_fwd_smem(E: int, H: int) -> int:
    """Bytes of shared memory a ``gru_fwd.cu`` block takes (its
    ``layout``): at E=H=128 Wxᵀ, the h tiles, the xs ring and the masks
    for 16 rows; else [Wx;Wh]ᵀ and the h tiles for 8 rows."""
    fixed = E == H == 128
    rows = 2 * _BN if fixed else _BN
    w = 3 * H * ((E if fixed else E + H) + _KPAD) * 2
    h = 2 * rows * (H + _KPAD) * 2
    ring = 3 * rows * (E + _KPAD) * 2 + 4 * rows * 4 if fixed else 0
    return w + h + ring


def scan_smem(G: int, H: int, C: int = 1, R: int = _BN) -> int:
    """Bytes of shared memory a scan block takes (``rnn_scan.cu``): C=1,
    ``layout`` (at H=128 the ax ring for 16 rows, else Whᵀ for 8 rows);
    C >= 2, ``cluster_layout`` for a tile of R batch rows: the Whᵀ rows of
    the block's H/C units for every gate, the full double-buffered bf16 h
    tile [R][H] and, for the LSTM, its units' bf16 c tiles [R][H/C]."""
    ldh = H + _KPAD
    if C == 1:
        fixed = H == 128
        rows = 2 * _BN if fixed else _BN
        w = 0 if fixed else G * H * ldh * 2
        c = 2 * rows * ldh * 2 if G == 4 else 0
        ring = 4 * rows * (G * H + _FPAD) * 4 + 4 * rows * 4 if fixed else 0
        return w + 2 * rows * ldh * 2 + c + ring
    hc = H // C
    c = 2 * R * (hc + _KPAD) * 2 if G == 4 else 0
    return G * hc * ldh * 2 + 2 * R * ldh * 2 + c


def dh_smem(G: int, H: int, C: int = 1, R: int = DH_PLAN_ROWS) -> int:
    """Bytes of shared memory a dh-loop block takes. C=1 (``gru_bwd.cu``,
    ``lstm_bwd.cu``): the Wh rows (none at H=128, where they sit in
    registers), the double-buffered bf16 dgates_b tile [8][G·H] and its
    input stages (3 at H=128, else 1), each the fp32 gates of its units,
    dys_t and h_{t-1} (c_{t-1}) and the mask. C >= 2 (``dh_cluster.cuh``
    ``layout``), for a tile of R batch rows: the Wh rows of the block's
    H/C units, then the bf16 dgates_b tile [R][G·H], two of them where
    they fit, else one (the step inputs sit in registers), and an 8-byte
    mbarrier for each; the default R is the plan's test of a width."""
    ldw = G * H + _KPAD
    if C == 1:
        stage = _BN * (G * H + _FPAD) * 4 + 2 * _BN * (H + _KPAD) * 2 + (H // _WH) * _BN * 4
        wh, stages = (0, 3) if H == 128 else (H * ldw * 2, 1)
        return wh + 2 * _BN * ldw * 2 + stages * stage
    wh, tile = H // C * ldw * 2, R * ldw * 2
    return wh + (2 if wh + 2 * (tile + 8) <= _MAX_SMEM else 1) * (tile + 8)


def _refusal(kind: str, G: int, H: int, C: int) -> Optional[str]:
    """Why the C-block instance of ``kind`` ("scan" or "dh") cannot take a
    G-gate layer at hidden H (None: it can): H a multiple of 16·C, at most
    the single block's thread bound (C = 1) or CLUSTER_UNITS units a block
    (C >= 2), and the layout within _MAX_SMEM (a cluster's at its test
    tile: 8 rows for the scan, DH_PLAN_ROWS for the dh loop)."""
    if C not in CLUSTERS or H % (_WH * C):
        return f"H={H} is no multiple of 16·{C}"
    one = _ONE_BLOCK_UNITS["scan" if kind == "scan" else ("gru_dh" if G == 3 else "lstm_dh")]
    if C == 1 and H > one:
        return f"one block takes H <= {one}"
    if C > 1 and H // C > CLUSTER_UNITS:
        return f"{H // C} units a block (> {CLUSTER_UNITS})"
    need = (scan_smem if kind == "scan" else dh_smem)(G, H, C)
    if need > _MAX_SMEM:
        return f"{need} B of shared memory a block (> {_MAX_SMEM})"
    return None


def _cluster(kind: str, G: int, H: int, most: int = CLUSTERS[-1]) -> Optional[int]:
    """The smallest cluster size C <= most whose ``kind`` instance takes
    hidden H (``_refusal``), or None."""
    return next((C for C in CLUSTERS if C <= most and _refusal(kind, G, H, C) is None), None)


class LayerPlan(NamedTuple):
    """Where a recurrent layer runs on the card: the widths the kernels see
    (E_p, H_p: E padded to a multiple of 16, H to one of 16·C for the
    larger C), the forward's route ("fused": ``gru_fwd.cu``; "split": the
    x-product on ``products.cu``, then the scan) and the cluster sizes of
    the scan and of the backward's dh loop (1: the single-block
    instances)."""

    cell: str
    E: int
    H: int
    E_p: int
    H_p: int
    fwd: str
    scan_cluster: int
    dh_cluster: int


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def _hidden_plan(G: int, H: int) -> Optional[Tuple[int, int, int]]:
    """(H_p, scan C, dh C) for hidden H, or None beyond the kernels' reach:
    for each bound c on the cluster (1, 2, 4, 8 in turn), H_p = H rounded
    up to a multiple of 16·c, and the first c under which both the scan
    and the dh loop fit."""
    for most in CLUSTERS:
        H_p = _ceil(H, _WH * most)
        cs, cd = _cluster("scan", G, H_p, most), _cluster("dh", G, H_p, most)
        if cs and cd:
            return H_p, cs, cd
    return None


@functools.lru_cache(maxsize=None)
def widest_hidden(cell: str) -> int:
    """The widest hidden size ``layer_plan`` places for ``cell`` (any E)."""
    G = _n_gates(cell)
    return max(H for H in range(_WH, 64 * _WH + 1, _WH) if _hidden_plan(G, H))


@functools.lru_cache(maxsize=None)
def layer_plan(cell: str, E: int, H: int) -> LayerPlan:
    """The kernel instances and padded widths of a ``cell`` layer with
    input width E and hidden width H on the card. A pure function of the
    shapes, like ``dw_plan``: it never reads the card, so every card and
    rank picks the same instances and computes the same bits. Raises
    ``ValueError`` for a width no instance takes, before any launch.

    At E=H=128 it picks the fixed instances (registers hold the weights);
    at H=256 the GRU scan takes C=2 and its dh loop C=4, the LSTM C=4 for
    both; H=384 takes C=8; H=100 pads to 112. The GRU forward runs on
    ``gru_fwd.cu`` where its [Wx;Wh]ᵀ fits a block (E=128: H <= 128),
    else the x-product and the scan."""
    G = _n_gates(cell)
    if E < 1 or H < 1:
        raise ValueError(f"layer_plan: {cell} widths must be positive (E={E}, H={H})")
    hidden = _hidden_plan(G, H)
    if hidden is None:
        raise ValueError(
            f"layer_plan: a {cell} layer of hidden width {H} is beyond the recurrent "
            f"kernels' reach (no cluster of up to {CLUSTERS[-1]} blocks holds its weights in "
            f"shared memory): the widest hidden width they take is {widest_hidden(cell)}")
    H_p, cs, cd = hidden
    E_p = _ceil(E, _WH)
    fused = G == 3 and H_p <= _ONE_BLOCK_UNITS["gru_fwd"] and gru_fwd_smem(E_p, H_p) <= _MAX_SMEM
    return LayerPlan(cell, E, H, E_p, H_p, "fused" if fused else "split", cs, cd)


# ------------------------------------------------------------ the scan's tile
def _cdiv(n: int, m: int) -> int:
    return _ceil(n, m) // m


def cluster_split(G: int, H: int, C: int, R: int) -> Optional[Tuple[int, int, int]]:
    """How a block of the cluster scan splits a tile of R rows on C blocks
    (``rnn_scan.cu`` ``cluster_tile``): (S row slices, NJ n8 groups a warp
    at most, threads), with a warp for each 16 units of the block's H/C in
    each slice; NJ the fewest (up to CLUSTER_GROUPS[G]) whose threads
    CLUSTER_THREADS[NJ] allows, the groups spread evenly over the slices.
    None where no split fits a block."""
    groups, warps = R // _BN, H // C // _WH
    for n in range(1, CLUSTER_GROUPS[G] + 1):
        S = _cdiv(groups, n)
        if 32 * warps * S <= CLUSTER_THREADS[n]:
            return S, _cdiv(groups, S), 32 * warps * S
    return None


def dh_threads(G: int, H: int, C: int, R: int) -> Optional[int]:
    """The threads of a cluster dh-loop block for a tile of R rows on C
    blocks (``dh_cluster.cuh`` ``threads``): a warp for each 16 units and
    each 8 rows, None beyond DH_CLUSTER_THREADS."""
    n = 32 * (H // C // _WH) * (R // _BN)
    return n if n <= DH_CLUSTER_THREADS else None


def _rows_most(threads, smem, G: int, H: int, C: int) -> int:
    """The most batch rows (a multiple of 8) a cluster of C blocks carries
    at hidden H: ``threads`` takes them on a block (not None) and ``smem``
    is within _MAX_SMEM. Both hold for every multiple of 8 up to it."""
    R = _BN
    while threads(G, H, C, R + _BN) is not None and smem(G, H, C, R + _BN) <= _MAX_SMEM:
        R += _BN
    return R


@functools.lru_cache(maxsize=None)
def scan_rows_most(G: int, H: int, C: int) -> int:
    """The most rows a cluster of the scan carries (``_rows_most``: the
    Whᵀ slice, then 2·(H+8)·2 bytes a row, and 2·(H/C+8)·2 more for the
    LSTM's c tiles)."""
    return _rows_most(cluster_split, scan_smem, G, H, C)


@functools.lru_cache(maxsize=None)
def dh_rows_most(G: int, H: int, C: int) -> int:
    """The most rows a cluster of the dh loop carries (``_rows_most``:
    the Wh rows, then (G·H+8)·2 bytes a row for each of the one or two
    dgates_b tiles)."""
    return _rows_most(dh_threads, dh_smem, G, H, C)


class ScanTile(NamedTuple):
    """How a cluster launch (the scan, or the dh loop) covers B rows:
    clusters of C blocks, each carrying R batch rows, ``clusters`` =
    ceil(B / R) of them, of which the card holds ``active`` at once, so
    they run in ``waves`` waves."""

    C: int
    R: int
    clusters: int
    active: int
    waves: int


def _tile(kernel: str, most: int, H: int, B: int, C: int, active: int,
          rows: Optional[int]) -> ScanTile:
    """R, the smallest multiple of 8 that covers B rows in the fewest
    waves of ``active`` clusters that ``most`` rows a cluster allow
    (``rows`` forces R, and raises where the kernel takes no such tile)."""
    n = max(active, 1)
    if rows is not None and (rows < _BN or rows % _BN or rows > most):
        raise ValueError(f"{kernel}: a tile of {rows} rows on {C} blocks (H={H}): R must be a "
                         f"multiple of {_BN} up to {most}")
    waves = _cdiv(_cdiv(B, most), n)
    R = rows if rows is not None else min(most, _ceil(_cdiv(B, waves * n), _BN))
    clusters = _cdiv(B, R)
    return ScanTile(C, R, clusters, n, _cdiv(clusters, n))


def scan_tile(G: int, H: int, B: int, C: int, active: int,
              rows: Optional[int] = None) -> ScanTile:
    """The tile of the cluster scan on C >= 2 blocks for B rows at hidden
    H, where the card holds ``active`` such clusters at once: R, the
    smallest multiple of 8 that covers B in the fewest waves that the
    most rows (``scan_rows_most``) allow (``rows`` forces R). The tile
    changes no bit: a row's sums run in one order on any R."""
    return _tile("rnn_scan", scan_rows_most(G, H, C), H, B, C, active, rows)


def dh_tile(G: int, H: int, B: int, C: int, active: int,
            rows: Optional[int] = None) -> ScanTile:
    """The tile of the cluster dh loop on C >= 2 blocks for B rows, as
    ``scan_tile`` picks the scan's, up to ``dh_rows_most`` rows. The tile
    changes no bit, and the db partials stay one row of db_part for each
    8 rows."""
    return _tile(f"{'lstm' if G == 4 else 'gru'}_bwd", dh_rows_most(G, H, C), H, B, C, active,
                 rows)


@functools.lru_cache(maxsize=None)
def active_clusters(device: torch.device, G: int, H: int, C: int, kind: str = "scan") -> int:
    """The clusters of C blocks of ``kind`` ("scan" | "dh") at hidden H,
    each carrying its most rows, that the card ``device`` holds at once:
    the library's ``cudaOccupancyMaxActiveClusters``, asked once a (card,
    kind, G, H, C) and kept, so the eager warm-up before a capture asks
    it, never the capture."""
    if kind == "scan":
        name, args = "sse_rnn_scan_cluster_active", (G, H, C, scan_rows_most(G, H, C))
    else:
        name = f"sse_{'lstm' if G == 4 else 'gru'}_bwd_cluster_active"
        args = (H, C, dh_rows_most(G, H, C))
    fn = getattr(_build.library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args)
    with torch.cuda.device(device):
        n = fn(*args)
    if n < 0:
        _build._check(-n, name)
    return n


def card_scan_tile(device: torch.device, G: int, H: int, B: int, C: int,
                   rows: Optional[int] = None, active: Optional[int] = None) -> ScanTile:
    """The tile a cluster scan launch of B rows on C blocks of ``device``
    takes (``scan_tile``), with the card's active clusters; ``rows``
    forces R and ``active`` the card's count (private to the tests and
    the measurements)."""
    n = active if active is not None else active_clusters(device, G, H, C)
    return scan_tile(G, H, B, C, n, rows)


def card_dh_tile(device: torch.device, G: int, H: int, B: int, C: int,
                 rows: Optional[int] = None, active: Optional[int] = None) -> ScanTile:
    """The tile a cluster dh loop launch of B rows takes (``dh_tile``),
    as ``card_scan_tile`` gives the scan's."""
    n = active if active is not None else active_clusters(device, G, H, C, "dh")
    return dh_tile(G, H, B, C, n, rows)


def pad_units(t: torch.Tensor, n: int) -> torch.Tensor:
    """t [..., m] → [..., n], zeros after the first m columns (t itself
    where m == n)."""
    m = t.shape[-1]
    return t if m == n else F.pad(t, (0, n - m))


def pad_gates(t: torch.Tensor, G: int, H_p: int) -> torch.Tensor:
    """t [..., G·H] → [..., G·H_p]: each gate's block of H columns padded
    with zeros to H_p (the kernels index gate g's unit u at g·H_p + u)."""
    H = t.shape[-1] // G
    if H == H_p:
        return t
    lead = t.shape[:-1]
    return F.pad(t.reshape(*lead, G, H), (0, H_p - H)).reshape(*lead, G * H_p)


def unpad_gates(t: torch.Tensor, G: int, H: int) -> torch.Tensor:
    """The inverse of ``pad_gates``: [..., G·H_p] → [..., G·H]."""
    H_p = t.shape[-1] // G
    if H == H_p:
        return t
    lead = t.shape[:-1]
    return t.reshape(*lead, G, H_p)[..., :H].reshape(*lead, G * H)


def _pad_rows(w: torch.Tensor, n: int) -> torch.Tensor:
    return w if w.shape[0] == n else F.pad(w, (0, 0, 0, n - w.shape[0]))


def pad_layer(xs, wx, wh, b, G: int, E_p: int, H_p: int):
    """A layer's operands at the kernels' widths, zero-padded: xs [T,B,E_p],
    Wx [E_p, G·H_p], Wh [H_p, G·H_p], b [G·H_p]. A padded unit has zero
    weights, zero bias and a zero carry, so it stays exactly 0 (GRU: h' =
    σ(0)·0 + σ(0)·0; LSTM: c' = σ(1)·0 + σ(0)·tanh(0)) and adds exact zeros
    to every real unit's sums, forward and backward."""
    return (pad_units(xs, E_p), pad_gates(_pad_rows(wx, E_p), G, H_p),
            pad_gates(_pad_rows(wh, H_p), G, H_p), pad_gates(b, G, H_p))


def unpad_grads(dxs, dwx, dwh, db, G: int, E: int, H: int):
    """The gradients of ``pad_layer``'s operands back at the layer's widths
    (contiguous)."""
    if dxs.shape[-1] == E and dwh.shape[0] == H:
        return dxs, dwx, dwh, db
    return tuple(t.contiguous() for t in (dxs[..., :E], unpad_gates(dwx[:E], G, H),
                                          unpad_gates(dwh[:H], G, H), unpad_gates(db, G, H)))


def _on_card(t: torch.Tensor) -> bool:
    """The CUDA route: the tensor lies on a card."""
    return t.is_cuda


# ------------------------------------------------------------ CUDA launches
def _check_args(kernel: str, args) -> None:
    """Raise unless every (tensor, dtype, shape) of ``args`` is on the first
    one's CUDA device, of that dtype and shape, contiguous and 16-byte
    aligned."""
    dev = next(iter(args.values()))[0].device
    for name, (t, dtype, shape) in args.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{kernel}: {name} must be on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be contiguous {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and starting on a 16-byte boundary (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _layer_args(xs, mask, wx, wh, b, G):
    T, B, E = xs.shape
    H = wh.shape[0]
    return {
        "xs": (xs, torch.bfloat16, (T, B, E)),
        "mask": (mask, torch.float32, (T, 1, B)),
        "wx": (wx, torch.bfloat16, (E, G * H)),
        "wh": (wh, torch.bfloat16, (H, G * H)),
        "b": (b, torch.float32, (G * H,)),
    }


def fused_weight_t(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[Wx;Wh]ᵀ [G·H, E+H], contiguous: the weight layout the layer
    forward kernels read row by row (the GRU's, the LSTM's x-product and
    scan) and the backward's gate recompute reads (the TPU kernel's
    wxᵀ/whᵀ)."""
    return torch.cat([wx, wh]).t().contiguous()


def _fits(kernel: str, need: int, what: str) -> None:
    """Raise unless ``need`` bytes of shared memory fit one block."""
    if need > _MAX_SMEM:
        raise ValueError(f"{kernel}: {what} needs {need} B of shared memory a block "
                         f"(> {_MAX_SMEM}); layer_plan pads and places such widths")


def _cluster_of(kernel: str, kind: str, G: int, H: int, cluster: Optional[int]) -> int:
    """The cluster size a ``kind`` ("scan" | "dh") launch at hidden H runs
    with: ``cluster`` if given, else the smallest that takes H; raises
    with the reasons where none does."""
    C = _cluster(kind, G, H) if cluster is None else cluster
    if C is None or _refusal(kind, G, H, C):
        why = "; ".join(f"on {c}: {_refusal(kind, G, H, c)}" for c in ([C] if C else CLUSTERS))
        raise ValueError(f"{kernel}: no instance takes H={H} ({why}); layer_plan pads and "
                         "places such widths")
    return C


def gru_fwd_launch(xs, mask, wx, wh, b, wt=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/gru_fwd.cu`` on CUDA tensors (contiguous, 16-byte aligned:
    xs, wx, wh bf16; mask, b fp32) → (ys, fin). ``wt`` is
    ``fused_weight_t(wx, wh)`` where the caller has it (built here if
    not)."""
    _check_args("gru_fwd", _layer_args(xs, mask, wx, wh, b, 3))
    T, B, E = xs.shape
    H = wh.shape[0]
    wt = fused_weight_t(wx, wh) if wt is None else wt
    _check_args("gru_fwd", {"xs": (xs, torch.bfloat16, (T, B, E)),
                            "wt": (wt, torch.bfloat16, (3 * H, E + H))})
    check_widths("gru_fwd", E, H)
    if H > _ONE_BLOCK_UNITS["gru_fwd"]:
        raise ValueError(f"gru_fwd: H={H} is above the kernel's thread bound; "
                         "layer_plan sends it to the split route")
    _fits("gru_fwd", gru_fwd_smem(E, H), f"(E={E}, H={H})")
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=xs.device)
    fin = torch.empty((B, H), dtype=torch.float32, device=xs.device)
    if T == 0 or B == 0:
        return ys, fin.zero_()
    _build.launch(
        "sse_gru_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4, xs.device,
        xs.data_ptr(), mask.data_ptr(), wt.data_ptr(), b.data_ptr(), ys.data_ptr(),
        fin.data_ptr(), T, B, E, H,
    )
    launches["gru_fwd"] += 1
    return ys, fin


def _count_scan(C: int) -> None:
    launches["rnn_scan"] += 1
    if C > 1:
        launches["rnn_scan_cluster"] += 1


def rnn_fwd_launch(xs, mask, wx, wh, b, cell: str = "lstm", wt=None,
                   cluster: Optional[int] = None, *, _rows: Optional[int] = None,
                   _active: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """``csrc/rnn_scan.cu`` ``sse_rnn_fwd`` on CUDA tensors (contiguous,
    16-byte aligned: xs, wx, wh bf16; mask, b fp32): the split layer
    forward, the x-product, then the scan (on ``cluster`` blocks, the
    smallest that fits if None, in tiles of R rows: ``card_scan_tile``),
    both from the rows of ``wt = fused_weight_t(wx, wh)`` (built here if
    the caller has none). Returns (ys, fin, cs | None, ax [T,B,G·H] fp32):
    cs the LSTM's bf16 c stream, ax the x-product the scan consumed. Every
    LSTM forward takes it (counted in ``lstm_fwd``), and the GRU where
    ``gru_fwd.cu`` cannot hold the weights (``gru_fwd_split``). ``_rows``
    and ``_active`` force the tile's R and the card's active clusters (for
    tests and measurements; not a user setting)."""
    G = _n_gates(cell)
    name = "lstm_fwd" if G == 4 else "gru_fwd_split"
    _check_args(name, _layer_args(xs, mask, wx, wh, b, G))
    T, B, E = xs.shape
    H = wh.shape[0]
    wt = fused_weight_t(wx, wh) if wt is None else wt
    _check_args(name, {"xs": (xs, torch.bfloat16, (T, B, E)),
                       "wt": (wt, torch.bfloat16, (G * H, E + H))})
    check_widths(name, E, H)
    C = _cluster_of(name, "scan", G, H, cluster)
    dev = xs.device
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    cs = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev) if G == 4 else None
    fin = torch.empty((B, H), dtype=torch.float32, device=dev)
    ax = torch.empty((T, B, G * H), dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return ys, fin.zero_(), cs, ax
    R = 0 if C == 1 else card_scan_tile(dev, G, H, B, C, _rows, _active).R
    _build.launch(
        "sse_rnn_fwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7, dev,
        xs.data_ptr(), mask.data_ptr(), wt.data_ptr(), b.data_ptr(), ax.data_ptr(),
        ys.data_ptr(), fin.data_ptr(), 0 if cs is None else cs.data_ptr(), T, B, E, H, G, C, R,
    )
    launches[name] += 1
    _count_scan(C)
    return ys, fin, cs, ax


def lstm_fwd_launch(xs, mask, wx, wh, b, wt=None) -> Tuple[torch.Tensor, ...]:
    """The LSTM layer forward on CUDA tensors (``rnn_fwd_launch``): (ys,
    fin, cs, ax [T,B,4H] fp32)."""
    return rnn_fwd_launch(xs, mask, wx, wh, b, "lstm", wt)


def rnn_scan_launch(ax, mask, wh, cell: str = "gru", cluster: Optional[int] = None, *,
                    _rows: Optional[int] = None,
                    _active: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/rnn_scan.cu`` ``sse_rnn_scan`` on CUDA tensors (ax, mask fp32;
    wh bf16; contiguous, 16-byte aligned) → (ys, fin), on ``cluster``
    blocks (the smallest that fits if None), in tiles of R rows, as
    ``rnn_fwd_launch`` runs its scan (the same private keywords)."""
    G = _n_gates(cell)
    T, B, _ = ax.shape
    H = wh.shape[0]
    _check_args("rnn_scan", {
        "ax": (ax, torch.float32, (T, B, G * H)),
        "mask": (mask, torch.float32, (T, 1, B)),
        "wh": (wh, torch.bfloat16, (H, G * H)),
    })
    if H % 16:
        raise ValueError(f"rnn_scan: needs H a multiple of 16 (H={H})")
    C = _cluster_of("rnn_scan", "scan", G, H, cluster)
    dev = ax.device
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    fin = torch.empty((B, H), dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return ys, fin.zero_()
    wht = wh.t().contiguous()  # Whᵀ [G·H, H]: its rows are the A fragments
    R = 0 if C == 1 else card_scan_tile(dev, G, H, B, C, _rows, _active).R
    _build.launch(
        "sse_rnn_scan", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6, dev,
        ax.data_ptr(), mask.data_ptr(), wht.data_ptr(), ys.data_ptr(), fin.data_ptr(),
        T, B, H, G, C, R,
    )
    _count_scan(C)
    return ys, fin


# ------------------------------------------------------------ forward wrappers
def _cut(t: torch.Tensor, n: int) -> torch.Tensor:
    """The first n columns of t's last dimension, contiguous (t itself if
    it has n)."""
    return t if t.shape[-1] == n else t[..., :n].contiguous()


def _layer_fwd(xs, mask, wx, wh, b, cell, wt=None):
    """(ys, fin, cs | None): the plain version on CPU tensors; on CUDA
    tensors, already at ``layer_plan``'s padded widths (where the plan
    picks the same instances again), the route the plan picks. ``wt``:
    ``fused_weight_t(wx, wh)``, if the caller has it (both routes take
    it)."""
    if not _on_card(xs):
        return _scan_reference(_x_product(xs, wx, b), mask, wh, cell)
    plan = layer_plan(cell, xs.shape[2], wh.shape[0])
    if plan.fwd == "fused":
        return (*gru_fwd_launch(xs, mask, wx, wh, b, wt), None)
    return rnn_fwd_launch(xs, mask, wx, wh, b, cell, wt, plan.scan_cluster)[:3]


def _cast_layer(xs, mask, wx, wh, b):
    """The kernels' operand types, contiguous and 16-byte aligned."""
    return (
        _aligned(xs.to(torch.bfloat16)),
        _aligned(mask.to(torch.float32)),
        _aligned(wx.to(torch.bfloat16)),
        _aligned(wh.to(torch.bfloat16)),
        _aligned(b.to(torch.float32).reshape(-1)),
    )


def _card_layer(xs, mask, wx, wh, b, cell):
    """(plan, the cast operands at its padded widths)."""
    plan = layer_plan(cell, xs.shape[2], wh.shape[0])
    xs, wx, wh, b = pad_layer(xs, wx, wh, b, _n_gates(cell), plan.E_p, plan.H_p)
    return plan, (xs, mask, wx, wh, b)


def rnn_layer(
    xs: torch.Tensor,
    mask: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    cell: str = "gru",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent layer forward → (ys bf16, fin fp32): the Hopper kernel
    on CUDA tensors (at ``layer_plan``'s widths), the plain version on CPU
    tensors."""
    args = _cast_layer(xs, mask, wx, wh, b)
    if not _on_card(args[0]):
        return _layer_fwd(*args, cell)[:2]
    H = args[3].shape[0]
    ys, fin, _ = _layer_fwd(*_card_layer(*args, cell)[1], cell)
    return _cut(ys, H), _cut(fin, H)


def scan_layer(
    ax: torch.Tensor, mask: torch.Tensor, wh: torch.Tensor, cell: str = "gru"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1: the recurrence over precomputed ``ax`` [T,B,G·H] fp32 →
    (ys bf16, fin fp32); the scan kernel on CUDA tensors (at
    ``layer_plan``'s hidden width), the plain version on CPU tensors."""
    if not _on_card(ax):
        return scan_layer_reference(ax, mask, wh, cell)
    G, H = _n_gates(cell), wh.shape[0]
    plan = layer_plan(cell, H, H)
    ys, fin = rnn_scan_launch(
        _aligned(pad_gates(ax.to(torch.float32), G, plan.H_p)),
        _aligned(mask.to(torch.float32)),
        _aligned(pad_gates(_pad_rows(wh.to(torch.bfloat16), plan.H_p), G, plan.H_p)),
        cell, plan.scan_cluster,
    )
    return _cut(ys, H), _cut(fin, H)


def rnn_encode(params, cfg, emb: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Forward-only multi-layer encode → final hidden [B, H] fp32 (port of
    ``pallas_rnn.py:484-517``): per layer the x-product over all T·B rows
    (a plain bf16-operand product, as the JAX package leaves it to XLA)
    and ``scan_layer``; identity residuals between stacked layers when
    ``cfg.residual``. emb [B, L, E] fp32, valid [B, L] 1/0."""
    xs = emb.transpose(0, 1).to(torch.bfloat16)  # [L, B, E]
    mask = valid.T[:, None, :].float().contiguous()  # [L, 1, B]
    fin = None
    for li, layer in enumerate(params["layers"]):
        wx, wh, b = split_weights(layer, cfg.cell)
        ys, f = scan_layer(_x_product(xs, wx, b), mask, wh, cfg.cell)
        if cfg.residual and li > 0:
            fin = f + xs[-1].float()
            xs = xs + ys
        else:
            fin, xs = f, ys
    return fin


# ------------------------------------------------------------ plain backward
def _h_prev(ys: torch.Tensor) -> torch.Tensor:
    """[0, ys[0], ..., ys[T-2]] as float32: the bf16 state each step's
    forward consumed (h_{t-1} from ys, c_{t-1} from cs)."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).float()


def layer_gates(xs, h_prev, wx, wh, b) -> torch.Tensor:
    """The recomputed pre-activations ``xs_t·Wx + b + h_{t-1}·Wh`` [T, B,
    G·H] fp32 (bf16 operands), with ``h_prev`` as ``_h_prev`` gives it."""
    T, B, E = xs.shape
    H = wh.shape[0]
    return (
        bf16_matmul(xs.reshape(T * B, E), wx) + b.float()
        + bf16_matmul(h_prev.reshape(T * B, H), wh)
    ).reshape(T, B, wh.shape[1])


def gru_bwd_chain(
    gates: torch.Tensor,  # [T, B, 3H] fp32
    h_prev: torch.Tensor,  # [T, B, H]
    mask: torch.Tensor,  # [T, 1, B]
    wh: torch.Tensor,  # [H, 3H]
    dys: torch.Tensor,  # [T, B, H]
    dfin: torch.Tensor,  # [B, H]
    drive: torch.Tensor | None = None,  # [T, B, 3H] bf16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serial reverse loop of the GRU backward: returns (dgates_b
    [T,B,3H] bf16, db [3H] fp32). Each step's fp32 dgates come from the
    cell's backward at ``dh_t = dh + dys_t``, ``g = m·dh_t``; dgates_b
    rounds them and ``dh = (1-m)·dh_t + g·z + dgates_b·Whᵀ``; db sums the
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


def lstm_bwd_chain(
    gates: torch.Tensor,  # [T, B, 4H] fp32
    c_prev: torch.Tensor,  # [T, B, H]: bf16 cs[t-1], 0 at t = 0
    mask: torch.Tensor,  # [T, 1, B]
    wh: torch.Tensor,  # [H, 4H]
    dys: torch.Tensor,  # [T, B, H]
    dfin: torch.Tensor,  # [B, H]
    drive: torch.Tensor | None = None,  # [T, B, 4H] bf16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serial reverse loop of the LSTM backward (``pallas_rnn.py:
    266-289``): returns (dgates_b [T,B,4H] bf16, db [4H] fp32). The dh
    carry starts at dfin, the dc carry at 0. Per step, with ``dh_t = dh +
    dys_t``, ``g = m·dh_t`` and c_new recomputed from the bf16 c_{t-1}:
    ``dc_new = m·dc + g·σ(o)·(1-tanh²(c_new))``, the fp32 dgates (i, f, g,
    o), dgates_b = bf16(dgates), ``dh = (1-m)·dh_t + dgates_b·Whᵀ`` (no
    direct term) and ``dc = (1-m)·dc + dc_new·σ(f+1)``; db sums the
    unrounded dgates. ``drive`` as in ``gru_bwd_chain``."""
    T, B, N = gates.shape
    wh_t = wh.to(torch.bfloat16).float().t()
    dh = dfin.float()
    dc = torch.zeros_like(dh)
    db = torch.zeros((N,), dtype=torch.float32, device=gates.device)
    dgb = torch.empty(gates.shape, dtype=torch.bfloat16, device=gates.device)
    for t in range(T - 1, -1, -1):
        m = mask[t, 0][:, None].float()
        dh_t = dh + dys[t].float()
        g = m * dh_t  # d h_new
        i_pre, f_pre, g_pre, o_pre = torch.chunk(gates[t], 4, dim=-1)
        si = torch.sigmoid(i_pre)
        sf = torch.sigmoid(f_pre + 1.0)
        tg = torch.tanh(g_pre)
        so = torch.sigmoid(o_pre)
        cp = c_prev[t].float()
        tc = torch.tanh(sf * cp + si * tg)
        dc_new = m * dc + g * so * (1.0 - tc * tc)
        dgates = torch.cat([
            dc_new * tg * si * (1.0 - si),
            dc_new * cp * sf * (1.0 - sf),
            dc_new * si * (1.0 - tg * tg),
            g * tc * so * (1.0 - so),
        ], dim=1)
        dgb[t] = dgates.to(torch.bfloat16)
        dg_t = dgb[t] if drive is None else drive[t]
        dh = (1.0 - m) * dh_t + dg_t.float() @ wh_t
        dc = (1.0 - m) * dc + dc_new * sf
        db += dgates.sum(0)
    return dgb, db


def bwd_products(
    xs: torch.Tensor, h_prev: torch.Tensor, wx: torch.Tensor, dgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The products over all T·B rows, either cell: (dxs =
    bf16(dgates_b·Wxᵀ) [T,B,E], dWx = xsᵀ·dgates_b [E,G·H], dWh =
    h_prevᵀ·dgates_b [H,G·H]), fp32 sums."""
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
    wx: torch.Tensor,  # [E, G·H]
    wh: torch.Tensor,  # [H, G·H]
    b: torch.Tensor,  # [G·H]
    dys: torch.Tensor,  # [T, B, H]
    dfin: torch.Tensor,  # [B, H]
    cs: Optional[torch.Tensor] = None,  # [T, B, H] bf16, the LSTM's c stream
    cell: str = "gru",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch layer backward with ``_bwd_kernel``'s numerics
    (``pallas_rnn.py:217-314``); any device. Returns (dxs [T,B,E] bf16,
    dWx [E,G·H], dWh [H,G·H], db [G·H] fp32).

    Gates are recomputed from ``xs`` and the bf16 ``ys[t-1]`` (and, for
    the LSTM, c_{t-1} from the bf16 ``cs[t-1]``); the products (dh, dxs,
    dWx, dWh) take ``dgates_b = bf16(dgates)`` and sum in fp32; ``db``
    sums the unrounded fp32 ``dgates``."""
    if _n_gates(cell) == 4 and cs is None:
        raise ValueError("lstm backward: needs cs, the forward's bf16 c stream")
    h_prev = _h_prev(ys.to(torch.bfloat16))  # [T, B, H]
    gates = layer_gates(xs, h_prev, wx, wh, b)
    if cell == "gru":
        dgb, db = gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin)
    else:
        c_prev = _h_prev(cs.to(torch.bfloat16))
        dgb, db = lstm_bwd_chain(gates, c_prev, mask, wh, dys, dfin)
    dxs, dwx, dwh = bwd_products(xs, h_prev, wx, dgb)
    return dxs, dwx, dwh, db


# ------------------------------------------------------------ CUDA backward
# The product engine's tiles (csrc/products.cu): a block computes 128 x 128
# outputs; dW's blocks sum 64 rows of the T·B reduction a stage, its output
# rows from xs and from ys tiled apart.
PRODUCT_TILE = 128
DW_ROW_TILE = 64
DW_MAX_SPLITS = 32
# Blocks the dW grid aims at: the H100's 132 SMs, one block each (two fit
# an SM). A constant: the plan reads the shapes, never the card, so every
# card and every rank computes the same slices and the same bits.
DW_BLOCKS = 132
DW_MIN_STEPS = 4  # 64-row stages a slice sums at least, where the rows allow
# Rows a slice sums at most, within DW_MAX_SPLITS: wgmma's fp32 accumulator
# drifts from a float32 matmul of the same products as a slice grows (on
# an H100, 1.0-1.2e-5 of max-abs at 9-12K rows; the products hold 1e-5)
DW_MAX_ROWS = 4096


def dw_plan(rows: int, E: int, H: int, N: int) -> Tuple[int, int]:
    """(splits, rows a slice) of the dW product's T·B reduction: slice z
    sums rows [z·per, min(rows, (z+1)·per)), ``per`` a multiple of
    ``DW_ROW_TILE``; no slice is empty, and
    ``csrc/products.cuh`` ``dw_slice_rows(rows, splits)`` gives back
    ``per``. The count fills ``DW_BLOCKS`` with the output tiles
    ((⌈E/128⌉ + ⌈H/128⌉)·⌈N/128⌉ a slice), keeps a slice within
    ``DW_MAX_ROWS`` rows and above ``DW_MIN_STEPS`` stages where the rows
    allow, and stays within ``DW_MAX_SPLITS``: at E=H=128, T=50, the GRU
    (6 tiles a slice) takes 25 slices at B=128 and 30 at B=2304, the LSTM
    (8 tiles) 20 and 30. Shapes only."""
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    tiles = (cdiv(E, PRODUCT_TILE) + cdiv(H, PRODUCT_TILE)) * cdiv(N, PRODUCT_TILE)
    want = max(1, min(DW_MAX_SPLITS, max(cdiv(DW_BLOCKS, tiles), cdiv(rows, DW_MAX_ROWS)),
                      rows // (DW_MIN_STEPS * DW_ROW_TILE)))
    # slices of whole stages, rounded down so that there are at least
    # `want` of them; then the rows a slice that dw_slice_rows gives back
    short = max(DW_ROW_TILE, rows // want // DW_ROW_TILE * DW_ROW_TILE)
    splits = min(DW_MAX_SPLITS, cdiv(rows, short))
    per = cdiv(cdiv(rows, splits), DW_ROW_TILE) * DW_ROW_TILE
    return cdiv(rows, per), per


def check_widths(kernel: str, E: int, H: int) -> None:
    """Raise unless the recurrent kernels take (E, H): multiples of 16 (a
    wgmma k-slice of the products, and the recurrences' m16 tiles)."""
    if E < 16 or H < 16 or E % 16 or H % 16:
        raise ValueError(f"{kernel}: needs E, H positive multiples of 16 (E={E}, H={H})")


def _bwd_launch(cell, xs, ys, cs, mask, wx, wh, b, dys, dfin, wt=None,
                cluster: Optional[int] = None, *, _rows: Optional[int] = None,
                _active: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """``csrc/{gru,lstm}_bwd.cu`` on CUDA tensors → (dxs, dWx, dWh, db,
    gates [T,B,G·H] fp32, dgates_b [T,B,G·H] bf16). ``wt``:
    ``fused_weight_t(wx, wh)`` where the caller has it; ``cluster``: the
    dh loop's blocks (the smallest that fits if None), in tiles of R rows
    (``card_dh_tile``); ``_rows`` and ``_active`` force the tile's R and
    the card's active clusters (for tests and measurements; not a user
    setting). The db partials come one row for each 8 rows of B, on every
    tile."""
    G = _n_gates(cell)
    name = f"{cell}_bwd"
    T, B, E = xs.shape
    H = wh.shape[0]
    N = G * H
    args = {
        "xs": (xs, torch.bfloat16, (T, B, E)),
        "ys": (ys, torch.bfloat16, (T, B, H)),
        "mask": (mask, torch.float32, (T, 1, B)),
        "wx": (wx, torch.bfloat16, (E, N)),
        "wh": (wh, torch.bfloat16, (H, N)),
        "b": (b, torch.float32, (N,)),
        "dys": (dys, torch.bfloat16, (T, B, H)),
        "dfin": (dfin, torch.float32, (B, H)),
    }
    if cell == "lstm":
        if cs is None:
            raise ValueError("lstm backward: needs cs, the forward's bf16 c stream")
        args["cs"] = (cs, torch.bfloat16, (T, B, H))
    _check_args(name, args)
    wt = fused_weight_t(wx, wh) if wt is None else wt
    _check_args(name, {"xs": args["xs"], "wt": (wt, torch.bfloat16, (N, E + H))})
    check_widths(name, E, H)
    C = _cluster_of(name, "dh", G, H, cluster)
    lib = _build.library()
    rows_fn = getattr(lib, f"sse_{name}_block_rows")
    rows_fn.restype = ctypes.c_int
    rows_fn.argtypes = []
    dev = xs.device
    dxs = torch.empty((T, B, E), dtype=torch.bfloat16, device=dev)
    dw = torch.empty((E + H, N), dtype=torch.float32, device=dev)  # [dWx; dWh]
    db = torch.empty((N,), dtype=torch.float32, device=dev)
    M = T * B
    gates = torch.empty((T, B, N), dtype=torch.float32, device=dev)
    dgb = torch.empty((T, B, N), dtype=torch.bfloat16, device=dev)
    if M == 0:
        return dxs, dw[:E].zero_(), dw[E:].zero_(), db.zero_(), gates, dgb
    nblk = -(-B // rows_fn())
    splits = dw_plan(M, E, H, N)[0]
    R = 0 if C == 1 else card_dh_tile(dev, G, H, B, C, _rows, _active).R
    # scratch: the db and dW partial sums
    db_part = torch.empty((nblk, N), dtype=torch.float32, device=dev)
    w_part = torch.empty((splits, E + H, N), dtype=torch.float32, device=dev)
    ptrs = [xs, ys, *([cs] if cell == "lstm" else []), mask, wt, wx, wh, b, dys, dfin,
            gates, dgb, db_part, w_part, dxs, dw, db]
    _build.launch(
        f"sse_{name}", [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 7, dev,
        *(p.data_ptr() for p in ptrs), T, B, E, H, splits, C, R,
    )
    launches[name] += 1
    if C > 1:
        launches[f"{name}_cluster"] += 1
    return dxs, dw[:E], dw[E:], db, gates, dgb


def gru_bwd_launch(xs, ys, mask, wx, wh, b, dys, dfin, wt=None,
                   cluster: Optional[int] = None, *, _rows: Optional[int] = None,
                   _active: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The GRU backward on CUDA tensors (contiguous, 16-byte aligned: xs,
    ys, dys, wx, wh bf16; mask, b, dfin fp32), which also returns the
    kernels' intermediates: (dxs, dWx, dWh, db, gates [T,B,3H] fp32,
    dgates_b [T,B,3H] bf16), for checks that hold each rounding point.
    ``_rows``, ``_active``: as ``_bwd_launch``."""
    return _bwd_launch("gru", xs, ys, None, mask, wx, wh, b, dys, dfin, wt, cluster,
                       _rows=_rows, _active=_active)


def lstm_bwd_launch(xs, ys, cs, mask, wx, wh, b, dys, dfin,
                    cluster: Optional[int] = None, *, _rows: Optional[int] = None,
                    _active: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The LSTM backward on CUDA tensors (as ``gru_bwd_launch``, plus cs
    bf16) → (dxs, dWx, dWh, db, gates [T,B,4H] fp32, dgates_b [T,B,4H]
    bf16)."""
    return _bwd_launch("lstm", xs, ys, cs, mask, wx, wh, b, dys, dfin, None, cluster,
                       _rows=_rows, _active=_active)


def rnn_layer_bwd(
    xs: torch.Tensor,
    ys: torch.Tensor,
    mask: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    dys: torch.Tensor,
    dfin: torch.Tensor,
    cs: Optional[torch.Tensor] = None,
    cell: str = "gru",
    wt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer backward: the Hopper kernels on CUDA tensors (which must
    be contiguous and 16-byte aligned: xs, ys, cs, dys, wx, wh bf16; mask,
    b, dfin fp32), the plain version on CPU tensors. ``cs`` is the LSTM's
    c stream; ``wt`` is ``fused_weight_t(wx, wh)`` where the caller has it
    (the kernels build it otherwise). On the card the operands are padded
    to ``layer_plan``'s widths and the gradients cut back. Returns (dxs
    bf16, dWx, dWh, db fp32)."""
    if not _on_card(xs):
        return rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell)
    G, E, H = _n_gates(cell), xs.shape[2], wh.shape[0]
    plan = layer_plan(cell, E, H)
    if (plan.E_p, plan.H_p) != (E, H):
        xs, wx, wh, b = pad_layer(xs, wx, wh, b, G, plan.E_p, plan.H_p)
        ys, dys, dfin = (pad_units(t, plan.H_p) for t in (ys, dys, dfin))
        cs = None if cs is None else pad_units(cs, plan.H_p)
        wt = None
    out = _bwd_launch(cell, xs, ys, cs, mask, wx, wh, b, dys, dfin, wt, plan.dh_cluster)
    return unpad_grads(*out[:4], G, E, H)


class RNNLayer(torch.autograd.Function):
    """Differentiable recurrent layer: ``RNNLayer.apply(xs, mask, wx, wh,
    b, cell="gru")`` → (ys bf16, fin fp32). Forward is ``rnn_layer``,
    backward ``rnn_layer_bwd`` (port of the ``jax.custom_vjp`` at
    ``pallas_rnn.py:441-466``); the LSTM saves its bf16 c stream for the
    backward. ``fused_weight_t`` is built once per forward: the forward
    kernels take it, and it is saved for the backward's gate recompute.
    On the card the operands are padded once, to ``layer_plan``'s widths,
    and saved so; outputs and gradients are cut back to the layer's.
    The float32 weights are cast to bf16 inside, so their gradients come
    back in float32, unrounded; ``dxs`` is bf16 and is cast to the dtype
    ``xs`` came in; ``mask`` gets none."""

    @staticmethod
    def forward(ctx, xs, mask, wx, wh, b, cell="gru"):
        ctx.xs_dtype, ctx.b_shape, ctx.cell = xs.dtype, b.shape, cell
        args = _cast_layer(xs, mask, wx, wh, b)
        ctx.widths = (args[0].shape[2], args[3].shape[0])
        ctx.plan = None
        if _on_card(args[0]):
            ctx.plan, args = _card_layer(*args, cell)
        wt = fused_weight_t(args[2], args[3])
        ys, fin, cs = _layer_fwd(*args, cell, wt)
        ctx.save_for_backward(*args, ys, cs, wt)
        H = ctx.widths[1]
        return _cut(ys, H), _cut(fin, H)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys, dfin):
        xs, mask, wx, wh, b, ys, cs, wt = ctx.saved_tensors
        H_p = ys.shape[2]
        # an output that fed nothing (ys of a lone final-readout layer)
        if dys is None:
            dys = torch.zeros_like(ys)
        if dfin is None:
            dfin = torch.zeros(ys.shape[1:], dtype=torch.float32, device=ys.device)
        dys = _aligned(pad_units(dys.to(torch.bfloat16), H_p))
        dfin = _aligned(pad_units(dfin.to(torch.float32), H_p))
        if ctx.plan is None:
            grads = rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cs, ctx.cell, wt)
        else:
            grads = unpad_grads(*_bwd_launch(ctx.cell, xs, ys, cs, mask, wx, wh, b, dys, dfin,
                                             wt, ctx.plan.dh_cluster)[:4],
                                _n_gates(ctx.cell), *ctx.widths)
        dxs, dwx, dwh, db = grads
        return dxs.to(ctx.xs_dtype), None, dwx, dwh, db.reshape(ctx.b_shape), None


__all__ = [
    "CLUSTERS",
    "LayerPlan",
    "RNNLayer",
    "ScanTile",
    "active_clusters",
    "bf16_matmul",
    "bwd_products",
    "card_dh_tile",
    "card_scan_tile",
    "check_widths",
    "cluster_split",
    "dh_rows_most",
    "dh_threads",
    "dh_tile",
    "dw_plan",
    "fused_weight_t",
    "gru_bwd_chain",
    "gru_bwd_launch",
    "gru_cell",
    "gru_fwd_launch",
    "launches",
    "layer_gates",
    "layer_plan",
    "lstm_bwd_chain",
    "lstm_bwd_launch",
    "lstm_cell",
    "lstm_fwd_launch",
    "pad_gates",
    "pad_layer",
    "pad_units",
    "rnn_fwd_launch",
    "rnn_encode",
    "rnn_layer",
    "rnn_layer_bwd",
    "rnn_layer_bwd_reference",
    "rnn_layer_reference",
    "rnn_scan_launch",
    "scan_layer",
    "scan_layer_reference",
    "scan_rows_most",
    "scan_tile",
    "split_weights",
    "unpad_gates",
    "unpad_grads",
    "widest_hidden",
]
