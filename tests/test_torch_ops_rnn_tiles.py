"""The cluster scan's and the cluster dh loop's tile plans (``ops/rnn.py``
``scan_tile``, ``dh_tile``), on the CPU: how many batch rows R a cluster
of C blocks carries and how many waves of clusters a launch of B rows
runs, for every (cell, H_p, C) that ``layer_plan`` picks or a launch's
``cluster`` argument can force (H_p <= 384), B in {1, 7, 8, 256, 4096,
10,000} (the scan) or {1, 8, 256, 300, 384, 2304, 4096} (the dh loop)
and 1, 15 or 30 clusters held by the card at once.

- R is a multiple of 8, within the block's threads (256) and shared
  memory (232,448 B), whose bytes equal the source's arithmetic
  (``rnn_scan.cu`` ``cluster_layout``: the Whᵀ slice, then the h tiles and
  the LSTM's c tiles by the row).
- Every batch row is owned exactly once: each warp's unit group covers
  the clusters' tiles, row slice by row slice, as the kernel walks them.
- The launch keeps its C; the waves are the fewest any allowed R gives
  on it, and R is the smallest that gives them.
- ``layer_plan`` is unchanged: the (H_p, scan C, dh C) it picked before
  the tile plans, for every width, and it never asks the card.
- The dh loop: its bytes equal ``dh_cluster.cuh`` ``layout``'s arithmetic
  (the Wh rows, then one or two dgates_b tiles of (G·H+8)·2 bytes a row,
  two where they fit, each with an 8-byte mbarrier), its rows within the
  block's 512 threads (a warp for each 16 units and 8 rows); its db
  partials stay one row of db_part for each 8 batch rows, written once,
  whatever R is; a forced R that the kernel does not take is refused.

The kernel's bits at every tile are held on the card
(tests/test_torch_gpu_wide.py).
"""

import pytest

from sse_tpu_torch.ops import rnn

LIMIT = 232_448
BATCHES = (1, 7, 8, 256, 4096, 10_000)
ACTIVE = (1, 15, 30)

# (cell, H) -> (H_p, scan C, dh C) for E=128, as layer_plan picked them
# before the scan carried more than 8 rows a cluster
PLANS = {
    ("gru", 16): (16, 1, 1), ("gru", 32): (32, 1, 1), ("gru", 48): (48, 1, 1),
    ("gru", 64): (64, 1, 1), ("gru", 80): (80, 1, 1), ("gru", 96): (96, 1, 1),
    ("gru", 112): (112, 1, 1), ("gru", 128): (128, 1, 1), ("gru", 144): (144, 1, 1),
    ("gru", 160): (160, 1, 1), ("gru", 176): (176, 1, 1), ("gru", 192): (192, 2, 2),
    ("gru", 208): (224, 2, 2), ("gru", 224): (224, 2, 2), ("gru", 240): (256, 2, 4),
    ("gru", 256): (256, 2, 4), ("gru", 272): (320, 4, 4), ("gru", 288): (320, 4, 4),
    ("gru", 304): (320, 4, 4), ("gru", 320): (320, 4, 4), ("gru", 336): (384, 8, 8),
    ("gru", 352): (384, 8, 8), ("gru", 368): (384, 8, 8), ("gru", 384): (384, 8, 8),
    ("lstm", 16): (16, 1, 1), ("lstm", 32): (32, 1, 1), ("lstm", 48): (48, 1, 1),
    ("lstm", 64): (64, 1, 1), ("lstm", 80): (80, 1, 1), ("lstm", 96): (96, 1, 1),
    ("lstm", 112): (112, 1, 1), ("lstm", 128): (128, 1, 1), ("lstm", 144): (144, 1, 1),
    ("lstm", 160): (160, 1, 2), ("lstm", 176): (192, 2, 2), ("lstm", 192): (192, 2, 2),
    ("lstm", 208): (256, 4, 4), ("lstm", 224): (256, 4, 4), ("lstm", 240): (256, 4, 4),
    ("lstm", 256): (256, 4, 4), ("lstm", 272): (384, 8, 8), ("lstm", 288): (384, 8, 8),
    ("lstm", 304): (384, 8, 8), ("lstm", 320): (384, 8, 8), ("lstm", 336): (384, 8, 8),
    ("lstm", 352): (384, 8, 8), ("lstm", 368): (384, 8, 8), ("lstm", 384): (384, 8, 8),
}

GATES = {"gru": 3, "lstm": 4}


def _widths(G, H, C):
    """The cluster sizes a launch at the plan's C may be given (its
    ``cluster`` argument): C and every larger one that takes H."""
    return [C] + [c for c in rnn.CLUSTERS if c > C and rnn._refusal("scan", G, H, c) is None]


def _shapes():
    """Every (cell, H_p, C) of the cluster scan that the plan picks or a
    launch can be given."""
    out = set()
    for (cell, H), (H_p, C, _) in PLANS.items():
        if C > 1:
            out.update((cell, H_p, c) for c in _widths(GATES[cell], H_p, C))
    return sorted(out)


def _allowed(G, H, C):
    """Every R the kernel takes on C blocks at hidden H."""
    return [R for R in range(8, 8 * 64 + 1, 8)
            if rnn.cluster_split(G, H, C, R) and rnn.scan_smem(G, H, C, R) <= LIMIT]


def _owners(G, H, C, R, B):
    """How many times each of B rows is owned by one unit group's warps,
    walking the tile as the kernel does: cluster k's rows from k·R; warp
    slice s's from s·NJ·8 in the tile, nj = min(NJ, R/8 - s·NJ) n8 groups,
    with (S, NJ) from ``cluster_split``; each warp's registers and the
    block's threads within their bounds."""
    groups = R // 8
    S, NJ, threads = rnn.cluster_split(G, H, C, R)
    assert threads == 32 * (H // C // 16) * S and threads <= rnn.CLUSTER_THREADS[NJ]
    assert NJ <= rnn.CLUSTER_GROUPS[G] and S * NJ >= groups
    seen = [0] * B
    for k in range(-(-B // R)):
        for s in range(S):
            nj = min(NJ, groups - s * NJ)
            assert 1 <= nj <= NJ
            for r in range(s * NJ * 8, (s * NJ + nj) * 8):
                if k * R + r < B:
                    seen[k * R + r] += 1
    return seen


def test_shapes_cover_the_plans():
    assert _shapes() == [
        ("gru", 192, 2), ("gru", 192, 4), ("gru", 224, 2), ("gru", 256, 2), ("gru", 256, 4),
        ("gru", 256, 8), ("gru", 320, 4), ("gru", 384, 8), ("lstm", 192, 2), ("lstm", 192, 4),
        ("lstm", 256, 4), ("lstm", 256, 8), ("lstm", 384, 8)]


@pytest.mark.parametrize("cell,H,C", _shapes())
def test_tile_plan(cell, H, C):
    G = GATES[cell]
    most = rnn.scan_rows_most(G, H, C)
    assert most == max(_allowed(G, H, C))
    for n in ACTIVE:
        for B in BATCHES:
            tile = rnn.scan_tile(G, H, B, C, n)
            assert tile.C == C and tile.active == n
            R = tile.R
            assert R % 8 == 0 and R in _allowed(G, H, C)
            assert rnn.scan_smem(G, H, C, R) <= LIMIT
            assert tile.clusters == -(-B // R) and tile.waves == -(-tile.clusters // n)
            assert _owners(G, H, C, R, B) == [1] * B
            fewest = min(-(-(-(-B // r)) // n) for r in _allowed(G, H, C))
            assert tile.waves == fewest, (B, n, tile)
            assert all(-(-(-(-B // r)) // n) > fewest for r in _allowed(G, H, C)
                       if r < R), (B, n, tile)


# The table of the source's arithmetic: (G, H, C) -> (the Whᵀ slice, bytes
# a row, the most rows shared memory alone allows)
SOURCE = {
    (4, 256, 4): (135_168, 1_344, 72),
    (4, 256, 8): (67_584, 1_216, 128),
    (4, 384, 8): (150_528, 1_792, 40),
    (3, 256, 2): (202_752, 1_056, 24),
    (3, 256, 4): (101_376, 1_056, 120),
    (3, 384, 8): (112_896, 1_568, 72),
}


# (G, H, C) -> the most rows a block's threads allow: warps = H/(16·C)
# unit groups times the slices, 3 (LSTM) or 4 (GRU) n8 groups a warp
MOST = {
    (4, 256, 4): 48,  # 4 unit groups: 3 slices of 2 groups (384 threads)
    (4, 256, 8): 96,  # 2: 6 slices of 2 (384), or 4 of 3 (256)
    (4, 384, 8): 64,  # 3: 4 slices of 2 (384)
    (3, 256, 2): 32,  # 8: 1 slice of 4 (256)
    (3, 256, 4): 64,  # 4: 2 slices of 4 (256)
    (3, 384, 8): 64,  # 3: 2 slices of 4 (192), 4 of 2 (384)
}


@pytest.mark.parametrize("G,H,C", sorted(SOURCE))
def test_scan_smem_is_the_sources_arithmetic(G, H, C):
    w, per_row, rows = SOURCE[(G, H, C)]
    for R in range(8, 257, 8):
        assert rnn.scan_smem(G, H, C, R) == w + per_row * R
    assert rnn.scan_smem(G, H, C) == w + per_row * 8  # the plan's test: 8 rows
    assert max(R for R in range(8, 257, 8) if rnn.scan_smem(G, H, C, R) <= LIMIT) == rows
    # the registers bound the rest: the block's threads by the groups a warp
    # carries (512, 384, 256 for 1, 2, 3 or 4), 3 groups a warp for the LSTM
    assert rnn.scan_rows_most(G, H, C) == min(rows, MOST[(G, H, C)])


def test_forced_rows_and_refusals():
    tile = rnn.scan_tile(4, 256, 4096, 4, 30, rows=8)
    assert (tile.C, tile.R, tile.clusters, tile.waves) == (4, 8, 512, 18)
    for bad in (4, 12, 72, 0):
        with pytest.raises(ValueError, match="multiple of 8"):
            rnn.scan_tile(4, 256, 4096, 4, 30, rows=bad)
    # the GRU at H=256 keeps its plan's 2 blocks: 24 rows a cluster
    assert rnn.scan_tile(3, 256, 4096, 2, 30) == rnn.ScanTile(2, 24, 171, 30, 6)
    assert rnn.scan_tile(3, 256, 8, 2, 30) == rnn.ScanTile(2, 8, 1, 30, 1)


def test_layer_plan_is_unchanged():
    for (cell, H), want in PLANS.items():
        plan = rnn.layer_plan(cell, 128, H)
        assert (plan.H_p, plan.scan_cluster, plan.dh_cluster) == want, (cell, H)


# ------------------------------------------------------------ the dh loop
DH_BATCHES = (1, 8, 256, 300, 384, 2304, 4096)


def _dh_shapes():
    """Every (cell, H_p, C) of the cluster dh loop that the plan picks or
    a launch can be given."""
    out = set()
    for (cell, H), (H_p, _, C) in PLANS.items():
        if C > 1:
            G = GATES[cell]
            out.update((cell, H_p, c) for c in rnn.CLUSTERS
                       if c >= C and rnn._refusal("dh", G, H_p, c) is None)
    return sorted(out)


def _dh_allowed(G, H, C):
    """Every R the dh kernel takes on C blocks at hidden H."""
    return [R for R in range(8, 8 * 64 + 1, 8)
            if rnn.dh_threads(G, H, C, R) and rnn.dh_smem(G, H, C, R) <= LIMIT]


def _db_rows(G, H, C, R, B):
    """How many times each row of db_part [ceil(B/8), G·H] is written, as
    the kernel writes it: each warp's row group s whose first row is
    below B, row (k·R + 8·s) / 8 of cluster k, once for each unit group's
    columns."""
    assert rnn.dh_threads(G, H, C, R) == 32 * (H // C // 16) * (R // 8)
    seen = [0] * -(-B // 8)
    for k in range(-(-B // R)):
        for s in range(R // 8):
            first = k * R + 8 * s
            if first < B:
                assert first % 8 == 0
                seen[first // 8] += 1
    return seen


def test_dh_shapes_cover_the_plans():
    assert _dh_shapes() == [
        ("gru", 192, 2), ("gru", 192, 4), ("gru", 224, 2), ("gru", 256, 4), ("gru", 256, 8),
        ("gru", 320, 4), ("gru", 384, 8), ("lstm", 160, 2), ("lstm", 192, 2), ("lstm", 192, 4),
        ("lstm", 256, 4), ("lstm", 256, 8), ("lstm", 384, 8)]


@pytest.mark.parametrize("cell,H,C", _dh_shapes())
def test_dh_tile_plan(cell, H, C):
    G = GATES[cell]
    most = rnn.dh_rows_most(G, H, C)
    assert most == max(_dh_allowed(G, H, C))
    for n in ACTIVE:
        for B in DH_BATCHES:
            tile = rnn.dh_tile(G, H, B, C, n)
            assert tile.C == C and tile.active == n
            R = tile.R
            assert R % 8 == 0 and R in _dh_allowed(G, H, C)
            assert tile.clusters == -(-B // R) and tile.waves == -(-tile.clusters // n)
            assert rnn.dh_threads(G, H, C, R) == 32 * (H // C // 16) * (R // 8) <= 512
            fewest = min(-(-(-(-B // r)) // n) for r in _dh_allowed(G, H, C))
            assert tile.waves == fewest, (B, n, tile)
            assert all(-(-(-(-B // r)) // n) > fewest for r in _dh_allowed(G, H, C)
                       if r < R), (B, n, tile)
        for R in _dh_allowed(G, H, C):  # one db_part row for each 8 rows, on every tile
            for B in DH_BATCHES:
                assert _db_rows(G, H, C, R, B) == [1] * -(-B // 8), (R, B)


# The table of the source's arithmetic: (G, H, C) -> (the Wh rows, bytes a
# tile row (a tile also holds its 8-byte mbarrier), the most rows of two
# tiles, of one tile, and the most rows the block's 512 threads allow: a
# warp for each 16 units and 8 rows)
DH_SOURCE = {
    (4, 256, 4): (132_096, 2_064, 24, 48, 32),   # 4 unit groups: 4 row groups
    (4, 384, 8): (148_224, 3_088, 8, 24, 40),    # 3: 5
    (4, 192, 2): (148_992, 1_552, 24, 48, 16),   # 6: 2
    (3, 256, 4): (99_328, 1_552, 40, 80, 32),
    (3, 384, 8): (111_360, 2_320, 24, 48, 40),
    (3, 224, 2): (152_320, 1_360, 24, 56, 16),   # 7: 2
}


@pytest.mark.parametrize("G,H,C", sorted(DH_SOURCE))
def test_dh_smem_is_the_sources_arithmetic(G, H, C):
    wh, per_row, two, one, threads = DH_SOURCE[(G, H, C)]
    for R in range(8, 257, 8):
        tiles = 2 if wh + 2 * (per_row * R + 8) <= LIMIT else 1
        assert tiles == (2 if R <= two else 1), R
        assert rnn.dh_smem(G, H, C, R) == wh + tiles * (per_row * R + 8)
    assert rnn.dh_smem(G, H, C) == rnn.dh_smem(G, H, C, 24)  # the plan's test: 24 rows
    assert max(R for R in range(8, 257, 8) if rnn.dh_smem(G, H, C, R) <= LIMIT) == one
    assert rnn.dh_rows_most(G, H, C) == min(one, threads)


def test_dh_forced_rows_and_refusals():
    tile = rnn.dh_tile(4, 256, 4096, 4, 30, rows=8)
    assert (tile.C, tile.R, tile.clusters, tile.waves) == (4, 8, 512, 18)
    assert rnn.dh_tile(4, 256, 4096, 4, 30) == rnn.ScanTile(4, 32, 128, 30, 5)
    assert rnn.dh_tile(4, 256, 256, 4, 30) == rnn.ScanTile(4, 16, 16, 30, 1)
    assert rnn.dh_tile(3, 256, 384, 4, 30) == rnn.ScanTile(4, 16, 24, 30, 1)
    assert rnn.dh_tile(4, 384, 4096, 8, 15) == rnn.ScanTile(8, 24, 171, 15, 12)
    assert rnn.dh_tile(4, 256, 8, 4, 30) == rnn.ScanTile(4, 8, 1, 30, 1)
    for bad in (4, 12, 40, 0):
        with pytest.raises(ValueError, match="lstm_bwd: a tile of .* multiple of 8 up to 32"):
            rnn.dh_tile(4, 256, 4096, 4, 30, rows=bad)
    with pytest.raises(ValueError, match="gru_bwd: a tile of 48 rows"):
        rnn.dh_tile(3, 384, 4096, 8, 15, rows=48)
