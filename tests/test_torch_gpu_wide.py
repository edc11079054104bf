"""The recurrent kernels at every width ``layer_plan`` places (marker
``gpu``; each test skips where torch sees no card). Run on the card with
``python -m pytest --noconftest tests/test_torch_gpu_wide.py``.

- The cluster instances (the scan, the split GRU forward, the dh loops
  on 2 to 8 blocks) against their plain versions, forward and backward,
  GRU H = 192, 256, 384 and LSTM H = 176, 256, 384, on ragged lengths
  with rows masked at every step. Forward: fin atol 2e-3 / rtol 1e-3,
  bf16 ys one ulp (rtol 2^-7), as tests/test_torch_gpu_kernels.py holds
  H=128. Backward: dxs to 1e-2 and dWx, dWh, db to 1e-3 of max-abs end to
  end, and every rounding point as test_lstm_bwd_rounding_points holds it
  (the plain chain driven by the kernels' dgates_b: dgates_b and dxs to
  one ulp, the gates, dW and db to 1e-5 of max-abs). H=128's short-T
  end-to-end bound on dxs (one ulp plus 1e-4 of max-abs) is not held: the
  gate recompute's float32 sums (one [xs;h]·[Wx;Wh] product over E+H
  terms, against two in the plain version) put a few dgates at the other
  side of a bf16 rounding edge, each flip moving dxs past it, as at H=128
  with B=2304 (seen here at H=384, B=300, T=1 and at H=192, B=2304, T=1);
  the rounding points hold each of those steps to one ulp instead.
- C=2 against C=1, bit for bit, where both fit: the cluster instance
  sums in the single block's order.
- Each layout mirror of ops/rnn.py against the library's
  ``sse_*_smem_bytes``; the cluster scan's and the cluster dh loop's tile
  mirrors (bytes and threads for R rows, the card's active clusters).
- The cluster scan's tiles (R rows a cluster, chosen from B and the
  card's active clusters): the same bits on every tile forced (8 rows and
  the plan's R, one active cluster and the card's count, every cluster
  size that takes H) at B=4096, H=256 and 384, both cells. The cluster
  dh loop's tiles likewise: every R it takes, forced, gives the launch's
  own bits in dxs, dWx, dWh, db and dgates_b, at B=300 and 4096, ragged
  lengths and dead rows.
- ``RNNLayer`` at widths that pad or split against the plain version; an
  H=256 layer, at B=64 and B=4096, replayed from a CUDA graph against
  eager, bit for bit; the cluster kernels on every card.
"""

import ctypes

import pytest
import torch

import test_torch_gpu_kernels as k

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


def _layer(gen, cell, T, B, E, H, dead_rows=()):
    G = 3 if cell == "gru" else 4
    wx = (torch.randn((E, G * H), generator=gen, device="cuda") * 0.06).bfloat16()
    wh = (torch.randn((H, G * H), generator=gen, device="cuda") * 0.06).bfloat16()
    b = torch.randn((G * H,), generator=gen, device="cuda") * 0.05
    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    mask = k._ragged_mask(gen, T, B, dead_rows)
    dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
    dfin = torch.randn((B, H), generator=gen, device="cuda")
    return xs, mask, wx, wh, b, dys, dfin


def _dead(B):
    return sorted({0, B // 2, B - 1})


WIDE = [("gru", 192), ("gru", 256), ("gru", 384), ("lstm", 176), ("lstm", 256), ("lstm", 384)]


@pytest.mark.parametrize("T", [1, 20])
@pytest.mark.parametrize("B", [1, 8, 256, 300, 2304, 4096])
@pytest.mark.parametrize("cell,H", WIDE)
def test_cluster_forward_matches_plain(cuda, cell, H, B, T):
    """The split layer forward (x-product, then the cluster scan) and the
    scan alone over the same ax, against the plain versions, on the tile
    each launch picks (B=4096: many rows a cluster)."""
    from sse_tpu_torch.ops import rnn

    xs, mask, wx, wh, b, _, _ = _layer(cuda, cell, T, B, 128, H, _dead(B))
    plan = rnn.layer_plan(cell, 128, H)
    assert plan.fwd == "split" and plan.scan_cluster > 1
    before = dict(rnn.launches)
    got = rnn.rnn_layer(xs, mask, wx, wh, b, cell)
    ax = rnn._x_product(xs, wx, b)
    scanned = rnn.scan_layer(ax, mask, wh, cell)
    torch.cuda.synchronize()
    assert rnn.launches["rnn_scan_cluster"] == before["rnn_scan_cluster"] + 2
    name = "lstm_fwd" if cell == "lstm" else "gru_fwd_split"
    assert rnn.launches[name] == before[name] + 1 and rnn.launches["gru_fwd"] == before["gru_fwd"]
    want = rnn.rnn_layer_reference(xs, mask, wx, wh, b, cell)
    k_hold(got, want[:2])
    k_hold(scanned, rnn.scan_layer_reference(ax, mask, wh, cell))
    for ys, fin in (got, scanned):
        assert ys.shape == (T, B, H) and not (fin[_dead(B)].any() or ys[:, _dead(B)].float().any())


def k_hold(got, want):
    (ys, fin), (rys, rfin) = got, want
    torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(ys.float(), rys.float(), atol=2e-3, rtol=2.0**-7)


@pytest.mark.parametrize("T", [1, 20])
@pytest.mark.parametrize("B", [1, 8, 256, 300, 384, 2304, 4096])
@pytest.mark.parametrize("cell,H", WIDE)
def test_cluster_backward_matches_plain(cuda, cell, H, B, T):
    """The backward whose dh loop runs on the cluster instance, on the
    tile its launch picks (B=256 and 384: the train bench's towers; 4096:
    many rows a cluster), fed the kernels' forward, against the plain
    backward; rows masked at every step get no input gradient."""
    from sse_tpu_torch.ops import rnn

    xs, mask, wx, wh, b, dys, dfin = _layer(cuda, cell, T, B, 128, H, _dead(B))
    assert rnn.layer_plan(cell, 128, H).dh_cluster > 1
    ys, _, cs = _forward(rnn, xs, mask, wx, wh, b, cell)
    before = dict(rnn.launches)
    got = rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell)
    torch.cuda.synchronize()
    assert rnn.launches[f"{cell}_bwd_cluster"] == before[f"{cell}_bwd_cluster"] + 1
    assert not got[0][:, _dead(B)].float().abs().any()
    want = rnn.rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell)
    gx, wx_ = got[0].float(), want[0].float()
    assert float((gx - wx_).abs().max()) <= 1e-2 * float(wx_.abs().max())
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())
    _rounding_points(rnn, cell, xs, ys, cs, mask, wx, wh, b, dys, dfin)


def _rounding_points(rnn, cell, xs, ys, cs, mask, wx, wh, b, dys, dfin):
    """The backward at the plan's padded widths, each rounding point held
    as tests/test_torch_gpu_kernels.py::test_lstm_bwd_rounding_points
    holds it."""
    from chip_smoke import held_to_one_ulp

    G = 3 if cell == "gru" else 4
    plan = rnn.layer_plan(cell, xs.shape[2], wh.shape[0])
    xs, wx, wh, b = rnn.pad_layer(xs, wx, wh, b, G, plan.E_p, plan.H_p)
    ys, dys, dfin = (rnn.pad_units(t, plan.H_p) for t in (ys, dys, dfin))
    cs = None if cs is None else rnn.pad_units(cs, plan.H_p)
    dxs, dwx, dwh, db, gates, dgb = rnn._bwd_launch(cell, xs, ys, cs, mask, wx, wh, b, dys, dfin,
                                                    None, plan.dh_cluster)
    h_prev = rnn._h_prev(ys)
    if cell == "lstm":
        dgb_r, db_r = rnn.lstm_bwd_chain(gates, rnn._h_prev(cs), mask, wh, dys, dfin, drive=dgb)
    else:
        dgb_r, db_r = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin, drive=dgb)
    dxs_r, dwx_r, dwh_r = rnn.bwd_products(xs, h_prev, wx, dgb)
    held_to_one_ulp("dgates_b", dgb_r, dgb)
    held_to_one_ulp("dxs", dxs, dxs_r)
    for g, w in ((gates, rnn.layer_gates(xs, h_prev, wx, wh, b)), (dwx, dwx_r), (dwh, dwh_r),
                 (db, db_r)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def _forward(rnn, xs, mask, wx, wh, b, cell):
    """ys and (LSTM) cs of the kernels' forward at the layer's widths."""
    if cell == "gru":
        return (*rnn.rnn_layer(xs, mask, wx, wh, b), None)
    plan = rnn.layer_plan("lstm", xs.shape[2], wh.shape[0])
    args = rnn.pad_layer(xs, wx, wh, b, 4, plan.E_p, plan.H_p)
    ys, fin, cs, _ = rnn.rnn_fwd_launch(args[0], mask, *args[1:], "lstm",
                                        cluster=plan.scan_cluster)
    H = wh.shape[0]
    return ys[..., :H].contiguous(), fin[:, :H].contiguous(), cs[..., :H].contiguous()


@pytest.mark.parametrize("H", [128, 160])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_two_blocks_equal_one(cuda, cell, H):
    """C=2 against C=1 bit for bit: ys, fin, cs of the split forward and
    of the scan; dgates_b, dxs, dW and db of the backward where the
    single block's dh loop fits (the LSTM's only at H=128), the cluster
    dh loop on 8 rows a cluster and on its most."""
    from sse_tpu_torch.ops import rnn

    xs, mask, wx, wh, b, dys, dfin = _layer(cuda, cell, 20, 300, 128, H, _dead(300))
    one = rnn.rnn_fwd_launch(xs, mask, wx, wh, b, cell, cluster=1)
    two = rnn.rnn_fwd_launch(xs, mask, wx, wh, b, cell, cluster=2)
    for g, w in zip(two, one):
        assert (g is None and w is None) or torch.equal(g, w)
    ax = one[3]
    assert all(torch.equal(g, w) for g, w in
               zip(rnn.rnn_scan_launch(ax, mask, wh, cell, 2),
                   rnn.rnn_scan_launch(ax, mask, wh, cell, 1)))
    if cell == "lstm" and H != 128:
        assert rnn.dh_smem(4, H, 1) > 232_448
        return
    ys, cs = one[0], one[2]
    launch = rnn.lstm_bwd_launch if cell == "lstm" else rnn.gru_bwd_launch
    extra = (cs,) if cell == "lstm" else ()
    b1 = launch(xs, ys, *extra, mask, wx, wh, b, dys, dfin, cluster=1)
    G = 3 if cell == "gru" else 4
    for R in (8, rnn.dh_rows_most(G, H, 2)):
        b2 = launch(xs, ys, *extra, mask, wx, wh, b, dys, dfin, cluster=2, _rows=R)
        for name, g, w in zip(("dxs", "dwx", "dwh", "db", "gates", "dgates_b"), b2, b1):
            assert torch.equal(g, w), (name, R)


def _lib_int(name, *args):
    from sse_tpu_torch.ops import _build

    fn = getattr(_build.library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args)
    return fn(*args)


def test_layout_mirrors_match_the_library(cuda):
    from sse_tpu_torch.ops import rnn

    for H in range(16, 513, 16):
        for G, cell in ((3, "gru"), (4, "lstm")):
            assert rnn.scan_smem(G, H) == _lib_int("sse_rnn_scan_smem_bytes", G, H), (G, H)
            assert rnn.dh_smem(G, H) == _lib_int(f"sse_{cell}_bwd_smem_bytes", H), (G, H)
            for C in rnn.CLUSTERS[1:]:
                if H % (16 * C):
                    continue
                assert rnn.scan_smem(G, H, C) == _lib_int(
                    "sse_rnn_scan_cluster_smem_bytes", G, H, C), (G, H, C)
                assert rnn.dh_smem(G, H, C) == _lib_int(
                    f"sse_{cell}_bwd_cluster_smem_bytes", H, C), (G, H, C)
        for E in (16, 100 // 16 * 16, 128, 256, 272):
            assert rnn.gru_fwd_smem(E, H) == _lib_int("sse_gru_fwd_smem_bytes", E, H), (E, H)


def test_tile_mirrors_match_the_library(cuda):
    """ops/rnn.py's mirrors of the cluster scan's and the cluster dh
    loop's tiles against the library's: shared memory and threads a block
    for R rows, and the card's active clusters of each plan's shape (at
    least one); a dh cluster size that is no power of two is refused."""
    from sse_tpu_torch.ops import rnn

    dev = torch.device("cuda", torch.cuda.current_device())
    for H in range(32, 385, 16):
        for G, cell in ((3, "gru"), (4, "lstm")):
            for C in rnn.CLUSTERS[1:]:
                if H % (16 * C) or H // C > rnn.CLUSTER_UNITS:
                    continue
                for R in range(8, 257, 8):
                    assert rnn.scan_smem(G, H, C, R) == _lib_int(
                        "sse_rnn_scan_cluster_rows_smem_bytes", G, H, C, R), (G, H, C, R)
                    split = rnn.cluster_split(G, H, C, R)
                    assert (split[2] if split else 0) == _lib_int(
                        "sse_rnn_scan_cluster_threads", G, H, C, R), (G, H, C, R)
                    assert rnn.dh_smem(G, H, C, R) == _lib_int(
                        f"sse_{cell}_bwd_cluster_rows_smem_bytes", H, C, R), (G, H, C, R)
                    assert (rnn.dh_threads(G, H, C, R) or 0) == _lib_int(
                        f"sse_{cell}_bwd_cluster_threads", H, C, R), (G, H, C, R)
    for cell, H in WIDE:
        G = 3 if cell == "gru" else 4
        plan = rnn.layer_plan(cell, 128, H)
        n = rnn.active_clusters(dev, G, plan.H_p, plan.scan_cluster)
        assert n >= 1 and n == _lib_int("sse_rnn_scan_cluster_active", G, plan.H_p,
                                        plan.scan_cluster,
                                        rnn.scan_rows_most(G, plan.H_p, plan.scan_cluster))
        C = plan.dh_cluster
        n = rnn.active_clusters(dev, G, plan.H_p, C, "dh")
        assert n >= 1 and n == _lib_int(f"sse_{cell}_bwd_cluster_active", plan.H_p, C,
                                        rnn.dh_rows_most(G, plan.H_p, C))
    # the dh loop's exchange picks ranks modulo a power of two: the library
    # refuses any other cluster size (cudaErrorInvalidValue)
    for cell in ("gru", "lstm"):
        for C in (3, 5, 6, 7):
            assert _lib_int(f"sse_{cell}_bwd_cluster_active", 48 * C, C, 8) == -1, (cell, C)


@pytest.mark.parametrize("cell,H", [("gru", 256), ("lstm", 256), ("gru", 384), ("lstm", 384)])
def test_tiles_keep_the_bits(cuda, cell, H):
    """The split forward and the scan at B=4096 on every tile the tests
    can force: 8 rows a cluster and the plan's R, one active cluster and
    the card's count, and each cluster size that takes H: the bits of the
    launch's own choice (ys, fin, cs and ax)."""
    from sse_tpu_torch.ops import rnn

    G = 3 if cell == "gru" else 4
    B = 4096
    xs, mask, wx, wh, b, _, _ = _layer(cuda, cell, 6, B, 128, H, _dead(B))
    plan = rnn.layer_plan(cell, 128, H)
    tile = rnn.card_scan_tile(xs.device, G, H, B, plan.scan_cluster)
    assert tile.R > 8 and tile.waves == -(-tile.clusters // tile.active)
    want = rnn.rnn_fwd_launch(xs, mask, wx, wh, b, cell, cluster=plan.scan_cluster)
    scanned = rnn.rnn_scan_launch(want[3], mask, wh, cell, plan.scan_cluster)
    sizes = [c for c in rnn.CLUSTERS if c >= plan.scan_cluster
             and rnn._refusal("scan", G, H, c) is None]
    forced = ([dict(_rows=8), dict(_rows=tile.R), dict(_active=1), dict(_active=tile.active)]
              + [dict(cluster=c) for c in sizes])
    for kw in forced:
        kw = {"cluster": plan.scan_cluster, **kw}
        got = rnn.rnn_fwd_launch(xs, mask, wx, wh, b, cell, **kw)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w), kw
        got = rnn.rnn_scan_launch(want[3], mask, wh, cell, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, scanned)), kw
    assert torch.equal(scanned[0], want[0]) and torch.equal(scanned[1], want[1])


@pytest.mark.parametrize("B", [300, 4096])
@pytest.mark.parametrize("cell,H", [("gru", 256), ("lstm", 256), ("gru", 384), ("lstm", 384)])
def test_dh_tiles_keep_the_bits(cuda, cell, H, B):
    """The backward at B rows, ragged lengths and dead rows, on every tile
    its cluster dh loop takes, forced (each R from 8 to the most, one
    active cluster and the card's count): the bits of the launch's own
    choice in dxs, dWx, dWh, db and dgates_b (and the recomputed gates)."""
    from sse_tpu_torch.ops import rnn

    G = 3 if cell == "gru" else 4
    xs, mask, wx, wh, b, dys, dfin = _layer(cuda, cell, 6, B, 128, H, _dead(B))
    ys, _, cs = _forward(rnn, xs, mask, wx, wh, b, cell)
    plan = rnn.layer_plan(cell, 128, H)
    C = plan.dh_cluster
    tile = rnn.card_dh_tile(xs.device, G, H, B, C)
    most = rnn.dh_rows_most(G, H, C)
    assert tile.R > 8 and tile.waves == -(-tile.clusters // tile.active)
    launch = rnn.lstm_bwd_launch if cell == "lstm" else rnn.gru_bwd_launch
    extra = (cs,) if cell == "lstm" else ()
    want = launch(xs, ys, *extra, mask, wx, wh, b, dys, dfin, cluster=C)
    forced = ([dict(_rows=R) for R in range(8, most + 1, 8)]
              + [dict(_active=1), dict(_active=tile.active)])
    for kw in forced:
        got = launch(xs, ys, *extra, mask, wx, wh, b, dys, dfin, cluster=C, **kw)
        for name, g, w in zip(("dxs", "dwx", "dwh", "db", "gates", "dgates_b"), got, want):
            assert torch.equal(g, w), (name, kw)
    assert not want[0][:, _dead(B)].float().abs().any()
    with pytest.raises(ValueError, match="multiple of 8"):
        launch(xs, ys, *extra, mask, wx, wh, b, dys, dfin, cluster=C, _rows=most + 8)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("E,H", [(256, 128), (128, 256), (256, 256), (100, 100)])
def test_rnn_layer_function_at_other_widths(cuda, cell, E, H):
    """RNNLayer forward and backward on the plan's route against the plain
    layer and backward at the layer's widths."""
    from sse_tpu_torch.ops import rnn

    xs, mask, wx, wh, b, dys, dfin = _layer(cuda, cell, 20, 40, E, H, (3,))
    leaves = [t.float().clone().requires_grad_(True) for t in (xs, wx, wh, b)]
    ys, fin = rnn.RNNLayer.apply(leaves[0], mask, *leaves[1:], cell)
    assert ys.shape == (20, 40, H) and fin.shape == (40, H)
    want = rnn.rnn_layer_reference(xs, mask, wx, wh, b, cell)
    k_hold((ys, fin), want[:2])
    ((ys.float() * dys.float()).sum() + (fin * dfin).sum()).backward()
    cs = _forward(rnn, xs, mask, wx, wh, b, cell)[2]  # the c stream RNNLayer saved
    ref = rnn.rnn_layer_bwd_reference(xs, ys.detach(), mask, wx, wh, b, dys, dfin, cs, cell)
    got = [t.grad for t in leaves]
    k._check_bwd([got[0].bfloat16(), *got[1:]], ref, 20)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_graph_replay_of_a_wide_layer_equals_eager(cuda, cell):
    """An H=256 layer, forward and backward, captured in a CUDA graph and
    replayed on new inputs: the same bits as eager calls."""
    _replay_equals_eager(cuda, cell, 64)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_graph_replay_of_a_wide_batch_equals_eager(cuda, cell):
    """The same at B=4096, where the scan and the dh loop carry many rows
    a cluster: the eager warm-up asks the card's active clusters, the
    capture finds them kept."""
    _replay_equals_eager(cuda, cell, 4096)


def _replay_equals_eager(gen, cell, B):
    from sse_tpu_torch.ops import rnn

    args = _layer(gen, cell, 20, B, 128, 256, (5,))
    static = [t.clone() for t in args]

    def run():
        xs, mask, wx, wh, b, dys, dfin = static
        ys, fin, cs = _forward(rnn, xs, mask, wx, wh, b, cell)
        return (ys, fin, *rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    fresh = _layer(torch.Generator(device="cuda").manual_seed(7), cell, 20, B, 128, 256, (9,))
    for s, f in zip(static, fresh):
        s.copy_(f)
    graph.replay()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in out]
    eager = run()
    for g, w in zip(replayed, eager):
        assert torch.equal(g, w)


def test_cluster_kernels_on_every_card(cuda):
    """The cluster forward and backward at H=256 on each card of the
    process: one draw of inputs, copied to every card, gives card 0's bits
    there, on the tile the launch picks and on the dh loop's most rows a
    cluster, and card 0's are held against the plain versions (the forward
    as above, the backward end to end and at every rounding point). The
    same draw on every card, because a draw's end-to-end dW bound belongs
    to the draw, not to the card: the LSTM draw of seed 1 misses 1e-3 of
    max-abs on dWx (1.43e-3) on any card, its rounding points held."""
    from sse_tpu_torch.ops import rnn

    for cell in ("gru", "lstm"):
        draw = _layer(cuda, cell, 20, 72, 128, 256, (1,))
        first = None
        for i in range(torch.cuda.device_count()):
            with torch.cuda.device(i):
                xs, mask, wx, wh, b, dys, dfin = (t.to(f"cuda:{i}") for t in draw)
                ys, fin, cs = _forward(rnn, xs, mask, wx, wh, b, cell)
                got = rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, dys, dfin, cs, cell)
                assert got[1].device == torch.device("cuda", i)
                G = 3 if cell == "gru" else 4
                C = rnn.layer_plan(cell, 128, 256).dh_cluster
                most = rnn._bwd_launch(cell, xs, ys, cs, mask, wx, wh, b, dys, dfin, None, C,
                                       _rows=rnn.dh_rows_most(G, 256, C))
                assert all(torch.equal(g, w) for g, w in zip(most[:4], got))
                outs = [t.cpu() for t in (ys, fin, *got)]
            if first is None:
                first = outs
                k_hold((ys, fin), rnn.rnn_layer_reference(xs, mask, wx, wh, b, cell)[:2])
                k._check_bwd(got, rnn.rnn_layer_bwd_reference(xs, ys, mask, wx, wh, b, dys,
                                                              dfin, cs, cell), 20)
                _rounding_points(rnn, cell, xs, ys, cs, mask, wx, wh, b, dys, dfin)
            else:
                assert all(torch.equal(g, w) for g, w in zip(outs, first)), (cell, i)
