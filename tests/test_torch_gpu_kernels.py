"""The port's Hopper kernels against their plain PyTorch versions on a
CUDA card (marker ``gpu``; each test skips where torch sees no card).
Run on the card with ``python -m pytest tests/test_torch_gpu_kernels.py``;
``chip_smoke.py`` makes the same comparisons at the serving shapes.

Tolerances: top-k rows and values bit-identical (exact-dot inputs make
every float32 sum exact, int8 sums are exact integers); GRU and LSTM fin
to atol 2e-3 / rtol 1e-3, bf16 ys and cs to one bf16 ulp (rtol 2^-7), the
same for the scan kernel. GRU and LSTM backward, as
``chip_smoke.check_bwd`` states and explains: dWx, dWh, db to 1e-3
of each tensor's max-abs; dxs to one bf16 ulp plus 1e-4 of its max-abs
where the dh chain is short (T = 1, and the step t = T-1), and to 1e-2
of its max-abs over all T=50 steps; at each rounding point (the plain
chain driven by the kernels' dgates_b) to one bf16 ulp and 1e-5 of
max-abs; tower gradients to 3e-2 of each leaf's max-abs (the pin of
tests/test_ops_rnn.py).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.Generator(device="cuda").manual_seed(0)


def _exact(shape, gen):
    return (torch.randint(-16, 17, shape, generator=gen, device="cuda") / 16).bfloat16()


def _check_gru_fwd(gen, T, B, E, H):
    """The GRU layer forward kernel against its plain version on ragged
    lengths, with row 0 masked at every step and, where T > 1, step 1
    masked for every row."""
    from sse_tpu_torch.ops import rnn

    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(T, device="cuda")[:, None] < lens).float()[:, None, :]
    mask[:, :, 0] = 0.0
    if T > 1:
        mask[1] = 0.0
    mask = mask.contiguous()
    wx = (torch.randn((E, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((3 * H,), generator=gen, device="cuda") * 0.05
    n = rnn.launches["gru_fwd"]
    ys, fin = rnn.rnn_layer(xs, mask, wx, wh, b)
    assert rnn.launches["gru_fwd"] == n + 1
    rys, rfin = rnn.rnn_layer_reference(xs, mask, wx, wh, b)
    torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(ys.float(), rys.float(), atol=2e-3, rtol=2.0**-7)
    assert not (fin[0].any() or ys[:, 0].float().any())  # the dead row never moves
    if T > 1:
        assert torch.equal(ys[1], ys[0])  # a step masked for all rows carries h over


# B: one 16-row tile and its edges (1, 15, 16, 17, 33), the served B=8, a
# training-sized batch, and 2113 (133 tiles: more than one wave of SMs)
@pytest.mark.parametrize("T", [1, 2, 20])
@pytest.mark.parametrize("B", [1, 8, 15, 16, 17, 33, 300, 2113])
def test_gru_kernel_matches_plain(cuda, T, B):
    _check_gru_fwd(cuda, T, B, 128, 128)


# widths other than E=H=128 take the generic instance ([Wx;Wh]ᵀ in shared
# memory, xs read from global memory): H=176 is its widest, (272, 96) its
# largest [Wx;Wh]ᵀ
@pytest.mark.parametrize("E,H", [(64, 96), (16, 176), (272, 96)])
def test_gru_kernel_other_widths(cuda, E, H):
    _check_gru_fwd(cuda, 20, 40, E, H)


def test_gru_fwd_takes_the_fused_weight(cuda):
    """gru_fwd_launch with the caller's [Wx;Wh]ᵀ (what RNNLayer hands it)
    gives what it gives when it builds that layout itself; a wrongly
    shaped one raises."""
    from sse_tpu_torch.ops import rnn

    T, B, E, H = 6, 20, 128, 128
    xs = torch.randn((T, B, E), generator=cuda, device="cuda").bfloat16()
    mask = torch.ones((T, 1, B), device="cuda")
    wx = (torch.randn((E, 3 * H), generator=cuda, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 3 * H), generator=cuda, device="cuda") * 0.08).bfloat16()
    b = torch.randn((3 * H,), generator=cuda, device="cuda") * 0.05
    wt = rnn.fused_weight_t(wx, wh)
    got = rnn.gru_fwd_launch(xs, mask, wx, wh, b, wt)
    want = rnn.gru_fwd_launch(xs, mask, wx, wh, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="wt"):
        rnn.gru_fwd_launch(xs, mask, wx, wh, b, wt.t().contiguous())


# the streaming kernel at every row width (bf16 D = 32 / 64 / 128, int8
# D = 64 / 128 / 256: 64-, 128- and 256-byte rows) and float32; B: a lone
# query, the interactive tier and its 16-row edges, one and two 64-query
# groups and their edges, and 1500 (ragged groups of 128)
WIDTHS = [("bf16", 32), ("bf16", 64), ("bf16", 128), ("int8", 64), ("int8", 128),
          ("int8", 256), ("f32", 128)]
STREAM_B = [1, 8, 15, 16, 17, 64, 65, 256, 1500]


def _topk_data(gen, dtype, d, B, t=20480):
    """Exact-dot bf16 / float32 rows (every float32 sum exact, in any
    order), or int8 unit rows with float unit queries (exact int sums)."""
    from sse_tpu_torch.index.sharded_index import quantize_rows

    if dtype == "int8":
        x = torch.randn((t, d), generator=gen, device="cuda")
        q = torch.randn((B, d), generator=gen, device="cuda")
        return quantize_rows(x / x.norm(dim=1, keepdim=True), torch.int8), q / q.norm(dim=1, keepdim=True)
    emb, q = _exact((t, d), gen), _exact((B, d), gen)
    return (emb.float(), q.float()) if dtype == "f32" else (emb, q)


def _hold_stream(q, emb, k, num_real, variant):
    """The streaming call (one launch of its counter) bit-identical to
    topk_reference; sinks: exactly float32(-3e38) for exact, finite below
    -1e37 for packed, row 0 either way."""
    from sse_tpu_torch.ops import topk

    name = "topk_exact" if variant == "exact" else "topk_stream"
    n = topk.launch_total(name)
    got = topk.fused_score_topk(q, emb, k, num_real, variant=variant)
    assert topk.launch_total(name) == n + 1
    want = topk.topk_reference(q, emb, k, num_real, variant=variant)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    real = min(num_real, k)
    sink = (got[0][:, real:] == -3.0e38) if variant == "exact" else (got[0][:, real:] < -1e37)
    assert sink.all() and (got[1][:, real:] == 0).all()
    return got


# num_real: fewer than k, two points inside the last 2048-row block, all
@pytest.mark.parametrize("num_real", [5, 19000, 20000, 20480])
@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("B", STREAM_B)
@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_topk_kernels_match_plain(cuda, dtype, d, B, variant, num_real):
    """Streaming, and for the packed variant the two-phase call and both
    phase kernels, bit-identical to plain at every row width."""
    from sse_tpu_torch.ops import topk

    t, k = 20480, 10
    emb, q = _topk_data(cuda, dtype, d, B, t)
    got = _hold_stream(q, emb, k, num_real, variant)
    if variant == "exact":
        return
    tp = topk.fused_score_topk_twophase(q, emb, k, num_real, block_t=2048)
    assert torch.equal(tp[1], got[1]) and torch.equal(tp[0], got[0])
    qk, _ = topk._prep_queries(q, emb)
    p1 = topk.twophase_phase1(qk, emb, k, num_real, 2048)
    assert torch.equal(p1, topk.twophase_phase1_reference(qk, emb, k, num_real, 2048))
    tq, tb, _ = topk.pair_schedule(p1, t // 2048)
    assert torch.equal(
        topk.twophase_phase2(qk, emb, k, num_real, 2048, tq, tb),
        topk.twophase_phase2_reference(qk, emb, k, num_real, 2048, tq, tb),
    )


# k from one to the kernel's 128; num_real: none, fewer than k, a 128-row
# tile's edges, a 4096-row window's edges, all
@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("num_real", [0, 5, 127, 128, 129, 4095, 4096, 4097, 20480])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_topk_exact_kernel_matches_plain(cuda, dtype, d, k, num_real, variant):
    """Both variants (counters topk_stream, topk_exact) bit-identical to
    their plain versions at every k and num_real edge, B = 65 (two query
    groups, or one group of 128); sinks exactly float32(-3e38) for exact,
    finite for packed, row 0."""
    emb, q = _topk_data(cuda, dtype, d, 65)
    _hold_stream(q, emb, k, num_real, variant)


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_topk_stream_zero_query_rows(cuda, dtype, variant):
    """An all-zero query row (and a -0.0 one in bf16) keys every score as
    +0.0: rows 0..k-1, value +0.0, through both list merges (k = 100)."""
    emb, q = _topk_data(cuda, dtype, 128, 70)
    q[3] = 0
    if dtype == "bf16":
        q[5] = -0.0
    for k in (10, 100):
        got = _hold_stream(q, emb, k, 20480, variant)
        for i in (3, 5) if dtype == "bf16" else (3,):
            assert got[1][i].tolist() == list(range(k))
            assert (got[0][i] == 0).all() and not torch.signbit(got[0][i]).any()


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_topk_stream_massive_ties(cuda, dtype, variant):
    """Eight distinct index rows repeated over 40,960 rows: equal keys in
    every tile and every split, where the lowest rows must win (k = 10 and
    128, B = 8 and 300)."""
    gen = cuda
    t, d = 40960, 128
    base = torch.randint(-2, 3, (8, d), generator=gen, device="cuda").float()
    emb = base[torch.randint(0, 8, (t,), generator=gen, device="cuda")]
    q = torch.randint(-2, 3, (300, d), generator=gen, device="cuda").float()
    if dtype == "int8":
        emb, q = (emb * 40).to(torch.int8), (q * 40).to(torch.int8)
    else:
        emb, q = (emb / 4).bfloat16(), (q / 4).bfloat16()
    for B in (8, 300):
        for k in (10, 128):
            got = _hold_stream(q[:B].contiguous(), emb, k, t - 3, variant)
            assert all(len(set(r)) == k for r in got[1].tolist())


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_stream_equals_twophase_on_random_rows(cuda, dtype):
    """On random unit rows (float32 sums inexact) the streaming and the
    two-phase routes score through the same wgmma tile, so they rank
    every query row alike at B = 1024."""
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    x = torch.randn((40960, 128), generator=cuda, device="cuda")
    y = torch.randn((1024, 128), generator=cuda, device="cuda")
    x, y = x / x.norm(dim=1, keepdim=True), y / y.norm(dim=1, keepdim=True)
    emb, q = (x.bfloat16(), y.bfloat16()) if dtype == "bf16" else (quantize_rows(x, torch.int8), y)
    st = topk.fused_score_topk(q, emb, 10, 40000)
    tp = topk.fused_score_topk_twophase(q, emb, 10, 40000, block_t=2048)
    assert torch.equal(st[1], tp[1]) and torch.equal(st[0], tp[0])


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_stream_call_never_syncs_the_host(cuda, dtype, variant):
    """The whole streaming call (query prep, the plan, the kernel, the
    select) under torch.cuda.set_sync_debug_mode("error"), and its result;
    torch.profiler shows the wgmma kernel, and no range_topk kernel."""
    from sse_tpu_torch.ops import topk

    emb, q = _topk_data(cuda, dtype, 128, 300)
    want = topk.topk_reference(q, emb, 10, 20000, variant=variant)
    topk.fused_score_topk(q, emb, 10, 20000, variant=variant)  # build and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = topk.fused_score_topk(q, emb, 10, 20000, variant=variant)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    names = [e.key for e in prof.key_averages()]
    assert any("wg_stream_kernel" in n for n in names), names
    assert not any("topk_stream_kernel" in n for n in names), names


def test_topk_exact_negative_zero(cuda):
    """Products that are all -0.0 score +0.0 in the kernel and the plain
    version alike: ties to the lower row."""
    from sse_tpu_torch.ops import topk

    q = torch.zeros((8, 64), device="cuda", dtype=torch.bfloat16)
    q[:, 0] = -1.0
    emb = torch.full((4096, 64), -0.5, device="cuda", dtype=torch.bfloat16)
    emb[:, 0] = 0.0
    emb[77, 0] = -0.25
    got = topk.fused_score_topk(q, emb, 10, 4096, variant="exact")
    want = topk.topk_reference(q, emb, 10, 4096, variant="exact")
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert got[1][0].tolist() == [77] + list(range(9))


def _twophase_data(gen, dtype, d, b, t=20480):
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.ops import topk

    if dtype == "int8":
        x = torch.randn((t, d), generator=gen, device="cuda")
        y = torch.randn((b, d), generator=gen, device="cuda")
        return (quantize_rows(x / x.norm(dim=1, keepdim=True), torch.int8),
                topk.quantize_queries_int8(y / y.norm(dim=1, keepdim=True)))
    return _exact((t, d), gen), _exact((b, d), gen)


def _hold_twophase_phases(q, emb, k, num_real, block_t):
    """The wgmma phase kernels bit-identical to their plain versions (each
    launching once); phase 2 on the schedule of the plain phase 1."""
    from sse_tpu_torch.ops import topk

    n1, n2 = topk.launch_total("twophase_p1"), topk.launch_total("twophase_p2")
    p1 = topk.twophase_phase1(q, emb, k, num_real, block_t)
    want1 = topk.twophase_phase1_reference(q, emb, k, num_real, block_t)
    assert torch.equal(p1, want1)
    tq, tb, _ = topk.pair_schedule(want1, emb.shape[0] // block_t)
    p2 = topk.twophase_phase2(q, emb, k, num_real, block_t, tq, tb)
    assert torch.equal(p2, topk.twophase_phase2_reference(q, emb, k, num_real, block_t, tq, tb))
    assert (topk.launch_total("twophase_p1"), topk.launch_total("twophase_p2")) == (n1 + 1, n2 + 1)
    return tq, tb, p2


# 64-, 128- and 256-byte rows of both types; B: a lone query, a ragged
# group of 17, and 1000 / 1500 (four and six 256-query groups, the last
# ragged)
@pytest.mark.parametrize("dtype,d", [("bf16", 32), ("bf16", 64), ("bf16", 128), ("int8", 64),
                                     ("int8", 128), ("int8", 256)])
@pytest.mark.parametrize("B", [1, 17, 1000, 1500])
def test_twophase_phase_kernels_match_plain(cuda, dtype, d, B):
    emb, q = _twophase_data(cuda, dtype, d, B)
    _hold_twophase_phases(q, emb, 10, 19000, 2048)


# num_real at the block and tile edges: none, fewer than k, a block's last
# row, a whole block, one row into the next, all
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("num_real", [0, 5, 2047, 2048, 2049, 20480])
def test_twophase_phase_kernels_num_real_edges(cuda, dtype, num_real):
    emb, q = _twophase_data(cuda, dtype, 128, 300)
    tq, tb, p2 = _hold_twophase_phases(q, emb, 10, num_real, 2048)
    if num_real == 0:
        assert (tb == -1).all() and (p2 == -(2**63)).all()


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_twophase_zero_query_rows_and_spare_tiles(cuda, dtype):
    """An all-zero query row (and a -0.0 one in bf16) keys every score as
    +0.0: rows 0..k-1, value 0.0, as the plain version gives them; spare
    tiles (block -1) and missing queries (id -1) come out empty."""
    from sse_tpu_torch.ops import topk

    emb, q = _twophase_data(cuda, dtype, 128, 70)
    q[3] = 0
    if dtype == "bf16":
        q[5] = -0.0
    tq, tb, p2 = _hold_twophase_phases(q, emb, 10, 20480, 2048)
    spare = (tb == -1).nonzero().flatten()
    assert spare.numel() > 0 and (p2.view(tb.shape[0], 64, 10)[spare] == -(2**63)).all()
    missing = (tq == -1) & (tb.repeat_interleave(64) >= 0)
    assert missing.any() and (p2[missing] == -(2**63)).all()
    got = topk.fused_score_topk_twophase(q, emb, 10, 20480, block_t=2048)
    want = topk.topk_reference(q, emb, 10, 20480)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for i in (3, 5) if dtype == "bf16" else (3,):
        assert got[1][i].tolist() == list(range(10))
        assert (got[0][i] == 0).all() and not torch.signbit(got[0][i]).any()


def test_twophase_phase_kernels_other_blocks(cuda):
    """Blocks of one score tile (128 rows) and of 4096 rows (the most a
    phase-2 candidate's local row field holds); other block sizes raise."""
    from sse_tpu_torch.ops import topk

    emb, q = _twophase_data(cuda, "bf16", 128, 300)
    for bt in (128, 4096):
        _hold_twophase_phases(q, emb, 10, 20000, bt)
    with pytest.raises(ValueError, match="multiple of 128"):
        topk.twophase_phase1(q, emb, 10, 20000, 64)
    tq = torch.full((64,), -1, dtype=torch.int32, device="cuda")
    tb = torch.full((1,), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most 4096"):
        topk.twophase_phase2(q, emb, 10, 20000, 8192, tq, tb)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_twophase_call_never_syncs_the_host(cuda, dtype):
    """The whole two-phase call (phase 1, select, mid-pass, phase 2,
    merge) under torch.cuda.set_sync_debug_mode("error"), and its result."""
    from sse_tpu_torch.ops import topk

    emb, q = _twophase_data(cuda, dtype, 128, 1024)
    want = topk.topk_reference(q, emb, 10, 20000)
    topk.fused_score_topk_twophase(q, emb, 10, 20000, block_t=2048)  # build and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = topk.fused_score_topk_twophase(q, emb, 10, 20000, block_t=2048)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype,d", [("bf16", 32), ("int8", 64), ("bf16", 64), ("int8", 256)])
def test_engine_bulk_batch_at_every_row_width(cuda, dtype, d):
    """A packed engine batch of TWOPHASE_MIN_BATCH queries takes the
    two-phase kernels at every row width, 64-byte rows included, and
    returns the streaming kernel's rows (one score tile: the same float32
    scores) on random unit rows; int8 sums are exact, so int8 also equals
    topk_reference."""
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.models import sse, towers
    from sse_tpu_torch.ops import topk
    from sse_tpu_torch.serve import engine

    tower = towers.TowerConfig(vocab_size=100, embed_dim=128, hidden=128, encoding_dim=d)
    cfg = sse.SSEConfig(mode=sse.NetworkMode.SHARED_ENCODER, src_tower=tower)
    params = sse.init_params(cfg, torch.Generator().manual_seed(0))
    b, n_tok, t, nr = topk.TWOPHASE_MIN_BATCH, 12, 20480, 20000
    toks = torch.randint(2, 100, (b, n_tok), generator=cuda, device="cuda")
    lens = torch.randint(1, n_tok + 1, (b,), generator=cuda, device="cuda")
    x = torch.randn((t, d), generator=cuda, device="cuda")
    emb = quantize_rows(x / x.norm(dim=1, keepdim=True),
                        torch.bfloat16 if dtype == "bf16" else torch.int8)
    n1, ns = topk.launch_total("twophase_p1"), topk.launch_total("topk_stream")
    got = engine.build_fused_query_fn(cfg, k=10, num_real=nr)(params, emb, toks, lens)
    assert (topk.launch_total("twophase_p1"), topk.launch_total("topk_stream")) == (n1 + 1, ns)
    q = sse.encode_source(params, cfg, toks, lens)
    want = topk.fused_score_topk(q, emb, 10, nr)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if dtype == "int8":
        want = topk.topk_reference(q, emb, 10, nr)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_cuda_wrappers_raise_on_bad_input(cuda):
    from sse_tpu_torch.ops import topk

    q = torch.zeros((4, 96), device="cuda", dtype=torch.bfloat16)  # 192-byte rows
    emb = torch.zeros((256, 96), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64, 128 or 256 bytes"):
        topk.fused_score_topk(q, emb, 5, 256)
    with pytest.raises(ValueError, match="k <= 128"):
        topk.fused_score_topk(q[:, :64].contiguous(), emb[:, :64].contiguous(), 200, 256)


def _gru_bwd_args(gen, T, B, E=128, H=128, dead_rows=()):
    from sse_tpu_torch.ops import rnn

    wx = (torch.randn((E, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 3 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((3 * H,), generator=gen, device="cuda") * 0.05
    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(T, device="cuda")[:, None] < lens).float()[:, None, :]
    mask[:, :, list(dead_rows)] = 0.0
    mask = mask.contiguous()
    ys, _ = rnn.rnn_layer(xs, mask, wx, wh, b)
    dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
    dfin = torch.randn((B, H), generator=gen, device="cuda")
    return xs, ys, mask, wx, wh, b, dys, dfin


def _check_bwd(got, want, T):
    gx, wx = got[0].float(), want[0].float()
    ulp = dict(atol=1e-4 * float(wx.abs().max()), rtol=2.0**-7)
    if T == 1:
        torch.testing.assert_close(gx, wx, **ulp)
    else:
        torch.testing.assert_close(gx[-1], wx[-1], **ulp)
    assert float((gx - wx).abs().max()) <= 1e-2 * float(wx.abs().max())
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max())


@pytest.mark.parametrize("T", [1, 50])
@pytest.mark.parametrize("B", [1, 16, 17, 33, 384])
def test_gru_bwd_kernel_matches_plain(cuda, T, B):
    from sse_tpu_torch.ops import rnn

    args = _gru_bwd_args(cuda, T, B)
    n = rnn.launches["gru_bwd"]
    got = rnn.rnn_layer_bwd(*args)
    torch.cuda.synchronize()
    assert rnn.launches["gru_bwd"] == n + 1
    assert got[0].dtype == torch.bfloat16 and got[0].shape == args[0].shape
    _check_bwd(got, rnn.rnn_layer_bwd_reference(*args), T)


def test_gru_bwd_rounding_points(cuda):
    """chip_smoke's pinned check at T=50, B=384: the plain chain fed the
    kernels' gates and driven by their dgates_b matches that dgates_b,
    and the products of it match dxs, dWx, dWh (bounds of
    chip_smoke.held_to_one_ulp; 1e-5 of max-abs for the fp32 tensors)."""
    from chip_smoke import held_to_one_ulp
    from sse_tpu_torch.ops import rnn

    args = _gru_bwd_args(cuda, 50, 384)
    xs, ys, mask, wx, wh, b, dys, dfin = args
    dxs, dwx, dwh, db, gates, dgb = rnn.gru_bwd_launch(*args)
    h_prev = rnn._h_prev(ys)
    dgb_r, db_r = rnn.gru_bwd_chain(gates, h_prev, mask, wh, dys, dfin, drive=dgb)
    dxs_r, dwx_r, dwh_r = rnn.bwd_products(xs, h_prev, wx, dgb)
    held_to_one_ulp("dgates_b", dgb_r, dgb)
    held_to_one_ulp("dxs", dxs, dxs_r)
    for g, w in ((gates, rnn.layer_gates(xs, h_prev, wx, wh, b)), (dwx, dwx_r),
                 (dwh, dwh_r), (db, db_r)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# the tile edges of the 16-row dh blocks, and the train bench's B=384
@pytest.mark.parametrize("B", [1, 16, 17, 33, 384])
def test_gru_bwd_fully_masked_rows(cuda, B):
    """Rows masked at every step get no input gradient (dgates = 0, the
    dh chain passes through) and leave the rest as the plain version."""
    from sse_tpu_torch.ops import rnn

    dead = sorted({0, B // 2, B - 1})
    args = _gru_bwd_args(cuda, 20, B, dead_rows=dead)
    got = rnn.rnn_layer_bwd(*args)
    assert not got[0][:, dead].float().abs().any()
    _check_bwd(got, rnn.rnn_layer_bwd_reference(*args), 20)
    dead = args[2].clone()
    dead.zero_()
    got = rnn.rnn_layer_bwd(args[0], args[1], dead, *args[3:])
    assert not (got[0].float().abs().any() or got[1].any() or got[2].any() or got[3].any())


# the dh loop's generic instance (one input stage): H=96, and H=176, the
# widest the backward's shared memory takes
@pytest.mark.parametrize("E,H", [(64, 96), (16, 176)])
def test_gru_bwd_other_widths(cuda, E, H):
    from sse_tpu_torch.ops import rnn

    args = _gru_bwd_args(cuda, 20, 40, E, H, dead_rows=(3,))
    got = rnn.rnn_layer_bwd(*args)
    assert not got[0][:, 3].float().abs().any()
    _check_bwd(got, rnn.rnn_layer_bwd_reference(*args), 20)


def _tower_gradients(cfg, want_fired):
    """Every parameter's gradient of a tower from the kernels (CUDA)
    against the plain versions (the same params on the CPU), and the
    kernel launches of one forward and backward."""
    from sse_tpu_torch.models import towers
    from sse_tpu_torch.ops import rnn
    from sse_tpu_torch.train.loop import tree_leaves, tree_map

    base = towers.init_tower(cfg, torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(2, 500, (48, 20), generator=g)
    lens = torch.randint(1, 21, (48,), generator=g)
    w = torch.randn((48, 64), generator=g)
    grads = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda p: p.to(dev).requires_grad_(True), base)
        before = dict(rnn.launches)
        out = towers.encode_raw(params, cfg, toks.to(dev), lens.to(dev))
        (out * w.to(dev)).sum().backward()
        fired = {k: rnn.launches[k] - before[k] for k in before if rnn.launches[k] != before[k]}
        assert fired == (want_fired if dev == "cuda" else {})
        grads[dev] = [p.grad.cpu().double() for p in tree_leaves(params)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).abs().max()) <= 3e-2 * float(want.abs().max())


def test_tower_gradients_match_plain(cuda):
    """A 2-layer residual GRU tower: two forward and two backward launches."""
    from sse_tpu_torch.models import towers

    cfg = towers.TowerConfig(vocab_size=500, embed_dim=128, hidden=128, num_layers=2,
                             encoding_dim=64, residual=True)
    _tower_gradients(cfg, {"gru_fwd": 2, "gru_bwd": 2})


def test_lstm_tower_gradients_match_plain(cuda):
    """The qna tower at two residual layers (LSTM, attention readout): two
    LSTM forward launches (each runs the scan kernel) and two backward."""
    from sse_tpu_torch.models import towers

    cfg = towers.TowerConfig(vocab_size=500, embed_dim=128, hidden=128, num_layers=2,
                             encoding_dim=64, residual=True, cell="lstm", readout="attention")
    _tower_gradients(cfg, {"lstm_fwd": 2, "rnn_scan": 2, "lstm_bwd": 2})


def test_gru_bwd_raises_on_bad_input(cuda):
    from sse_tpu_torch.ops import rnn

    args = list(_gru_bwd_args(cuda, 4, 8))
    bad_dfin = args[:7] + [args[7].bfloat16()]
    with pytest.raises(ValueError, match="dfin"):
        rnn.rnn_layer_bwd(*bad_dfin)
    strided = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="xs"):
        rnn.rnn_layer_bwd(strided, *args[1:])
    with pytest.raises(ValueError, match="wh"):
        rnn.rnn_layer_bwd(*args[:4], args[4].cpu(), *args[5:])


# ------------------------------------------------------------ LSTM and scan
# B: a lone row, one 8-row tile and its edges (7, 8, 9, 16, 17, 33), the
# qna source tower (128), a ragged batch (300) and the qna target tower
# (2304: 16-row blocks, more than one wave of SMs); T: one step, the ring
# and stage edges (2, 3) and the main path's 50
LSTM_B = [1, 7, 8, 9, 16, 17, 33, 128, 300, 2304]
LSTM_T = [1, 2, 3, 50]


def _ragged_mask(gen, T, B, dead_rows=()):
    """[T, 1, B] float mask of ragged lengths, ``dead_rows`` masked at
    every step."""
    lens = torch.randint(1, T + 1, (B,), generator=gen, device="cuda")
    mask = (torch.arange(T, device="cuda")[:, None] < lens).float()[:, None, :]
    mask[:, :, list(dead_rows)] = 0.0
    return mask.contiguous()


def _check_lstm_fwd(gen, T, B, E, H):
    """The LSTM layer forward kernel (x-product, then the scan) against
    its plain version on ragged lengths, with row 0 masked at every step
    and, where T > 1, step 1 masked for every row."""
    from sse_tpu_torch.ops import rnn

    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    mask = _ragged_mask(gen, T, B, dead_rows=(0,))
    if T > 1:
        mask[1] = 0.0
    wx = (torch.randn((E, 4 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 4 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((4 * H,), generator=gen, device="cuda") * 0.05
    before = dict(rnn.launches)
    ys, fin, cs, ax = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
    assert rnn.launches["lstm_fwd"] == before["lstm_fwd"] + 1
    assert rnn.launches["rnn_scan"] == before["rnn_scan"] + 1
    rys, rfin, rcs = rnn.rnn_layer_reference(xs, mask, wx, wh, b, "lstm")
    torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3)
    for g, w in ((ys, rys), (cs, rcs)):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-3, rtol=2.0**-7)
    ax_r = rnn._x_product(xs, wx, b)
    assert float((ax - ax_r).abs().max()) <= 1e-5 * float(ax_r.abs().max())
    assert not (fin[0].any() or ys[:, 0].float().any() or cs[:, 0].float().any())
    if T > 1:  # a step masked for all rows carries h and c over
        assert torch.equal(ys[1], ys[0]) and torch.equal(cs[1], cs[0])


@pytest.mark.parametrize("T", LSTM_T)
@pytest.mark.parametrize("B", LSTM_B)
def test_lstm_kernel_matches_plain(cuda, B, T):
    _check_lstm_fwd(cuda, T, B, 128, 128)


# widths other than E=H=128 take the generic scan instance (Whᵀ in shared
# memory, ax read from global memory): H=160 is the LSTM's widest
@pytest.mark.parametrize("E,H", [(64, 96), (16, 160), (272, 96), (128, 144)])
def test_lstm_kernel_other_widths(cuda, E, H):
    _check_lstm_fwd(cuda, 20, 40, E, H)


def test_lstm_fwd_takes_the_fused_weight(cuda):
    """lstm_fwd_launch with the caller's [Wx;Wh]ᵀ (what RNNLayer hands it)
    gives what it gives when it builds that layout itself; a wrongly
    shaped one raises."""
    from sse_tpu_torch.ops import rnn

    T, B, E, H = 6, 20, 128, 128
    xs = torch.randn((T, B, E), generator=cuda, device="cuda").bfloat16()
    mask = torch.ones((T, 1, B), device="cuda")
    wx = (torch.randn((E, 4 * H), generator=cuda, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 4 * H), generator=cuda, device="cuda") * 0.08).bfloat16()
    b = torch.randn((4 * H,), generator=cuda, device="cuda") * 0.05
    wt = rnn.fused_weight_t(wx, wh)
    got = rnn.lstm_fwd_launch(xs, mask, wx, wh, b, wt)
    want = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="wt"):
        rnn.lstm_fwd_launch(xs, mask, wx, wh, b, wt[:, : E + H - 16].contiguous())


def _check_scan(gen, cell, T, B, H):
    from sse_tpu_torch.ops import rnn

    G = 3 if cell == "gru" else 4
    ax = torch.randn((T, B, G * H), generator=gen, device="cuda")
    wh = (torch.randn((H, G * H), generator=gen, device="cuda") * 0.08).bfloat16()
    mask = _ragged_mask(gen, T, B, dead_rows=(0,))
    n = rnn.launches["rnn_scan"]
    ys, fin = rnn.scan_layer(ax, mask, wh, cell)
    assert rnn.launches["rnn_scan"] == n + 1
    rys, rfin = rnn.scan_layer_reference(ax, mask, wh, cell)
    torch.testing.assert_close(fin, rfin, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(ys.float(), rys.float(), atol=2e-3, rtol=2.0**-7)
    assert not (fin[0].any() or ys[:, 0].float().any())


@pytest.mark.parametrize("T", LSTM_T)
@pytest.mark.parametrize("B", LSTM_B)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_kernel_matches_plain(cuda, cell, B, T):
    _check_scan(cuda, cell, T, B, 128)


# the generic scan instance: H=176 is the GRU cell's widest, 160 the LSTM's
@pytest.mark.parametrize("cell,H", [("gru", 96), ("gru", 176), ("lstm", 96), ("lstm", 160)])
def test_scan_kernel_other_widths(cuda, cell, H):
    _check_scan(cuda, cell, 20, 40, H)


def _lstm_bwd_args(gen, T, B, E=128, H=128, dead_rows=()):
    from sse_tpu_torch.ops import rnn

    wx = (torch.randn((E, 4 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    wh = (torch.randn((H, 4 * H), generator=gen, device="cuda") * 0.08).bfloat16()
    b = torch.randn((4 * H,), generator=gen, device="cuda") * 0.05
    xs = torch.randn((T, B, E), generator=gen, device="cuda").bfloat16()
    mask = _ragged_mask(gen, T, B, dead_rows)
    ys, _, cs, _ = rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
    dys = (torch.randn((T, B, H), generator=gen, device="cuda") * 0.1).bfloat16()
    dfin = torch.randn((B, H), generator=gen, device="cuda")
    return (xs, ys, mask, wx, wh, b, dys, dfin), cs


# B=2304 at T <= 2 goes to the rounding-point test below: with 2304 live
# rows the gate recompute's fp32 sum order (one [xs;h]·[Wx;Wh] product,
# against cuBLAS's two in the plain version) puts ~45 of 1.18M dgates at
# the other side of a bf16 rounding edge, and each such flip moves dxs by
# more than the short-T bound's one ulp plus 1e-4 of max-abs (the
# parent's kernels, the same)
@pytest.mark.parametrize("B,T", [(B, T) for B in LSTM_B for T in LSTM_T
                                 if not (B == 2304 and T <= 2)])
def test_lstm_bwd_kernel_matches_plain(cuda, B, T):
    from sse_tpu_torch.ops import rnn

    args, cs = _lstm_bwd_args(cuda, T, B)
    n = rnn.launches["lstm_bwd"]
    got = rnn.rnn_layer_bwd(*args, cs=cs, cell="lstm")
    torch.cuda.synchronize()
    assert rnn.launches["lstm_bwd"] == n + 1
    assert got[0].dtype == torch.bfloat16 and got[0].shape == args[0].shape
    _check_bwd(got, rnn.rnn_layer_bwd_reference(*args, cs, "lstm"), T)


# the tile edges of the 8-row dh blocks, and the train bench's B=256
@pytest.mark.parametrize("B", [1, 8, 9, 17, 33, 256])
def test_lstm_bwd_fully_masked_rows(cuda, B):
    """Rows masked at every step get no input gradient (dgates = 0, the dh
    and dc chains pass through) and leave the rest as the plain version."""
    from sse_tpu_torch.ops import rnn

    dead = sorted({0, B // 2, B - 1})
    args, cs = _lstm_bwd_args(cuda, 20, B, dead_rows=dead)
    got = rnn.rnn_layer_bwd(*args, cs=cs, cell="lstm")
    assert not got[0][:, dead].float().abs().any()
    _check_bwd(got, rnn.rnn_layer_bwd_reference(*args, cs, "lstm"), 20)
    dead = args[2].clone()
    dead.zero_()
    got = rnn.rnn_layer_bwd(args[0], args[1], dead, *args[3:], cs=cs, cell="lstm")
    assert not (got[0].float().abs().any() or got[1].any() or got[2].any() or got[3].any())


# the dh loop's generic instance (Wh in shared memory, one input stage):
# H=96, and H=144, the widest the backward's shared memory takes
@pytest.mark.parametrize("E,H", [(64, 96), (16, 144)])
def test_lstm_bwd_other_widths(cuda, E, H):
    from sse_tpu_torch.ops import rnn

    args, cs = _lstm_bwd_args(cuda, 20, 40, E, H, dead_rows=(3,))
    got = rnn.rnn_layer_bwd(*args, cs=cs, cell="lstm")
    assert not got[0][:, 3].float().abs().any()
    _check_bwd(got, rnn.rnn_layer_bwd_reference(*args, cs, "lstm"), 20)


@pytest.mark.parametrize("T,B", [(50, 256), (1, 2304), (2, 2304), (50, 2304)])
def test_lstm_bwd_rounding_points(cuda, T, B):
    """chip_smoke's pinned check for the LSTM: the train bench's B=256,
    and the qna target tower's B=2304 at the short T the end-to-end test
    leaves to it."""
    from chip_smoke import held_to_one_ulp
    from sse_tpu_torch.ops import rnn

    args, cs = _lstm_bwd_args(cuda, T, B)
    xs, ys, mask, wx, wh, b, dys, dfin = args
    dxs, dwx, dwh, db, gates, dgb = rnn.lstm_bwd_launch(xs, ys, cs, *args[2:])
    h_prev = rnn._h_prev(ys)
    dgb_r, db_r = rnn.lstm_bwd_chain(gates, rnn._h_prev(cs), mask, wh, dys, dfin, drive=dgb)
    dxs_r, dwx_r, dwh_r = rnn.bwd_products(xs, h_prev, wx, dgb)
    held_to_one_ulp("dgates_b", dgb_r, dgb)
    held_to_one_ulp("dxs", dxs, dxs_r)
    for g, w in ((gates, rnn.layer_gates(xs, h_prev, wx, wh, b)), (dwx, dwx_r),
                 (dwh, dwh_r), (db, db_r)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_lstm_wrappers_raise_on_what_they_do_not_take(cuda):
    """No fallback: a missing c stream and a CPU weight raise; so does
    H=512, beyond what any instance takes (ops/rnn.py layer_plan: the
    widest H is 384, whose dh loop fills a cluster of 8 blocks; at 512 the
    LSTM scan needs 285,184 B a block even on 8). H=176, which the single
    blocks refused, now pads to 192 and runs on clusters of 2
    (tests/test_torch_gpu_wide.py)."""
    from sse_tpu_torch.ops import rnn

    args, cs = _lstm_bwd_args(cuda, 3, 8)
    with pytest.raises(ValueError, match="needs cs"):
        rnn.rnn_layer_bwd(*args, cell="lstm")
    with pytest.raises(ValueError, match="wh"):
        rnn.lstm_fwd_launch(args[0], args[2], args[3], args[4].cpu(), args[5])
    T, B, E, H = 3, 8, 128, 512
    xs, mask = args[0], args[2]
    wx = torch.zeros((E, 4 * H), device="cuda", dtype=torch.bfloat16)
    wh = torch.zeros((H, 4 * H), device="cuda", dtype=torch.bfloat16)
    b = torch.zeros((4 * H,), device="cuda")
    ys = torch.zeros((T, B, H), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        rnn.lstm_fwd_launch(xs, mask, wx, wh, b)
    with pytest.raises(ValueError, match="shared memory"):
        rnn.scan_layer(torch.zeros((T, B, 4 * H), device="cuda"), mask, wh, "lstm")
    with pytest.raises(ValueError, match="shared memory"):
        rnn.rnn_layer_bwd(xs, ys, mask, wx, wh, b, ys, torch.zeros((B, H), device="cuda"),
                          cs=ys, cell="lstm")


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_topk_kernels_on_every_card(cuda, dtype):
    """The top-k kernels launch on every card of a process, not only the
    first (their shared-memory allowance is a property of the card), and a
    grid of distinct cards returns the unsharded rows: streaming (packed
    and exact) and two-phase on each card against topk_reference there, on
    exact-dot inputs, then a (1, n) grid's fused query against one card."""
    from sse_tpu_torch.index.sharded_index import quantize_rows
    from sse_tpu_torch.models import sse, towers
    from sse_tpu_torch.ops import topk
    from sse_tpu_torch.parallel import RowShards, make_mesh
    from sse_tpu_torch.serve import engine

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    t, nr = 32768, 32000  # 16 two-phase blocks: k=10 of them
    emb = _exact((t, 128), cuda)
    q = _exact((1024, 128), cuda)
    if dtype == "int8":
        emb = quantize_rows(emb.float() / 2, torch.int8)
    for i in range(n):
        dev = torch.device("cuda", i)
        e, qq = emb.to(dev), q.to(dev)
        for b, variant in ((8, "packed"), (8, "exact"), (1024, "packed")):
            want = topk.topk_reference(qq[:b], e, 10, nr, variant)
            if b >= topk.TWOPHASE_MIN_BATCH:
                got = topk.fused_score_topk_twophase(qq[:b], e, 10, nr)
            else:
                got = topk.fused_score_topk(qq[:b], e, 10, nr, variant)
            assert got[1].device == dev
            assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), (i, b, variant)
    tower = towers.TowerConfig(vocab_size=100, embed_dim=128, hidden=128, encoding_dim=128)
    cfg = sse.SSEConfig(mode=sse.NetworkMode.SHARED_ENCODER, src_tower=tower)
    params = sse.init_params(cfg, torch.Generator().manual_seed(0))
    mesh = make_mesh(1, n)
    toks = torch.randint(2, 100, (1024, 12), generator=cuda, device="cuda")
    lens = torch.randint(1, 13, (1024,), generator=cuda, device="cuda")
    for b in (8, 1024):
        want = engine.build_fused_query_fn(cfg, 10, nr)(params, emb, toks[:b], lens[:b])
        got = engine.build_fused_query_fn(cfg, 10, nr, mesh=mesh)(
            params, RowShards.from_tensor(emb, mesh), toks[:b], lens[:b])
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]), b
