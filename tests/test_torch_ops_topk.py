"""Top-k parity: the PyTorch port's plain versions (what its wrappers run
on CPU tensors) against the JAX package's Pallas kernels in interpret
mode, on the cases of tests/test_ops.py.

Tolerances: rows must be identical; values agree to rtol 2e-2 on
bf16-representable inputs (as tests/test_ops.py states) — in practice
they are equal, because both decode the same 11-bit keys. int8 paths are
exact: rows and values equal. Sink slots (fewer real rows than k) must be
finite (< -1e37) with in-range rows; which in-range row a sink carries is
not part of the contract (the JAX streaming and two-phase kernels differ
there), and the port gives row 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sse_tpu.ops import fused_topk as jtopk
from sse_tpu_torch.ops import topk as ttopk


def _bf16r(x):
    return np.array(jnp.asarray(np.asarray(x)).astype(jnp.bfloat16).astype(jnp.float32))


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _index(dtype, emb):
    """The same index rows for both packages: (jax array, torch tensor)."""
    if dtype == "int8":
        e = np.clip(np.round(emb * 127), -127, 127).astype(np.int8)
        return jnp.asarray(e), torch.from_numpy(e)
    if dtype == "bf16":
        return jnp.asarray(emb).astype(jnp.bfloat16), torch.from_numpy(emb).bfloat16()
    return jnp.asarray(emb), torch.from_numpy(emb)


def _inputs(seed, b, d, t):
    rng = np.random.default_rng(seed)
    q = _bf16r(_unit(rng.normal(size=(b, d)).astype(np.float32)))
    emb = _bf16r(_unit(rng.normal(size=(t, d)).astype(np.float32)))
    return q, emb


def _jax_tp(q, emb, k, num_real, block_t):
    return jax.jit(
        lambda q, e: jtopk.fused_score_topk_twophase(
            q, e, k, num_real, block_t=block_t, interpret=True
        )
    )(q, emb)


def _assert_same(port, ref, num_real, t, rtol=2e-2):
    """Identical rows and values on real slots; finite in-range sinks."""
    pv, pi = (x.numpy() for x in port)
    rv, ri = (np.asarray(x) for x in ref)
    real = min(num_real, pi.shape[1])
    np.testing.assert_array_equal(pi[:, :real], ri[:, :real])
    np.testing.assert_allclose(pv[:, :real], rv[:, :real], rtol=rtol)
    assert np.isfinite(pv).all() and (pv[:, real:] < -1e37).all()
    assert ((pi >= 0) & (pi < t)).all()


@pytest.mark.parametrize(
    "dtype,k,num_real_off",
    [("f32", 1, 0), ("f32", 10, 3), ("bf16", 10, 0), ("bf16", 10, 3),
     ("int8", 10, 0), ("int8", 10, 3)],
)
def test_stream_matches_pallas(dtype, k, num_real_off):
    b, d, t = 8, 32, 512
    q, emb = _inputs(0, b, d, t)
    je, te = _index(dtype, emb)
    num_real = t - num_real_off
    ref = jtopk.fused_score_topk(
        jnp.asarray(q), je, k, num_real, block_t=256, interpret=True
    )
    got = ttopk.fused_score_topk(torch.from_numpy(q), te, k, num_real)
    _assert_same(got, ref, num_real, t, rtol=0 if dtype == "int8" else 2e-2)


def test_tie_breaking():
    """Duplicate max rows → the lower row first (lax.top_k order)."""
    b, d, t = 8, 16, 256
    q = np.ones((b, d), np.float32)
    emb = np.zeros((t, d), np.float32)
    emb[7] = emb[100] = 1.0
    emb[42] = 0.5
    ref = jtopk.fused_score_topk(
        jnp.asarray(q), jnp.asarray(emb), 3, t, block_t=128, interpret=True
    )
    got = ttopk.fused_score_topk(torch.from_numpy(q), torch.from_numpy(emb), 3, t)
    assert list(got[1][0].numpy()) == [7, 100, 42]
    _assert_same(got, ref, t, t)


def test_massive_ties():
    """±1 rows: many exactly equal scores within and across blocks."""
    b, d, t = 8, 16, 768
    rng = np.random.default_rng(7)
    q = np.sign(rng.normal(size=(b, d))).astype(np.float32)
    emb = np.sign(rng.normal(size=(t, d))).astype(np.float32)
    ref = jtopk.fused_score_topk(
        jnp.asarray(q), jnp.asarray(emb), 10, t, block_t=256, interpret=True
    )
    tq, te = torch.from_numpy(q), torch.from_numpy(emb)
    got = ttopk.fused_score_topk(tq, te, 10, t)
    _assert_same(got, ref, t, t)
    tp = ttopk.fused_score_topk_twophase(tq, te, 10, t, block_t=64)
    _assert_same(tp, ref, t, t)
    for r in got[1].numpy():
        assert len(set(r)) == 10


@pytest.mark.parametrize("dtype,num_real", [("f32", 0), ("bf16", 5), ("int8", 5)])
def test_fewer_real_rows_than_k(dtype, num_real):
    """num_real = 0 (a fully padded index) and num_real < k: real slots
    match, the rest are finite sinks with in-range rows."""
    b, d, t = 8, 16, 512
    q, emb = _inputs(3, b, d, t)
    je, te = _index(dtype, emb)
    ref = jtopk.fused_score_topk(
        jnp.asarray(q), je, 10, num_real, block_t=256, interpret=True
    )
    got = ttopk.fused_score_topk(torch.from_numpy(q), te, 10, num_real)
    _assert_same(got, ref, num_real, t, rtol=0 if dtype == "int8" else 2e-2)
    tp = ttopk.fused_score_topk_twophase(torch.from_numpy(q), te, 10, num_real, block_t=32)
    _assert_same(tp, ref, num_real, t, rtol=0 if dtype == "int8" else 2e-2)


def test_large_k_stream():
    """k=64: deep selections through the running top-k and the merge."""
    b, d, t = 8, 32, 512
    q, emb = _inputs(11, b, d, t)
    ref = jtopk.fused_score_topk(
        jnp.asarray(q), jnp.asarray(emb), 64, t, block_t=512, interpret=True
    )
    got = ttopk.fused_score_topk(torch.from_numpy(q), torch.from_numpy(emb), 64, t)
    _assert_same(got, ref, t, t)


def test_large_k_twophase():
    """k=96 through both two-phase implementations (k <= nblocks)."""
    b, d, t = 4, 32, 1024
    q, emb = _inputs(12, b, d, t)
    ref = _jax_tp(jnp.asarray(q), jnp.asarray(emb), 96, t - 9, 8)
    tq, te = torch.from_numpy(q), torch.from_numpy(emb)
    got = ttopk.fused_score_topk_twophase(tq, te, 96, t - 9, block_t=8)
    _assert_same(got, ref, t, t)
    _assert_same(ttopk.fused_score_topk(tq, te, 96, t - 9), ref, t, t)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_twophase_matches_pallas(dtype):
    """The two-phase port (plain phases + the shared mid-pass and merge)
    equals the JAX two-phase kernels and the port's streaming path."""
    b, d, t = 8, 32, 1024
    q, emb = _inputs(1, b, d, t)
    je, te = _index(dtype, emb)
    num_real = t - 37
    ref = _jax_tp(jnp.asarray(q), je, 10, num_real, 64)
    tq = torch.from_numpy(q)
    got = ttopk.fused_score_topk_twophase(tq, te, 10, num_real, block_t=64)
    rtol = 0 if dtype == "int8" else 2e-2
    _assert_same(got, ref, num_real, t, rtol=rtol)
    stream = ttopk.fused_score_topk(tq, te, 10, num_real)
    assert torch.equal(got[0], stream[0]) and torch.equal(got[1], stream[1])


def test_twophase_int8_near_ties_exact():
    """int8 selection is exact: ±1-unit near-ties agree with argsort over
    the exact int32 scores, values included."""
    d = 8
    rng = np.random.default_rng(9)
    emb = np.zeros((256, d), np.int32)
    emb[:, 0] = 127
    emb = np.clip(emb + rng.integers(-1, 2, size=(256, d)), -127, 127).astype(np.int8)
    q = np.zeros((4, d), np.float32)
    q[:, 0] = 1.0
    s = (np.round(q * 127).astype(np.int32) @ emb.astype(np.int32).T)
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    vals, idx = ttopk.fused_score_topk_twophase(
        torch.from_numpy(q), torch.from_numpy(emb), 10, 256, block_t=16
    )
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(
        vals.numpy(),
        (np.take_along_axis(s, order, axis=1).astype(np.float32) * np.float32(1 / 127**2)),
    )


def test_twophase_validation():
    q = torch.zeros((4, 32))
    emb = torch.zeros((512, 32))
    with pytest.raises(ValueError, match="k <= nblocks"):
        ttopk.fused_score_topk_twophase(q, emb, 9, 512, block_t=64)
    with pytest.raises(ValueError, match="not a multiple"):
        ttopk.fused_score_topk_twophase(q, emb, 4, 512, block_t=100)
    assert ttopk.twophase_block_t(4096 * 305, 10) == ttopk.TWOPHASE_BLOCK_T
    assert ttopk.twophase_block_t(1024, 10) is None


def test_key_helpers_match_jax():
    """Sortable keys, cleared keys, decoded values and int8 query
    quantization are bit-identical to the JAX helpers."""
    rng = np.random.default_rng(5)
    f = np.concatenate(
        [rng.normal(size=1000).astype(np.float32) * 10, np.float32([0.0, -0.0, 1e-30, -3e38])]
    )
    i = rng.integers(-(1 << 19), 1 << 19, size=1000).astype(np.int32)
    tf, ti = torch.from_numpy(f), torch.from_numpy(i)
    np.testing.assert_array_equal(
        ttopk.to_sortable(tf).numpy(), np.asarray(jtopk._to_sortable(jnp.asarray(f)))
    )
    for scores, ts, int_exact in ((f, tf, False), (i, ti, True)):
        key = ttopk.enc_key(ts, int_exact)
        np.testing.assert_array_equal(
            key.numpy(), np.asarray(jtopk._enc_key(jnp.asarray(scores), int_exact))
        )
        np.testing.assert_array_equal(
            ttopk.dec_val(key, int_exact).numpy(),
            np.asarray(jtopk._dec_val(jnp.asarray(key.numpy()), int_exact)),
        )
    assert ttopk._NEG_SINK == jtopk._NEG_SINK and ttopk._INT_SINK == jtopk._INT_SINK
    x = np.float32([[0.5 / 127, 1.5 / 127, -2.5 / 127, 1.0, -1.2, 0.3]])
    np.testing.assert_array_equal(
        ttopk.quantize_queries_int8(torch.from_numpy(x)).numpy(),
        np.asarray(jtopk.quantize_queries_int8(jnp.asarray(x))),
    )


def test_pair_schedule_groups_pairs_by_block():
    """Every valid (query, block) pair lands in exactly one tile slot of a
    tile of its block; empty pairs get position -1."""
    rng = np.random.default_rng(4)
    b, k, nblocks = 150, 4, 7
    blk = np.stack([rng.choice(nblocks, size=k, replace=False) for _ in range(b)])
    key = torch.from_numpy(rng.integers(-1000, 1000, size=(b, k)))
    comp = key * (1 << 32) + (0xFFFFFFFF - torch.from_numpy(blk))
    comp[3, 2] = ttopk._EMPTY
    tq, tb, pos = ttopk.pair_schedule(comp, nblocks)
    tq, tb, pos = tq.numpy(), tb.numpy(), pos.numpy()
    assert pos.reshape(b, k)[3, 2] == -1
    for p in range(b * k):
        qi, j = divmod(p, k)
        if (qi, j) == (3, 2):
            continue
        assert tq[pos[p]] == qi and tb[pos[p] // ttopk.PAIR_TILE] == blk[qi, j]
    used = pos[pos >= 0]
    assert len(set(used.tolist())) == len(used)
    assert (tq >= 0).sum() == len(used)


def _pair_schedule_by_bincount(bkeys, nblocks):
    """The mid-pass as it was first written (bincount for the per-block
    counts, repeat_interleave for the query of each pair): the reference
    for the rewritten counts."""
    b, k = bkeys.shape
    p = b * k
    flat = bkeys.reshape(p)
    blk = torch.where(flat != ttopk._EMPTY, ttopk._LOW32 - (flat & ttopk._LOW32), nblocks)
    order = torch.argsort(blk, stable=True)
    sblk, srow = blk[order], torch.arange(b).repeat_interleave(k)[order]
    counts = torch.bincount(sblk, minlength=nblocks + 1)[:nblocks]
    zero = torch.zeros(1, dtype=torch.int64)
    tile_base = torch.cat([zero, torch.cumsum((counts + ttopk.PAIR_TILE - 1) // ttopk.PAIR_TILE, 0)])
    start = torch.cat([zero, torch.cumsum(counts, 0)])
    in_range = sblk < nblocks
    sb = torch.clamp(sblk, max=nblocks - 1)
    rank = torch.arange(p) - start[sb]
    tile = tile_base[sb] + rank // ttopk.PAIR_TILE
    ntile = min(nblocks, p) + -(-p // ttopk.PAIR_TILE)
    spos = torch.where(in_range, tile * ttopk.PAIR_TILE + rank % ttopk.PAIR_TILE, -1)
    tile_query = torch.full((ntile * ttopk.PAIR_TILE,), -1, dtype=torch.int32)
    tile_query[spos[in_range]] = srow[in_range].to(torch.int32)
    tile_block = torch.full((ntile,), -1, dtype=torch.int32)
    tile_block[tile[in_range]] = sb[in_range].to(torch.int32)
    pos = torch.empty(p, dtype=torch.int64)
    pos[order] = spos
    return tile_query, tile_block, pos


@pytest.mark.parametrize("b,k,nblocks", [(1, 1, 1), (3, 2, 5), (150, 4, 7), (200, 10, 610),
                                         (1100, 10, 12), (70, 32, 40)])
def test_pair_schedule_counts_match_bincount(b, k, nblocks):
    """The mid-pass's searchsorted counts give the schedule the bincount
    gave: random block choices with a share of empty pairs (blocks past
    num_real), including all-empty queries."""
    rng = np.random.default_rng(b * 1000 + k)
    blk = np.stack([rng.choice(nblocks, size=k, replace=False) for _ in range(b)])
    key = torch.from_numpy(rng.integers(-1000, 1000, size=(b, k)))
    comp = key * (1 << 32) + (0xFFFFFFFF - torch.from_numpy(blk))
    comp[torch.from_numpy(rng.random((b, k)) < 0.2)] = ttopk._EMPTY
    comp[0] = ttopk._EMPTY
    got = ttopk.pair_schedule(comp, nblocks)
    want = _pair_schedule_by_bincount(comp, nblocks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_twophase_zero_and_negative_zero_query_rows():
    """A batch with an all-zero query row and a -0.0 query row: every
    score of both is zero, keyed as +0.0, so both give rows 0-4 with value
    0.0, as the JAX two-phase kernels (interpret mode) give them."""
    b, d, t = 6, 32, 1024
    q, emb = _inputs(13, b, d, t)
    q[1] = 0.0
    q[4] = -0.0
    for dtype in ("bf16", "int8"):
        je, te = _index(dtype, emb)
        ref = _jax_tp(jnp.asarray(q), je, 5, t - 7, 64)
        got = ttopk.fused_score_topk_twophase(torch.from_numpy(q), te, 5, t - 7, block_t=64)
        _assert_same(got, ref, t, t, rtol=0 if dtype == "int8" else 2e-2)
        for r in (1, 4):
            assert got[1][r].tolist() == [0, 1, 2, 3, 4]
            assert (got[0][r] == 0).all() and not torch.signbit(got[0][r]).any()


def test_int8_dec_val_sinks_match_jax():
    """The int8 decode with Python-scalar constants: values and the sink
    bit-identical to JAX's _dec_val."""
    rng = np.random.default_rng(6)
    s = rng.integers(-ttopk._INT_SCORE_CLIP, ttopk._INT_SCORE_CLIP + 1, size=500).astype(np.int32)
    keys = np.concatenate([s << 12, np.int32([ttopk._INT_SINK, 0, ttopk._INT_SINK])])
    got = ttopk.dec_val(torch.from_numpy(keys), True)
    want = np.asarray(jtopk._dec_val(jnp.asarray(keys), True))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert (got[-3::2] == np.float32(ttopk.NEG)).all()


def test_cpu_tensors_never_launch_kernels():
    before = dict(ttopk.launches)
    q, emb = _inputs(2, 4, 32, 512)
    tq, te = torch.from_numpy(q), torch.from_numpy(emb)
    ttopk.fused_score_topk(tq, te, 5, 500)
    ttopk.fused_score_topk_twophase(tq, te, 5, 500, block_t=64)
    assert ttopk.launches == before


# ------------------------------------------------------------- exact variant
# Held against JAX fused_score_topk(variant="exact") in interpret mode
# (_kernel + _topk_passes). On exact-dot inputs (multiples of 1/16 for the
# float indexes, whose float32 sums are exact in any order; int8 sums are
# exact integers) rows and values must be bit-identical. With fewer real
# rows than k the real slots must be equal, the sinks exactly
# float32(-3e38) and their rows in range.


def _exact_dot(seed, b, d, t):
    rng = np.random.default_rng(seed)
    grid = lambda n: (rng.integers(-16, 17, size=(n, d)) / 16.0).astype(np.float32)  # noqa: E731
    return grid(b), grid(t)


def _jax_exact(q, je, k, num_real, block_t=256):
    return jtopk.fused_score_topk(
        jnp.asarray(q), je, k, num_real, block_t=block_t, interpret=True, variant="exact"
    )


def _assert_exact(port, ref, num_real, t):
    pv, pi = (x.numpy() for x in port)
    rv, ri = (np.asarray(x) for x in ref)
    real = min(num_real, pi.shape[1])
    np.testing.assert_array_equal(pi[:, :real], ri[:, :real])
    np.testing.assert_array_equal(pv[:, :real].view(np.int32), rv[:, :real].view(np.int32))
    assert (pv[:, real:] == np.float32(ttopk.NEG)).all() and (rv[:, real:] == pv[:, real:]).all()
    assert ((pi >= 0) & (pi < t)).all()


@pytest.mark.parametrize("num_real_of", [lambda t: t, lambda t: t - 100, lambda t: 5, lambda t: 0],
                         ids=["T", "T-100", "5", "0"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_exact_matches_pallas(dtype, num_real_of):
    b, d, t = 8, 32, 1024
    num_real = num_real_of(t)
    if dtype == "int8":
        q, emb = _inputs(20, b, d, t)
    else:
        q, emb = _exact_dot(20, b, d, t)
    je, te = _index(dtype, emb)
    ref = _jax_exact(q, je, 10, num_real)
    got = ttopk.fused_score_topk(torch.from_numpy(q), te, 10, num_real, variant="exact")
    _assert_exact(got, ref, num_real, t)
    ref_port = ttopk.topk_reference(torch.from_numpy(q), te, 10, num_real, variant="exact")
    assert all(torch.equal(a, b) for a, b in zip(got, ref_port))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_exact_random_rows_within_1e6(dtype):
    """Random unit rows: float32 sums in another order. Values within
    1e-6; a differing row only where the two rows' scores lie within
    1e-6 of each other."""
    b, d, t = 8, 32, 1024
    q, emb = _inputs(21, b, d, t)
    je, te = _index(dtype, emb)
    rv, ri = (np.asarray(x) for x in _jax_exact(q, je, 10, t - 3))
    pv, pi = (x.numpy() for x in ttopk.topk_reference(torch.from_numpy(q), te, 10, t - 3,
                                                      variant="exact"))
    np.testing.assert_allclose(pv, rv, atol=1e-6, rtol=0)
    exact = q.astype(np.float64) @ emb.astype(np.float64).T
    for i, j in zip(*np.nonzero(pi != ri)):
        assert abs(exact[i, pi[i, j]] - exact[i, ri[i, j]]) <= 1e-6, (i, j)


def test_exact_massive_ties():
    """±1 rows (tests/test_ops.py:213): many exactly equal scores within
    and across blocks go to the lower row, as JAX's passes order them."""
    b, d, t = 8, 16, 768
    rng = np.random.default_rng(7)
    q = np.sign(rng.normal(size=(b, d))).astype(np.float32)
    emb = np.sign(rng.normal(size=(t, d))).astype(np.float32)
    ref = _jax_exact(q, jnp.asarray(emb), 10, t)
    got = ttopk.fused_score_topk(torch.from_numpy(q), torch.from_numpy(emb), 10, t,
                                 variant="exact")
    _assert_exact(got, ref, t, t)
    for r in got[1].numpy():
        assert len(set(r)) == 10


def test_exact_sparse_query_negative_zero(monkeypatch):
    """A sparse query whose every product with most rows is -0.0: those
    scores tie with +0.0 and go to the lower row, as JAX's ``scores ==
    max`` treats them; the plain key maps -0.0 to +0.0 (the kernel adds
    +0.0)."""
    d, t = 16, 256
    q = np.zeros((8, d), np.float32)
    q[:, 0] = -1.0
    emb = np.zeros((t, d), np.float32)
    emb[:, 1:] = -0.5  # q·e: -1·0 and 0·(-0.5), all -0.0 products
    emb[40, 0] = -0.25  # one positive score
    emb[9] = 0.0  # a zero row: +0.0 products
    ref = _jax_exact(q, jnp.asarray(emb), 10, t, block_t=64)
    got = ttopk.fused_score_topk(torch.from_numpy(q), torch.from_numpy(emb), 10, t,
                                 variant="exact")
    _assert_exact(got, ref, t, t)
    assert list(got[1][0].numpy()) == [40] + list(range(9))
    # no CPU matmul here makes a -0.0 sum; hand the plain version one
    monkeypatch.setattr(ttopk, "_scores", lambda q, e, i: torch.tensor([[-0.0, 0.0, -0.0, 1.0]]))
    s = ttopk._exact_scores(None, None, False)
    assert not torch.signbit(s).any() and ttopk.to_sortable(s)[0, :3].unique().numel() == 1


def test_exact_variant_validation():
    q, emb = torch.zeros((2, 8)), torch.zeros((16, 8))
    with pytest.raises(ValueError, match="variant"):
        ttopk.fused_score_topk(q, emb, 2, 16, variant="fast")
    before = dict(ttopk.launches)
    ttopk.fused_score_topk(q, emb, 2, 16, variant="exact")
    assert ttopk.launches == before


# ------------------------------------------------ the streaming kernel's host logic
# csrc/topk_stream.cu selects on a raw threshold (raw_thr: the accumulator
# value above which a score's key beats the row's threshold key t), keeps
# each query's candidates in a list of `cap` composites merged when it
# could overflow on the next 32 columns or first reaches k, and walks the
# tiles split, split + splits, ... . These tests pin that logic on the CPU:
# _raw_thr mirrors raw_thr, _emulate_stream the kernel's walk.

_INT_CLIP = (1 << 18) - 1
_F32_INV = np.float32(1.0 / (127 * 127))


def _sortable(x):
    b = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return (b ^ ((b >> 31) & 0x7FFFFFFF)).astype(np.int32)


def _unsortable(key):
    b = np.asarray(key, np.int64)
    return np.asarray((b ^ ((b >> 31) & 0x7FFFFFFF)).astype(np.int32)).view(np.float32)


def _key(s, int_exact, exact):
    """The kernel's selection key of raw accumulator values s (float32
    sums, or int32 sums for int8)."""
    if int_exact:
        if exact:
            return _sortable(np.asarray(s, np.int64).astype(np.float32) * _F32_INV)
        return (np.clip(np.asarray(s, np.int64), -_INT_CLIP, _INT_CLIP) << 12).astype(np.int32)
    s = np.asarray(s, np.float32) + np.float32(0.0)
    return _sortable(s) if exact else _sortable(s) & ~0xFFF


def _raw_thr(t, int_exact, exact):
    """Mirror of raw_thr in csrc/topk_stream.cu; t None: no threshold."""
    if t is None:
        return -(2**31) if int_exact else -np.inf
    if int_exact:
        if not exact:
            r = t >> 12
            return 2**31 - 1 if r >= _INT_CLIP else r
        r = int(np.floor(np.float64(_unsortable(t)) * 16129.0))
        while _key(r + 1, True, True) <= t:
            r += 1
        while _key(r, True, True) > t:
            r -= 1
        return r
    if exact:
        return _unsortable(t)
    u = t | 0xFFF
    return _unsortable(-2 if u == -1 else u)


def _float_edges(rng):
    tiny = np.array([1, 2, 0xFFF, 0x1000, 0x1001, 0x7FFFFF, 0x800000], np.int32).view(np.float32)
    big = np.array([np.finfo(np.float32).max, 1.0, 0.5, 1e-30, 3e38], np.float32)
    rnd = (rng.normal(size=400) * 10.0 ** rng.integers(-8, 8, size=400)).astype(np.float32)
    keys = _sortable(rnd) & ~0xFFF  # the floats at and around packed-key edges
    edge = np.concatenate([_unsortable(keys), _unsortable(keys - 1), _unsortable(keys | 0xFFF),
                           _unsortable((keys | 0xFFF) + 1)])
    s = np.concatenate([tiny, -tiny, big, -big, rnd, edge, [np.float32(0.0)]])
    return s[np.isfinite(s)].astype(np.float32)


@pytest.mark.parametrize("int_exact", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_raw_thresholds_split_scores_as_keys_do(int_exact, exact):
    """key(s) > t exactly when s > raw_thr(t), for every score s a tile can
    give (float32 sums are never -0.0; int8 sums reach ±256·127²) and every
    threshold key t of such a score, at the packed keys' bucket edges, the
    int8 clip and the tiny denormals whose packed key is -4096."""
    rng = np.random.default_rng(5)
    if int_exact:
        s = np.concatenate([rng.integers(-4_200_000, 4_200_000, size=600),
                            [0, 1, -1, _INT_CLIP, _INT_CLIP + 1, _INT_CLIP - 1, -_INT_CLIP,
                             -_INT_CLIP - 1, 4_129_024, -4_129_024, 16129, -16129]])
        s = s.astype(np.int64)
    else:
        s = _float_edges(rng)
    keys = _key(s, int_exact, exact).astype(np.int64)
    for t in [None, *np.unique(keys)]:
        r = _raw_thr(None if t is None else int(t), int_exact, exact)
        want = np.ones_like(keys, bool) if t is None else keys > t
        got = s > r
        assert (got == want).all(), (t, s[got != want][:5])


def _emulate_stream(q, emb, k, num_real, variant, splits, cap):
    """The kernel's selection, step by step, on the plain scores: each
    split walks its tiles in order; before each tile a query row holding k
    candidates whose list could not take the tile's scores above its raw
    threshold, or that has no threshold yet, is cut to its k best
    composites (threshold: the k-th key); then the tile's scores above the
    threshold are appended whole, or, where they still do not fit, in two
    halves of 64 columns, cutting the list before a half that would not
    fit (cap >= k + 64); the splits' lists then merge as sse_topk_select
    merges them."""
    exact = variant == "exact"
    qp, int_exact = ttopk._prep_queries(q, emb)
    acc = ttopk._scores(qp, emb, int_exact).numpy()
    t_rows, lim = emb.shape[0], max(0, min(num_real, emb.shape[0]))
    tiles = -(-lim // 128)
    out = []
    for row in acc:
        keys = _key(row, int_exact, exact).astype(np.int64)
        comp = (keys << 32) + (0xFFFFFFFF - np.arange(t_rows))
        found = []
        for split in range(splits):
            lst, t = np.zeros(0, np.int64), None
            def above(lo, hi):
                cols = np.arange(tile * 128 + lo, min(tile * 128 + hi, lim))
                return comp[cols[row[cols] > _raw_thr(t, int_exact, exact)]]

            for tile in range(split, tiles, splits):
                new = above(0, 128)
                if lst.size >= k and (lst.size + new.size > cap or t is None):
                    lst = np.sort(lst)[::-1][:k]
                    t = int(lst[-1] >> 32)
                    new = above(0, 128)
                if lst.size + new.size > cap:
                    for lo in (0, 64):
                        new = above(lo, lo + 64)
                        if lst.size + new.size > cap:
                            lst = np.sort(lst)[::-1][:k]
                            t = int(lst[-1] >> 32)
                            new = above(lo, lo + 64)
                        lst = np.concatenate([lst, new])
                else:
                    lst = np.concatenate([lst, new])
                assert lst.size <= cap
            found.append(np.sort(lst)[::-1][:k])
        best = np.sort(np.concatenate(found))[::-1][:k]
        out.append(np.concatenate([best, np.full(k - best.size, ttopk._EMPTY, np.int64)]))
    comp = torch.from_numpy(np.stack(out)) if out else torch.empty((0, k), dtype=torch.int64)
    return ttopk.decode(comp, int_exact, exact)


@pytest.mark.parametrize("variant", ["packed", "exact"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("k,splits,cap,num_real", [(10, 3, 96, 1600), (40, 2, 128, 1500),
                                                  (100, 1, 192, 1100)])
def test_stream_emulation_matches_reference_on_ties(dtype, variant, k, splits, cap, num_real):
    """The kernel's walk (interleaved splits, strict `key > t` against a
    threshold that only ever sees higher rows, merges before a tile that
    would not fit) gives topk_reference's rows and values on tie-heavy rows: a few
    distinct index rows repeated across tiles and splits, so equal keys
    must go to the lowest rows."""
    rng = np.random.default_rng(9)
    d, t = 16, 1664
    base = rng.integers(-2, 3, size=(6, d)).astype(np.float32)
    emb = base[rng.integers(0, 6, size=t)]
    q = rng.integers(-2, 3, size=(5, d)).astype(np.float32)
    q[0] = 0.0  # every score +0.0: rows 0..k-1
    if dtype == "int8":
        te = torch.from_numpy((emb * 40).astype(np.int8))
        tq = torch.from_numpy((q * 40).astype(np.int8))
    else:
        te, tq = torch.from_numpy(emb).bfloat16(), torch.from_numpy(q / 4).bfloat16()
    got = _emulate_stream(tq, te, k, num_real, variant, splits, cap)
    want = ttopk.topk_reference(tq, te, k, num_real, variant)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert got[1][0].tolist() == list(range(k))


@pytest.mark.parametrize("dtype,d", [("bf16", 32), ("bf16", 64), ("bf16", 128),
                                     ("int8", 64), ("int8", 128), ("int8", 256)])
def test_stream_plan_fits_and_walks_every_tile_once(dtype, d):
    """_stream_plan for every k in 1..128 (both variants keep 8-byte
    candidates, so one plan serves both), B in {1, 8, 64, 256, 4096} and
    T in {1, 127, 128, 4097, 1,249,280}: shared memory within 227 KB and
    equal to the kernel's layout, lists room for k plus half a tile,
    about one CTA an SM, and the splits' walks (tile split,
    split + splits, ...) cover every 128-row tile exactly once."""
    row_bytes = d * (2 if dtype == "bf16" else 1)
    sms = 132
    for k in range(1, 129):
        for b in (1, 8, 64, 256, 4096):
            for t in (1, 127, 128, 4097, 1_249_280):
                p = ttopk._stream_plan(row_bytes, k, b, t, sms)
                lists = min(64 * p["groups"], b)
                assert p["smem"] == ttopk._stream_smem(row_bytes, p["groups"], p["stages"],
                                                       p["cap"], lists)
                assert p["smem"] <= 232_448
                assert p["cap"] % 32 == 0 and k + 64 <= p["cap"] <= 256
                assert p["groups"] in (1, 2) and p["stages"] >= 2 and (b > 64 or p["groups"] == 1)
                tiles = -(-t // 128)
                nqg = -(-b // (64 * p["groups"]))
                assert 1 <= p["splits"] <= tiles and nqg * p["splits"] <= max(sms, nqg)
                walked = np.concatenate([np.arange(s, tiles, p["splits"])
                                         for s in range(p["splits"])])
                assert np.array_equal(np.sort(walked), np.arange(tiles))


def test_launch_counts_sum_the_per_batch_counter(monkeypatch):
    """The top-k wrappers count launches by (kernel, B) in one counter:
    ops.launch_counts() reports each kernel's sum over B beside the
    recurrent and the embedding kernels' counts, and reset_launch_counts
    empties it."""
    from collections import Counter

    from sse_tpu_torch import ops
    from sse_tpu_torch.ops import embed, rnn

    monkeypatch.setattr(rnn, "launches", dict.fromkeys(rnn.launches, 1))
    monkeypatch.setattr(ttopk, "launches", Counter(
        {("topk_stream", 8): 3, ("topk_stream", 256): 2, ("twophase_p1", 1024): 1}))
    counts = ops.launch_counts()
    assert counts.keys() == set(rnn.launches) | set(embed.launches) | set(ttopk.KERNELS)
    assert (counts["topk_stream"], counts["topk_exact"], counts["twophase_p1"]) == (5, 0, 1)
    assert ttopk.launch_total("twophase_p2") == 0 and counts["gru_fwd"] == 1
    ops.reset_launch_counts()
    assert not ttopk.launches and not any(ops.launch_counts().values())


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_rows_off_reference_tolerance(dtype):
    """rows_off_reference: the reference's own rows differ nowhere; two
    rows of equal score may trade places on a float index (a summation-
    order tie), but on an int8 index no position may differ; two rows of
    far-apart scores may not trade places on either."""
    rng = np.random.default_rng(0)
    emb = _unit(rng.standard_normal((64, 16)).astype(np.float32))
    emb[1] = emb[0]  # a tie: equal scores for every query
    q = torch.from_numpy(_unit(rng.standard_normal((4, 16)).astype(np.float32)))
    _, e = _index(dtype, emb)
    _, ref = ttopk.topk_reference(q, e, 64, 64)
    assert ttopk.rows_off_reference(q, e, ref, 64) == (0, [])

    tied = ref.clone()
    for i in range(4):
        j0, j1 = (ref[i] == 0).nonzero().item(), (ref[i] == 1).nonzero().item()
        tied[i, j0], tied[i, j1] = 1, 0
    n, bad = ttopk.rows_off_reference(q, e, tied, 64)
    assert n == 8 and len(bad) == (8 if dtype == "int8" else 0)

    far = ref.clone()
    far[:, 0], far[:, -1] = ref[:, -1], ref[:, 0]  # the best row and the worst
    n, bad = ttopk.rows_off_reference(q, e, far, 64)
    assert n == 8 and len(bad) == 8
