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


def test_cpu_tensors_never_launch_kernels():
    before = dict(ttopk.launches)
    q, emb = _inputs(2, 4, 32, 512)
    tq, te = torch.from_numpy(q), torch.from_numpy(emb)
    ttopk.fused_score_topk(tq, te, 5, 500)
    ttopk.fused_score_topk_twophase(tq, te, 5, 500, block_t=64)
    assert ttopk.launches == before
