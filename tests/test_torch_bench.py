"""The port's benchmark (``sse_tpu_torch/bench.py``) on the CPU against
``sse_tpu/bench.py``: with both packages' timing and chip spec stubbed to
the same numbers, the three benches report the same work and roofline
fields at the same shapes (exact equality: both compute them from the
same integers in Python floats); the rotating-input protocol; the chip
table; the timed path's rows against ``topk_reference``; what raises.
``StepTimer`` as ``tests/test_utils.py`` checks the JAX one."""

import jax.numpy as jnp
import pytest
import torch

from sse_tpu import bench as jbench
from sse_tpu_torch import bench as tbench
from sse_tpu_torch.models import sse as tsse
from sse_tpu_torch.ops.topk import topk_reference
from sse_tpu_torch.utils import StepTimer

SPEC = (989.0, 3350.0)
TIMINGS = [(1e-3, 2e-3), (1e-6, 3e-6)]  # (best, mean) seconds a call
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages time every call at ``timing`` and see a card of SPEC."""

    def stub(timing):
        for mod in (jbench, tbench):
            monkeypatch.setattr(mod, "_throughput_time", lambda *a, **k: timing)
            monkeypatch.setattr(mod, "_chip_spec", lambda *a, **k: SPEC)

    return stub


def _same(jax_out, port_out, keys):
    for key in keys:
        assert port_out[key] == jax_out[key], (key, port_out[key], jax_out[key])


@pytest.mark.parametrize("timing", TIMINGS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_query_bench_work_model_matches_jax(stubbed, timing, dtype):
    stubbed(timing)
    jdt, tdt = DTYPES[dtype]
    shape = dict(num_targets=4096, encoding_dim=16, batch=8, k=10, max_seq_length=12)
    j = jbench.run_query_bench(index_dtype=jdt, **shape)
    t = tbench.run_query_bench(index_dtype=tdt, device="cpu", **shape)
    _same(j, t, ("metric", "unit", "value", "num_targets", "batch", "k", "ms_per_batch",
                 "qps_stream_mean", "ms_per_batch_stream_mean", "achieved_gflops",
                 "achieved_hbm_gbps", "mfu_pct", "hbm_pct_of_spec"))
    assert t["device"] == "cpu"
    if timing[0] < 1e-3:  # fields that round to 0.0 at 1 ms
        assert t["mfu_pct"] > 0 and t["hbm_pct_of_spec"] > 0 and t["achieved_hbm_gbps"] > 0


@pytest.mark.parametrize("timing", TIMINGS)
def test_train_bench_work_model_matches_jax(stubbed, timing):
    stubbed(timing)
    shape = dict(batch=8, num_targets=64, max_seq_length=12, num_negatives=16, encoding_dim=16)
    j = jbench.run_train_bench(chain=1, **shape)
    t = tbench.run_train_bench(chain=1, device="cpu", **shape)
    _same(j, t, ("metric", "value", "examples_per_sec", "ms_per_step",
                 "steps_per_sec_single_dispatch", "achieved_gflops", "mfu_pct"))
    assert "hbm_pct_of_spec" not in t and "achieved_hbm_gbps" not in t
    # the whole-stream mean: the port reports the stream's own; the JAX
    # bench's chain=1 branch reports its best window under that key
    assert t["steps_per_sec_stream_mean"] == round(1.0 / timing[1], 2)
    assert j["steps_per_sec_stream_mean"] == round(1.0 / timing[0], 2)
    assert "1-step dispatch" in t["unit"]


TRAIN_KEYS = ("metric", "value", "examples_per_sec", "ms_per_step", "steps_per_sec_stream_mean",
              "steps_per_sec_single_dispatch", "achieved_gflops", "mfu_pct")


@pytest.mark.parametrize("timing", TIMINGS)
def test_train_bench_chain_work_model_matches_jax(stubbed, timing):
    """The default chain of 8: the same keys and numbers as the JAX
    bench's chain=8 (its chained rate the headline, the one-step rate
    beside it), and the same unit but for the JAX bench's "fused Pallas
    recurrence"."""
    stubbed(timing)
    shape = dict(batch=8, num_targets=64, max_seq_length=12, num_negatives=16, encoding_dim=16)
    j = jbench.run_train_bench(**shape)
    t = tbench.run_train_bench(device="cpu", **shape)
    _same(j, t, TRAIN_KEYS)
    assert set(j) <= set(t) and set(t) - set(j) == {"device"}
    assert t["unit"] == j["unit"].replace("fused Pallas recurrence, ", "")
    assert "8-step dispatch chain" in t["unit"]
    assert t["value"] == round(8 / timing[0], 2)  # per step: a chain's time over 8


def test_train_bench_chained_value_is_per_step(monkeypatch):
    """A chain's time divided by its steps is the headline; the one-step
    dispatch's own time is reported beside it, and the packed chunks are
    the JAX bench's: batch j of chunk i is variant (i·chain + j) mod 16."""
    timed = {}

    def fake(call, variants, seconds=8.0):
        chained = variants[0].ndim == 3 if isinstance(variants[0], torch.Tensor) else False
        timed["chain" if chained else "single"] = (call, variants)
        return (24e-3, 30e-3) if chained else (5e-3, 6e-3)

    monkeypatch.setattr(tbench, "_throughput_time", fake)
    s = tbench.train_setup(batch=4, num_targets=32, max_seq_length=6, num_negatives=4,
                           encoding_dim=16, device="cpu", chain=3)
    out = tbench.time_train(s, seconds=0.0)
    assert out["value"] == round(3 / 24e-3, 2) == 125.0
    assert out["ms_per_step"] == 8.0 and out["examples_per_sec"] == round(4 * 3 / 24e-3, 1)
    assert out["steps_per_sec_stream_mean"] == round(3 / 30e-3, 2)
    assert out["steps_per_sec_single_dispatch"] == 200.0
    assert "3-step dispatch chain" in out["unit"]
    assert timed["chain"][1] is s.packed_variants and timed["single"][1] is s.variants
    assert len(s.packed_variants) == 4
    for i, pk in enumerate(s.packed_variants):
        assert pk.shape == (3, 4, 6 + 3) and pk.dtype == torch.int32
        for j in range(3):
            src, labels = s.variants[(i * 3 + j) % tbench.NUM_VARIANTS]
            assert torch.equal(pk[j, :, :6], src) and torch.equal(pk[j, :, 7], labels)
            assert (pk[j, :, 6] == 6).all()
            assert (pk[j, :, 8].view(torch.float32) == 1.0).all()
    losses = s.call_chain(s.packed_variants[0])
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())


def test_train_bench_runs_chained_on_the_cpu():
    """Unstubbed at a tiny shape: both dispatches timed, every key there."""
    out = tbench.run_train_bench(batch=4, num_targets=32, max_seq_length=6, num_negatives=4,
                                 encoding_dim=16, chain=2, seconds=0.0, device="cpu")
    assert out["value"] > 0 and out["steps_per_sec_single_dispatch"] > 0
    assert set(TRAIN_KEYS) - {"mfu_pct"} <= set(out) and out["device"] == "cpu"


@pytest.mark.parametrize("timing", TIMINGS)
def test_index_bench_work_model_matches_jax(stubbed, timing):
    stubbed(timing)
    shape = dict(num_targets=256, encoding_dim=16, batch_size=32, max_seq_length=12)
    j = jbench.run_index_bench(**shape)
    t = tbench.run_index_bench(device="cpu", **shape)
    _same(j, t, ("metric", "unit", "value", "ms_per_batch", "docs_per_sec_stream_mean"))


@pytest.mark.parametrize("n_variants", [tbench.NUM_VARIANTS, 3])
def test_throughput_time_rotates_every_variant(n_variants):
    seen = []

    def call(v):
        seen.append(v)
        return torch.zeros(1)

    variants = list(range(n_variants))
    best, mean = tbench._throughput_time(call, variants, seconds=0.0)
    assert seen[0] == variants[0]  # the untimed first call
    assert len(seen) == 1 + tbench.WINDOW == 33  # seconds=0: exactly one timed window
    assert all(a != b for a, b in zip(seen, seen[1:]))
    assert seen == [variants[i % n_variants] for i in range(len(seen))]
    assert set(seen) == set(variants)
    assert 0.0 < best <= mean


def test_chip_table_longest_prefix_wins(monkeypatch):
    for name, spec in tbench._CHIP_SPECS:
        assert tbench._chip_spec(name) == spec
    assert tbench._chip_spec("NVIDIA H100 80GB HBM3") == (989.0, 3350.0)
    assert tbench._chip_spec("NVIDIA H100 PCIe") == (756.0, 2000.0)
    assert tbench._chip_spec("NVIDIA H100 NVL") == (835.0, 3900.0)
    for unknown in ("NVIDIA A100-SXM4-80GB", "cpu", None):
        assert tbench._chip_spec(unknown) is None
        out = tbench._roofline_fields(1e-3, 1e9, 1e6, unknown)
        assert "mfu_pct" not in out and "hbm_pct_of_spec" not in out
        assert out["achieved_gflops"] == 1000.0 and out["achieved_hbm_gbps"] == 1.0
    out = tbench._roofline_fields(1e-3, 1e12, 1e9, "NVIDIA H100 PCIe")
    assert out["mfu_pct"] == round(100.0 * 1e15 / 756e12, 2)
    assert out["hbm_pct_of_spec"] == round(100.0 * 1e12 / 2000e9, 1)
    # a shorter prefix listed first does not shadow a longer one
    monkeypatch.setattr(tbench, "_CHIP_SPECS", (("NVIDIA H100", (1.0, 2.0)), *tbench._CHIP_SPECS))
    assert tbench._chip_spec("NVIDIA H100 PCIe") == (756.0, 2000.0)
    assert tbench._chip_spec("NVIDIA H100 NVL") == (835.0, 3900.0)
    assert tbench._chip_spec("NVIDIA H100 SXM5 94GB") == (1.0, 2.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batch", [4, 1024])  # the streaming and the two-phase route
def test_query_bench_rows_equal_topk_reference(dtype, batch, monkeypatch):
    """The first batch the bench dispatches, through the fused query path,
    against topk_reference on the same encodings and the bench's own index
    (20480 rows, room for k blocks of 2048: at B=1024 the engine takes
    the two-phase route)."""
    from sse_tpu_torch.serve import engine

    routes = []
    for name in ("fused_score_topk", "fused_score_topk_twophase"):
        fn = getattr(engine, name)
        monkeypatch.setattr(engine, name,
                            lambda *a, _fn=fn, _n=name, **k: routes.append(_n) or _fn(*a, **k))
    tdt = DTYPES[dtype][1]
    s = tbench.query_setup(num_targets=20474, encoding_dim=16, batch=batch, k=10,
                           max_seq_length=6, index_dtype=tdt, device="cpu")
    assert s.emb.dtype == tdt and s.emb.shape == (20480, 16)  # the index's padding
    assert s.num_real == 20474 and not s.emb[20474:].float().any()
    norms = torch.linalg.norm(s.emb[:20474].float(), dim=1)
    scale = 127.0 if tdt == torch.int8 else 1.0
    torch.testing.assert_close(norms / scale, torch.ones(20474), atol=0.02, rtol=0)
    vals, rows = s.call(s.variants[0])
    assert routes == ["fused_score_topk_twophase" if batch >= 1024 else "fused_score_topk"]
    with torch.no_grad():
        q = tsse.encode_source(s.params, s.model_cfg, s.variants[0], s.lengths)
    ref_vals, ref_rows = topk_reference(q, s.emb, s.k, s.num_real)
    assert torch.equal(rows, ref_rows)
    torch.testing.assert_close(vals, ref_vals, atol=0, rtol=0)
    assert int(rows.max()) < s.num_real
    assert tbench.first_batch(s)[2:] == (0, [])
    if batch == 4:
        out = tbench.time_query(s, seconds=0.0)  # the same setup, timed
        assert out["value"] > 0 and out["num_targets"] == 20474 and out["k"] == 10
        assert out["batch"] == batch and "mfu_pct" not in out  # no chip spec for the CPU
        _, timed_rows, n_diff, bad = tbench.first_batch(s)
        assert torch.equal(timed_rows, rows) and (n_diff, bad) == (0, [])


def test_query_bench_variants_are_distinct_and_in_vocab():
    s = tbench.query_setup(num_targets=64, encoding_dim=16, batch=8, max_seq_length=10,
                           device="cpu")
    assert len(s.variants) == tbench.NUM_VARIANTS
    flat = torch.stack(s.variants)
    assert flat.shape == (16, 8, 10) and flat.dtype == torch.int32
    assert int(flat.min()) >= 2 and int(flat.max()) < 8000
    assert len({tuple(v.flatten().tolist()) for v in s.variants}) == 16


def test_bench_without_a_card_raises(monkeypatch):
    """Leaving device out means the card: with none, every bench and the
    headline entry raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    calls = [
        lambda: tbench.run_query_bench(num_targets=64, encoding_dim=16, batch=2, seconds=0.0),
        lambda: tbench.run_train_bench(batch=2, num_targets=16, num_negatives=2, seconds=0.0),
        lambda: tbench.run_index_bench(batch_size=2, seconds=0.0),
        lambda: tbench.query_setup(num_targets=64, batch=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.delenv("SSE_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main()


def test_step_timer_rate_and_reset():
    t = StepTimer()
    for _ in range(3):
        t.step(torch.ones((4,)) * 2)
    t.step()
    assert t.rate() > 0
    t.reset()
    assert t.rate() == 0.0
    t.step({"loss": torch.zeros(()), "rows": [torch.ones(2)]})
    assert t.rate() > 0
