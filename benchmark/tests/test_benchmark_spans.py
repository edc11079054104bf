"""The span metrics (``benchmark/spans.py``) read from a traced CPU run:
the build cell's four ``index.*`` readings positive, and the interactive
cell's four ``engine.*`` readers None where no graph was replayed (CPU
tensors run the query eagerly)."""

import pytest

from benchmark import harness
from benchmark.tests.small import OVERRIDES

SEED = 2**31 + 4242
INDEX = ("index.stage_ms.build", "index.encode_ms.build", "index.publish_ms.build",
         "index.self_ms.build")
ENGINE = ("engine.key_us.interactive", "engine.load_us.interactive",
          "engine.replay_us.interactive", "engine.out_us.interactive")


@pytest.fixture(autouse=True)
def fresh_totals():
    from sse_tpu_torch.utils.profiling import reset_spans

    reset_spans()
    yield
    reset_spans()


def test_a_traced_build_reads_its_index_spans():
    out = harness.run_cell("qna-index-build", SEED, 0.3, True, "cpu", OVERRIDES["qna-index-build"])
    assert out["correct"], out["checks"]
    for name in INDEX:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    assert not any(op.startswith("sse.") for op, _ in out["breakdown"]["device_ops"])


def test_engine_readers_give_none_where_no_graph_replayed():
    cell = "gru-query-interactive"
    out = harness.run_cell(cell, SEED, 0.3, True, "cpu", OVERRIDES[cell])
    assert out["correct"], out["checks"]
    assert not set(ENGINE) & set(out["metrics"])
    for name in ENGINE:
        assert harness.metric_reader(name)(harness.Run(harness.resolve(cell), None, None,
                                                       "cpu")) is None


def test_readers_give_none_on_a_program_without_spans(monkeypatch):
    """A program before the spans (the parent of this reader) has no
    ``span_totals``: each reader returns None and does not raise."""
    from sse_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_totals")
    run = harness.Run(harness.resolve("qna-index-build"), None, object(), "cpu")
    for name in INDEX + ENGINE:
        assert harness.metric_reader(name)(run) is None
