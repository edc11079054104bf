"""Each cell driven end to end on the CPU at a small size (the program's
plain paths): traced and untraced, the program judged correct and the
control (the reference at float8 in the program's place) not."""

import math

import pytest

from benchmark import harness
from benchmark.tests.small import OVERRIDES

SEED = 2**31 + 12345


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cell, trace):
    out = harness.run_cell(cell, SEED, 0.3, trace, "cpu", OVERRIDES[cell])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    c = harness.resolve(cell)
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in c.per_layer}
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    else:
        assert set(out["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_the_control_is_not_correct(cell):
    out = harness.run_cell(cell, SEED + 1, 0.2, False, "cpu", OVERRIDES[cell], mode="control")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [c for c in sorted(OVERRIDES)
                                  if harness.resolve(c).traffic.get("untraced_seconds")])
def test_a_traced_run_reads_host_times_from_its_untraced_window(cell, monkeypatch):
    seen = []
    real = harness.Run.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        seen.append(self)

    monkeypatch.setattr(harness.Run, "__init__", spy)
    out = harness.run_cell(cell, SEED + 2, 0.3, True, "cpu", OVERRIDES[cell])
    run = seen[-1]
    assert run.untraced and run.untraced is not run.record
    assert out["attempted"] > run.record.get("dispatches", run.record.get("builds", 0))
    for m in harness.resolve(cell).per_layer:
        if m["source"] == "host_clock":
            assert m["name"] in out["metrics"]
