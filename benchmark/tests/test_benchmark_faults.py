"""Runs with the timed path broken underneath (``benchmark/faults.py``),
on the CPU at a small size (the look for a card skipped): each fault a
cell can have must turn ``correct`` false. Faults: an answer or a row
altered where it is produced, half of a batch left out (the mean taken
over the rest), a step that returns its state unchanged, a token
altered."""

import pytest

from benchmark import harness
from benchmark.faults import FAULTS
from benchmark.tests.small import OVERRIDES

SEED = 2**31 + 777

CASES = [(cell, fault) for cell in sorted(OVERRIDES)
         for fault in FAULTS[harness.resolve(cell).traffic["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_the_fault_is_caught(cell, fault):
    kind = harness.resolve(cell).traffic["driver"]
    with FAULTS[kind][fault]():
        out = harness.run_cell(cell, SEED, 0.2, False, "cpu", OVERRIDES[cell])
    assert not out["correct"], out["checks"]
