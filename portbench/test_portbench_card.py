"""On the card: the control, at each cell's own size on three seeds, comes
out not correct (``python -m pytest portbench -m requires_cuda`` on a
machine with an H100; skips without a card)."""

import math

import pytest

import control
import harness
from smallcells import ROOT

CELLS = ("bath-n12.ext",)
SEEDS = (11, 2**31 + 7, 2**33 + 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(cuda_card, workload):
    cell = harness.load_cell(ROOT, workload)
    limit = float(cell.limits["trace_gap"])
    for seed in SEEDS:
        for gap in control.control_gaps(cell, seed, 1, "cuda"):
            assert math.isfinite(gap) and gap > limit, (seed, gap, limit)
