"""The control on the card, at a size a test run holds: the reference put
in the program's place one precision down (each cell file's ``control``)
reads at least three times further from the float64 reference than the
program does in one of the cell's numbers, on each step cell's
configuration at 32^3 (64 x 64 x 16 for the 512 x 512 x 128 array), on
three seeds, where the control comes out not
correct by the cell's own limits and the program correct.  The cell-size readings come from
``python3 -m lesbench.control``; see PERF.md."""
from __future__ import annotations

import pytest
import torch

from lesbench import control
from lesbench.tests.lesbench_small import small_config, small_work


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("config,cell", [
    ("urban_cubes", "urban_128.step"),
    ("urban_cubes_driven", "driven_128.step"),
    ("urban_cubes_512", "urban_cubes_512.step")])
def test_control_reads_above_the_program(card, config, cell):
    work = small_work(cell)
    n = 64 if config == "urban_cubes_512" else 32
    rows = control.readings(work, small_config(config, n), [1, 2, 3], 0.5)
    for row in rows:
        ratios = [row["control"][n] / row["program"][n]
                  for n in work["limits"] if row["program"].get(n, 0) > 0]
        assert max(ratios) >= 3, row
        assert row["control_correct"] is False, row
