"""The control: the reference in the next precision down (bfloat16) put in
the program's place fails the cell's limits, where the program passes.
At a size a test run holds; on the card ``calibrate.py`` reads the same at
the cells' own size."""

import pytest

from conftest import SEED
from harness import bench


@pytest.mark.parametrize("name", ["trained_1m.serve", "trained_1m.train"])
def test_lower_precision_fails_the_limits(tiny_cell, name):
    cell = tiny_cell(name)
    run, res = bench.execute(cell, SEED, 0.2, False, "cpu")
    program = {k: c["value"] for k, c in res["checks"].items()}
    control = run.control()
    assert res["correct"] and all(v <= cell.limits[k] for k, v in program.items()), program
    assert any(v > cell.limits[k] for k, v in control.items()), control
