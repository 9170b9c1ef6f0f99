"""The controls at a small size on the CPU: the plain reference in the
program's place, its products' operands rounded to the precision below
the cell's (TF32 for float32), and for training the reference that leaves
out half of each batch, read against the float32 reference, must fail the
cell's limits (``workloads/<cell>.json``), which
the program's own runs pass (``test_bench_harness.py``)."""
import pytest

import tiny
from harness import core

SEED = 2 ** 31 + 977


@pytest.mark.parametrize("name", list(tiny.CELLS))
def test_control_fails_the_limits(bench, name):
    cell = core.Cell(name, bench_dir=bench)
    readings = cell.runner().control(core.Run(cell, SEED, 0.0, False,
                                              "cpu"))
    limits = cell.settings["limits"]
    for control, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (
            control, numbers, limits)
