"""The control: the reference one precision step lower (TF32 operands) in
the program's place fails the cell's limits, at the test size. The readings
at the cell's own size are the chip's (``python3 gpu_bench/control.py``)."""

from __future__ import annotations

import pytest

from gpu_bench import check
from gpu_bench.control import control_numbers

from .conftest import ROOT, SEED, small

CELLS = ["pbr_scene.fwd", "pbr_scene.train", "rustediron_ibl.fwd"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    numbers = control_numbers(ROOT, cell, SEED, "cpu", small(cell))
    ok, checks = check.judge(numbers, check.load_limits(f"{ROOT}/gpu_bench", cell))
    assert not ok, checks
