"""On the card: one short run of a cell through ``run.py`` comes out correct
with the contract's line (``pytest gpu_bench/tests -m cuda`` on a machine
with the card)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(cuda_device, traced):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "gpu_bench", "run.py"), "--workload",
                          "rustediron_ibl.fwd", "--seed", str(2**31 + 99), "--seconds", "2", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
