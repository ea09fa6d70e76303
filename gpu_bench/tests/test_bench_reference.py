"""The reference against the port at 128×64 on the CPU, through the whole
harness (a test may import both; the reference imports nothing of the
program)."""

from __future__ import annotations

import ast
import os

import pytest

from .conftest import ROOT, run_small

CELLS = ["pbr_scene.fwd", "pbr_scene.train", "rustediron_ibl.fwd"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    checks = {k: c["value"] for k, c in res["checks"].items()}
    if cell.endswith(".fwd"):
        assert checks["off_px_share"] == 0.0 and checks["mean_abs_err"] < 1e-6
    else:
        assert checks["loss_gap"] < 1e-5 and checks["grad_gap_median"] < 1e-4 and checks["change_gap_median"] < 1e-4


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "gpu_bench", "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("__future__", "dataclasses", "math", "numpy", "torch"), (name, mod)
