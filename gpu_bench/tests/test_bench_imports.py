"""A cell's run loads no module whose top-level name, taken whole, is
``jax``, ``jaxlib``, ``flax`` or ``physically_based_renderer_tpu`` (the
port's name begins with the JAX package's, so names are compared whole)."""

from __future__ import annotations

import subprocess
import sys

from .conftest import ROOT

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from gpu_bench.tests.conftest import run_small
from gpu_bench.run import forbidden_modules
res = run_small("rustediron_ibl.fwd", traced=True)
assert res["correct"], res["checks"]
assert "physically_based_renderer_tpu_torch" in sys.modules
print("FORBIDDEN", forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole():
    from gpu_bench import run

    saved = dict(sys.modules)
    try:
        sys.modules["physically_based_renderer_tpu_torch"] = sys
        sys.modules["jaxtyping"] = sys
        for name in run.FORBIDDEN:
            sys.modules.pop(name, None)
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
