"""Shared fixtures of the benchmark's own tests (run with ``pytest gpu_bench/tests``).

The CPU runs drive the whole harness at 128×64 with 32² pages: the port's
kernels run their plain versions there, the reference is the same code as
on the card."""

from __future__ import annotations

import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {"width": 128, "height": 64, "texture_size": 32}
SEED = 2**31 + 12345  # seeds beyond 32 signed bits, as the driver draws them


def small(cell: str) -> dict:
    """The test size of a cell's configuration (9 pages of 32² fall under the
    port's 2²⁰-texel mip rule, so pbr_scene samples with mip_lod there)."""
    return dict(SMALL, **({"mip_lod": True} if cell.startswith("pbr_scene") else {}))


def run_small(cell: str, seed: int = SEED, traced: bool = False, seconds: float = 0.5) -> dict:
    from gpu_bench import harness

    bench = harness.load_benchmark(ROOT)
    return harness.run_cell(ROOT, bench, harness.find_cell(bench, cell), seed=seed, seconds=seconds, traced=traced,
                            device="cpu", t_start=time.perf_counter(), cfg_overrides=small(cell))


@pytest.fixture
def cuda_device():
    """Skips where there is no CUDA card (decided inside the test run)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
