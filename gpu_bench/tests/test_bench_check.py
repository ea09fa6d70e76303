"""The training numbers of ``check.train_numbers`` on a synthetic bank: the
median leaf's gap reads 1 for a state left unchanged, is not moved by one
leaf's rounding-level jump, and reads a gradient scaled by 1%."""

from __future__ import annotations

import pytest
import torch

from gpu_bench import check

LR = 0.1


def bank_and_grads(n_leaves: int, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    p0 = {f"leaf{i}": torch.rand(16, generator=gen) for i in range(n_leaves)}
    g1 = {k: torch.randn(16, generator=gen) * 10.0 ** -(i % 3) for i, k in enumerate(p0)}
    return p0, g1


def numbers(p0, g1, prog_g1):
    """One SGD step on each side, the checked steps being that one step."""
    ref_p1 = {k: p0[k] - LR * g1[k] for k in p0}
    prog_p1 = {k: p0[k] - LR * prog_g1[k] for k in p0}
    prog = dict(losses=[1.0], p0=p0, p1=prog_p1, pn=prog_p1)
    ref = dict(losses=[1.0], p0=p0, p1=ref_p1, pn=ref_p1, g1=g1)
    return check.train_numbers(prog, ref, LR)


@pytest.mark.parametrize("n_leaves", [5, 6])
def test_unchanged_state_reads_one(n_leaves):
    p0, g1 = bank_and_grads(n_leaves)
    out = numbers(p0, g1, {k: torch.zeros_like(v) for k, v in g1.items()})
    assert out["grad_gap_median"] == 1.0 and out["change_gap_median"] == 1.0


def test_one_leaf_jump_leaves_the_median_leaf():
    p0, g1 = bank_and_grads(6)
    small = min(g1, key=lambda k: float(g1[k].norm()))
    prog = {k: v.clone() for k, v in g1.items()}
    prog[small][3] *= 1.15  # one element of a small leaf 15% off
    out = numbers(p0, g1, prog)
    assert out["grad_gap_median"] < 1e-6 and out["change_gap_median"] < 1e-6


def test_gradient_scaled_by_one_percent_fails():
    p0, g1 = bank_and_grads(6)
    prog = {k: v * 1.01 for k, v in g1.items()}
    out = numbers(p0, g1, prog)
    limits = check.load_limits(check.os.path.dirname(check.__file__), "pbr_scene.train")
    ok, _ = check.judge(out, limits)
    assert not ok and out["grad_gap_median"] > 5e-3
