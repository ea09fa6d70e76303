"""The reference's sky mapping: the same uv as the plain formula at every
input, autograd's gradient wherever that is finite, and 0 where it is not
(the poles, the y axis), so an SGD step whose reflect direction meets a pole
stays finite."""

from __future__ import annotations

import math

import pytest
import torch

from gpu_bench import harness, loops, seeded
from gpu_bench.reference import render as ref
from gpu_bench.reference import train as ref_train
from gpu_bench.scene import make_inputs, reference_scene

from .conftest import ROOT, SEED, small


def plain_world_to_sky_uv(d: torch.Tensor) -> torch.Tensor:
    """The mapping as plain autograd sees it, with no guard at the poles."""
    u = torch.atan2(d[..., 2], d[..., 0]) * ref.INV_2PI + 0.5
    v = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * ref.INV_PI + 0.5
    return torch.stack([1.0 - u + 0.25, 1.0 - v], dim=-1)


def unit_grid() -> torch.Tensor:
    """Unit directions on a 181 × 361 latitude-longitude grid (the poles and
    the seam included), normalised in float32."""
    lat = torch.linspace(-math.pi / 2, math.pi / 2, 181, dtype=torch.float64)
    lon = torch.linspace(-math.pi, math.pi, 361, dtype=torch.float64)
    la, lo = torch.meshgrid(lat, lon, indexing="ij")
    d = torch.stack([la.cos() * lo.cos(), la.sin(), la.cos() * lo.sin()], dim=-1).reshape(-1, 3).float()
    return d * torch.rsqrt((d * d).sum(-1, keepdim=True))


# The poles: |y| = 1 exactly, with or without an x or z too small to move y
# off it. Plain autograd's derivative of asin is inf there.
POLES = [
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0), (-0.0, 1.0, -0.0), (0.0, -1.0, -0.0),
    (4e-4, 1.0, 1e-4), (-3e-4, -1.0, 2e-4), (1e-5, 1.0, 0.0),
]
# The y axis off the poles, |y| just above 1 on it, signed zeros, and x and z
# whose squares underflow: atan2's derivative is 0 / 0 or 1 / 0 (PyTorch 2.13
# gives 0 where x^2 + z^2 is 0, and inf or NaN where it is subnormal).
AXIS = [
    (0.0, 1.0000001, 0.0), (0.0, -1.0000001, 0.0),
    (0.0, 0.5, 0.0), (-0.0, -0.25, 0.0), (0.0, 0.0, 0.0),
    (1e-30, 0.6, 0.0), (0.0, -0.6, -1e-25), (1e-40, 0.8, 1e-40), (5e-20, 0.6, 0.0),
]
SINGULAR = POLES + AXIS
# Regular points beside them: |y| just above 1 off the axis (the clamp's zero),
# and directions a hair off the poles and the axis.
NEAR = [
    (1e-3, 1.0000001, 2e-3), (-1e-3, -1.0000001, 1e-3),
    (1e-3, 0.9999995, 0.0), (0.0, -0.9999995, 1e-3), (1e-15, 0.5, 0.0), (0.0, 0.5, -1e-18),
]


def points() -> torch.Tensor:
    return torch.cat([unit_grid(), torch.tensor(SINGULAR + NEAR, dtype=torch.float32)])


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def grad_of(fn, d: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    leaf = d.clone().requires_grad_()
    (g,) = torch.autograd.grad((fn(leaf) * weights).sum(), leaf)
    return g


def test_forward_is_the_plain_formula_bit_for_bit():
    d = points()
    assert torch.equal(bits(ref.world_to_sky_uv(d)), bits(plain_world_to_sky_uv(d)))


def test_gradient_is_finite_and_plain_wherever_plain_is_finite():
    d = points()
    w = torch.empty(d.shape[0], 2).uniform_(-2.0, 2.0, generator=torch.Generator().manual_seed(7))
    new, old = grad_of(ref.world_to_sky_uv, d, w), grad_of(plain_world_to_sky_uv, d, w)
    regular = torch.isfinite(old).all(-1)
    assert torch.isfinite(new).all()
    assert torch.equal(bits(new[regular]), bits(old[regular]))
    # plain autograd fails at every pole (the grid's two rows of 361 among them), and not off the axis
    n_grid = unit_grid().shape[0]
    assert not regular[n_grid:n_grid + len(POLES)].any()
    assert not regular[n_grid + len(SINGULAR) - 1]
    assert regular[n_grid + len(SINGULAR):].all()
    assert int((~regular[:n_grid]).sum()) == 2 * 361


@pytest.mark.parametrize("d, u_plain, v_plain", [
    ((0.0, 1.0, 0.0), False, False),  # the pole: neither has a derivative
    ((4e-4, 1.0, 1e-4), True, False),  # y = 1 in float32: v's is 0, u's is autograd's
    ((0.0, 0.5, 0.0), False, True),  # on the axis off the pole: u's is 0, v's is autograd's
])
def test_subgradients_at_the_singular_points(d, u_plain, v_plain):
    d = torch.tensor([d], dtype=torch.float32)
    for k, plain_there, reads in ((0, u_plain, [0, 2]), (1, v_plain, [1])):
        w = torch.zeros(1, 2)
        w[0, k] = 1.0
        got = grad_of(ref.world_to_sky_uv, d, w)
        want = grad_of(plain_world_to_sky_uv, d, w)[:, reads] if plain_there else torch.zeros(1, len(reads))
        assert torch.equal(got[:, reads], want)
        assert torch.equal(got[:, [c for c in range(3) if c not in reads]], torch.zeros(1, 3 - len(reads)))


def _step_grads(mapping, at_pole: bool) -> dict:
    """The first gradients of one reference SGD step on the rusted-iron IBL
    sphere at the test size, under ``mapping``; with ``at_pole`` the reflect
    direction of the hit pixel that looks highest is posed on the north pole
    (its value set to (0, 1, 0) exactly, its gradient passed through)."""
    cell = "rustediron_ibl.fwd"
    bench = harness.load_benchmark(ROOT)
    cfg = harness.load_config(ROOT, bench, harness.find_cell(bench, cell)["config"])
    cfg.update(small(cell))
    mix = harness.load_traffic("train")
    rs = reference_scene(cfg, make_inputs(cfg, SEED, "cpu"), "cpu")
    pose = loops.train_views(SEED, cfg["camera"], int(mix["views"]), "cpu")[0]
    target = seeded.targets(SEED, 1, cfg["height"], cfg["width"], "cpu")[0]
    real_shade = ref.shade
    posed = []

    def shade(gbuf, *args, **kwargs):
        lit, opacity, spec_f, rdir, rough = real_shade(gbuf, *args, **kwargs)
        if at_pole:
            hit = (gbuf[..., 3:6] != 0).any(-1)
            y = torch.where(hit, rdir[..., 1].detach(), torch.full_like(rdir[..., 1], -2.0))
            pixel = divmod(int(torch.argmax(y)), y.shape[1])
            pole = rdir.new_tensor([0.0, 1.0, 0.0])
            assert 0.5 <= float(rdir[pixel][1].detach()) <= 2.0  # so that y + (1 - y) is 1 exactly
            rdir = rdir.clone()
            rdir[pixel] = rdir[pixel] + (pole - rdir[pixel]).detach()
            posed.append(rdir[pixel].detach())
        return lit, opacity, spec_f, rdir, rough

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "shade", shade)
        mp.setattr(ref, "world_to_sky_uv", mapping)
        _, g1, _ = ref_train.sgd_steps(rs, [pose], [target], cfg["width"], cfg["height"],
                                       float(mix["learning_rate"]))
    if at_pole:
        assert len(posed) == 1 and torch.equal(posed[0], torch.tensor([0.0, 1.0, 0.0]))
    return g1


@pytest.fixture
def one_thread():
    """One CPU thread, so that the texel scatters of the backward add in one
    order and two steps can be compared bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sgd_step_with_a_reflect_direction_on_the_pole(one_thread):
    guarded = ref.world_to_sky_uv
    plain = _step_grads(plain_world_to_sky_uv, at_pole=True)
    assert not all(bool(torch.isfinite(g).all()) for g in plain.values())
    new = _step_grads(guarded, at_pole=True)
    assert all(bool(torch.isfinite(g).all()) for g in new.values())
    # away from the pole the guarded step is the plain one, bit for bit
    off_plain = _step_grads(plain_world_to_sky_uv, at_pole=False)
    off_new = _step_grads(guarded, at_pole=False)
    assert all(torch.equal(bits(off_new[k]), bits(off_plain[k])) for k in off_plain)
    assert sum(float(g.abs().sum()) for g in off_new.values()) > 0.0
