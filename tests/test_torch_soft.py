"""PyTorch port vs the JAX package: the soft rasterizer's frames and
gradients — ``soft_composite`` and ``render_soft`` — and three behaviours of
``tests/test_soft.py`` on the port. Kernel 5b, the dilated binning,
``interpolate_corners(clamp=True)`` and ``peel_layers`` are held in
``tests/test_torch_soft_raster.py``, whose scene and helpers this file uses.

The port always peels with the kernel, as the JAX package does on an
accelerator; its own CPU branch peels with its jnp rasterizer, which clips a
dilated triangle to its bbox + margin, so the two JAX paths disagree on most
dilated pixels. Every parity test here therefore holds the port against
JAX's kernel 5 in interpret mode (``render_soft`` through
``render_soft.__wrapped__`` with ``raster_soft.peel_layers`` patched to
``backend="pallas_interpret"``).

Tolerances:
  * ``soft_composite``: values atol 2e-6, gradients
    ``torch_parity.grad_tolerance`` (rtol 2e-3 + 5e-5·max);
  * ``render_soft``: the image within IMAGE_ATOL where every layer's id
    agrees; with JAX replaying the port's peels, the image within IMAGE_ATOL
    everywhere and the geometry gradient within GEOM_RTOL (+ 5e-5·max);
    fused vs unfused shading within IMAGE_ATOL and the gradient tolerance
    with FUSED_GRAD_ATOL_FRAC·max (subgradients at the shader's kinks).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.scene import translation_world as jtranslation_world
from physically_based_renderer_tpu.ops import raster_soft as jsoft
from physically_based_renderer_tpu.renderer import render_soft as jrender_soft
from physically_based_renderer_tpu_torch import Camera, render, scenes
from physically_based_renderer_tpu_torch.models.scene import translation_world
from physically_based_renderer_tpu_torch.ops import raster_row, raster_soft
from physically_based_renderer_tpu_torch.renderer import render_soft
from test_torch_soft_raster import MARGIN, H, W, _sphere, _t
from torch_parity import grad_tolerance, to_port

IMAGE_ATOL = 2e-4
GEOM_RTOL = 1e-3
# Fused vs unfused gradients: the clamp puts fringe pixels exactly on a
# vertex, where the sphere's 45° normals meet a default light at N·L = 0;
# at such a kink kernel 3's adjoint and autograd take different
# subgradients (39 of 3568 layer-0 pixels on the 96×96 sphere)
FUSED_GRAD_ATOL_FRAC = 1e-3


# --- soft_composite ---------------------------------------------------------------


def test_soft_composite_matches_jax():
    """Shared random inputs: three layers, a quarter of the fragments invalid
    (depth +inf, colour NaN), coverage ties across layers (equal distances)
    and a sky background; values and gradients to every float input."""
    rng = np.random.default_rng(11)
    k, h, w = 3, 12, 16
    colors = rng.uniform(0, 1, (k, h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.9, 0.99, (k, h, w)).astype(np.float32)
    sd = rng.normal(0, 2, (k, h, w)).astype(np.float32)
    sd[1, :4] = sd[0, :4]  # coverage ties: max splits its gradient
    valid = rng.uniform(size=(k, h, w)) > 0.25
    depth[~valid] = np.inf
    colors[~valid] = np.nan
    bg = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    g_out = rng.normal(size=(h, w, 3)).astype(np.float32)

    def jfn(c, z, s, b):
        c = jnp.where(jnp.asarray(valid)[..., None], c, 0.0)  # JAX multiplies NaN by a zero weight
        out = jsoft.soft_composite(c, z, s, jnp.asarray(valid), b, sigma=1.0, gamma=1e-2)
        return jnp.sum(out * g_out), out

    jz = jnp.where(jnp.asarray(valid), jnp.asarray(depth), 1.0)  # finite where JAX differentiates
    (_, ref), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(colors), jz, jnp.asarray(sd), jnp.asarray(bg))
    leaves = [_t(x).requires_grad_() for x in (colors, depth, sd, bg)]
    out = raster_soft.soft_composite(leaves[0], leaves[1], leaves[2], _t(valid), leaves[3], sigma=1.0, gamma=1e-2)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-6, rtol=0)
    grads = torch.autograd.grad((out * _t(g_out)).sum(), leaves)
    for name, a, b in zip(("colors", "depth", "sd", "bg"), jg, grads):
        a, b = np.asarray(a), b.numpy()
        if name in ("colors", "depth"):
            assert (b[~valid] == 0).all(), name  # no gradient into an invalid layer
            a, b = a[valid], b[valid]
        grad_tolerance(a, b)


# --- render_soft ------------------------------------------------------------------


def _kernel_peels(monkeypatch):
    monkeypatch.setattr(jsoft, "peel_layers", functools.partial(jsoft.peel_layers, backend="pallas_interpret"))


def _replay_peels(monkeypatch, ids, zs):
    """JAX's render_soft on the port's peels."""
    monkeypatch.setattr(jsoft, "peel_layers", lambda *a, **k: (jnp.asarray(ids.numpy()), jnp.asarray(zs.numpy())))


def test_render_soft_matches_jax_kernel_path(monkeypatch):
    """``render_soft`` at its defaults (K 3, σ 1, γ 1e-2) against JAX's on
    its kernel-5 peels: the image within IMAGE_ATOL wherever the three
    layers' ids agree (the differing ids are attributed by
    test_peel_layers_matches_jax)."""
    jscene, jcam, clip = _sphere()
    _kernel_peels(monkeypatch)
    ref = np.asarray(jrender_soft.__wrapped__(jscene, jcam, width=W, height=H))
    j_ids = np.asarray(jsoft.peel_layers(clip, None, width=W, height=H, num_layers=3, edge_margin_px=MARGIN)[0])
    scene, cam = to_port(jscene, jcam)
    img = render_soft(scene, cam, width=W, height=H, fused_shading=False)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    ids, _ = raster_soft.peel_layers(_t(clip), None, width=W, height=H, num_layers=3, edge_margin_px=MARGIN)
    agree = (ids.numpy() == j_ids).all(0)
    assert agree.mean() > 0.75
    np.testing.assert_allclose(img.numpy()[agree], ref[agree], atol=IMAGE_ATOL, rtol=0)


def _worlds_grad(scene, cam, **kw):
    w = scene.draws[0].worlds.clone().requires_grad_()
    s = dataclasses.replace(scene, draws=(dataclasses.replace(scene.draws[0], worlds=w),))
    img = render_soft(s, cam, width=W, height=H, **kw)
    (g,) = torch.autograd.grad(torch.mean(img**2), w)
    return img, g


def test_render_soft_gradient_matches_jax(monkeypatch):
    """JAX's render_soft replaying the port's peels: the image within
    IMAGE_ATOL everywhere and the gradient of mean(img²) to the world
    matrix within GEOM_RTOL — the differentiable tail (interpolation with
    the clamp, signed distance, shading, composite) is the same function."""
    jscene, jcam, clip = _sphere()
    scene, cam = to_port(jscene, jcam)
    ids, zs = raster_soft.peel_layers(_t(clip), None, width=W, height=H, num_layers=3, edge_margin_px=MARGIN)
    _replay_peels(monkeypatch, ids, zs)

    def jloss(worlds):
        d = jscene.draws[0]
        s = dataclasses.replace(jscene, draws=(dataclasses.replace(d, worlds=worlds),))
        img = jrender_soft.__wrapped__(s, jcam, width=W, height=H)
        return jnp.mean(img**2), img

    (_, ref), jg = jax.value_and_grad(jloss, has_aux=True)(jscene.draws[0].worlds)
    img, g = _worlds_grad(scene, cam, fused_shading=False)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref), atol=IMAGE_ATOL, rtol=0)
    assert float(g.abs().max()) > 0
    grad_tolerance(np.asarray(jg), g.numpy(), rtol=GEOM_RTOL)


def test_render_soft_fused_matches_unfused():
    """Kernel 6 / kernel 3 per layer (``shade_fused``) against
    ``shade_pixels`` on a roughness-0.4 sphere: the image, and the gradients
    to the world matrix and the material bank (FUSED_GRAD_ATOL_FRAC)."""
    scene = scenes.analytic_sphere_scene((0.9, 0.2, 0.1), 0.4, 0.1, slices=24, stacks=12, device="cpu")
    cam = Camera.create(aspect=1.0, device="cpu")
    launches = raster_row.IDS_MARGIN_KERNEL_LAUNCHES
    fused, g_fused = _worlds_grad(scene, cam)
    unfused, g_unfused = _worlds_grad(scene, cam, fused_shading=False)
    assert raster_row.IDS_MARGIN_KERNEL_LAUNCHES == launches  # CPU tensors: the plain version
    np.testing.assert_allclose(fused.detach().numpy(), unfused.detach().numpy(), atol=IMAGE_ATOL, rtol=0)
    grad_tolerance(g_unfused.numpy(), g_fused.numpy(), atol_frac=FUSED_GRAD_ATOL_FRAC)
    grads = []
    for fused_shading in (True, False):
        leaves = {k: getattr(scene.materials, k).clone().requires_grad_() for k in ("diffuse", "roughness")}
        s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves))
        img = render_soft(s, cam, width=W, height=H, fused_shading=fused_shading)
        grads.append(torch.autograd.grad(torch.mean(img**2), list(leaves.values())))
    for a, b in zip(*grads):
        assert float(a.abs().sum()) > 0
        grad_tolerance(b.numpy(), a.numpy(), atol_frac=FUSED_GRAD_ATOL_FRAC)


# --- the behaviours of tests/test_soft.py -----------------------------------------



def test_soft_converges_to_hard():
    scene = scenes.analytic_sphere_scene(slices=24, stacks=12, device="cpu")
    cam = Camera.create(aspect=1.0, device="cpu")
    hard = render(scene, cam, width=W, height=H)[..., :3].numpy()
    soft = render_soft(scene, cam, width=W, height=H, sigma=0.02, gamma=1e-4).numpy()
    diff = np.abs(hard - soft).max(-1)
    assert (diff > 3e-2).mean() < 0.02, (diff > 3e-2).mean()  # tight except a thin silhouette band
    assert np.median(diff) < 1e-3


def _shifted(scene, dx):
    draw = scene.draws[0]
    w = draw.worlds.clone()
    w[:, 3, 0] = w[:, 3, 0] + dx
    return dataclasses.replace(scene, draws=(dataclasses.replace(draw, worlds=w),))


def test_geometry_gradient_through_silhouette():
    """Moving a dark sphere right darkens the right half: the gradient of the
    right half's mean brightness to the x translation has the sign of the
    least-squares slope over ±0.06 and is within a factor 2 of it."""
    scene0 = scenes.analytic_sphere_scene((0.02, 0.02, 0.02), 1.0, 0.0, slices=16, stacks=8, device="cpu")
    cam = Camera.create(aspect=1.0, device="cpu")

    def brightness(dx):
        return render_soft(_shifted(scene0, dx), cam, width=W, height=H, sigma=1.5, gamma=1e-3)[:, W // 2:].mean()

    dx = torch.zeros((), requires_grad=True)
    (g,) = torch.autograd.grad(brightness(dx), dx)
    g = float(g)
    xs = np.linspace(-0.06, 0.06, 7)
    with torch.no_grad():
        vals = np.asarray([float(brightness(float(x))) for x in xs])
    slope = np.linalg.lstsq(np.vstack([xs, np.ones_like(xs)]).T, vals, rcond=None)[0][0]
    assert np.isfinite(g) and abs(g) > 1e-3, "no silhouette gradient"
    assert np.sign(g) == np.sign(slope)
    assert 0.5 <= g / slope <= 2.0, (g, slope)


def _jax_kernel_path(monkeypatch):
    """JAX's render_soft, un-jitted, on its kernel-5 peels."""
    _kernel_peels(monkeypatch)
    return jrender_soft.__wrapped__


def test_vertex_gradient_against_finite_differences(monkeypatch):
    """The gradient of mean(render_soft) to a uniform scale of the mesh,
    against central differences at ±2%. On the JAX package's kernel path,
    as on the port, the two are a factor ~3 apart (g/fd ≈ 0.3): kernel 5
    orders a dilated pixel's fragments by their planes' depth extrapolated
    outside the triangle, which JAX's jnp rasterizer clamps to the
    triangle's depth range (there test_soft.py's rtol 0.2 holds). So the
    port is held to the kernel path: its gradient and its difference
    quotient each within 15% of JAX's, finite, nonzero, of one sign."""
    jscene = jscenes.analytic_sphere_scene(slices=12, stacks=6)
    jcam = JCamera.create(aspect=1.0)
    jrs = _jax_kernel_path(monkeypatch)
    scene, cam = to_port(jscene, jcam)

    def jloss(scale):
        d = jscene.draws[0]
        s = dataclasses.replace(jscene, draws=(dataclasses.replace(d, mesh=dataclasses.replace(
            d.mesh, positions=d.mesh.positions * scale)),))
        return jnp.mean(jrs(s, jcam, width=64, height=64, sigma=1.0))

    def loss(scale):
        draw = scene.draws[0]
        mesh2 = dataclasses.replace(draw.mesh, positions=draw.mesh.positions * scale)
        s = dataclasses.replace(scene, draws=(dataclasses.replace(draw, mesh=mesh2),))
        return render_soft(s, cam, width=64, height=64, sigma=1.0).mean()

    scale = torch.ones((), requires_grad=True)
    (g,) = torch.autograd.grad(loss(scale), scale)
    g = float(g)
    with torch.no_grad():
        fd = (float(loss(1.02)) - float(loss(0.98))) / 0.04
    jg = float(jax.jit(jax.grad(jloss))(1.0))
    jfd = (float(jloss(1.02)) - float(jloss(0.98))) / 0.04
    assert np.isfinite(g) and abs(g) > 1e-4 and np.sign(g) == np.sign(fd)
    np.testing.assert_allclose(g, jg, rtol=0.15)
    np.testing.assert_allclose(fd, jfd, rtol=0.15)


def test_translation_optimization_follows_the_kernel_path(monkeypatch):
    """Inverse rendering through visibility: 120 Adam steps (test_soft.py's
    lr 0.02, betas 0.9 / 0.99) on the soft render toward a soft target at
    (0.45, −0.3). From test_soft.py's start, the origin, the kernel path's
    gradient is biased toward (−, +) by the dilated fragments' extrapolated
    depth (see the test above): both packages drift away from the target,
    along trajectories that CPU-thread rounding in the gathers' backward
    makes chaotic (ROADMAP C). From a start 0.1 off on the other side of the
    target (~1.5 px), the kernel path recovers it: the port and JAX's kernel
    path each end within 0.03 of the target (test_soft.py's tolerance;
    0.0025–0.025 measured over thread counts) with the loss at most 0.6 of
    its start (0.27–0.43 measured)."""
    jbase = jscenes.analytic_sphere_scene((0.9, 0.2, 0.1), 0.4, 0.1, slices=16, stacks=8)
    jcam = JCamera.create(aspect=1.0)
    jrs = _jax_kernel_path(monkeypatch)
    base, cam = to_port(jbase, jcam)
    true_offset = np.asarray([0.45, -0.3], np.float32)
    start = true_offset + np.asarray([0.1, -0.1], np.float32)
    lr, b1, b2, steps = 0.02, 0.9, 0.99, 120

    def jscene_at(o):
        w = jnp.asarray(jtranslation_world(0.0, 0.0, 0.0)).at[3, 0].set(o[0]).at[3, 1].set(o[1])
        return dataclasses.replace(jbase, draws=(dataclasses.replace(jbase.draws[0], worlds=w[None]),))

    jtarget = jrs(jscene_at(jnp.asarray(true_offset)), jcam, width=64, height=64, sigma=1.0, gamma=1e-2)
    jstep = jax.jit(jax.value_and_grad(
        lambda o: jnp.mean((jrs(jscene_at(o), jcam, width=64, height=64, sigma=1.0, gamma=1e-2) - jtarget) ** 2)))
    jo, m, v = jnp.asarray(start), jnp.zeros(2), jnp.zeros(2)
    for t in range(1, steps + 1):
        jloss, g = jstep(jo)
        jl0 = float(jloss) if t == 1 else jl0
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        jo = jo - lr * (m / (1 - b1**t)) / (jnp.sqrt(v / (1 - b2**t)) + 1e-8)

    world0 = torch.as_tensor(translation_world(0.0, 0.0, 0.0))

    def scene_at(offset):
        w = torch.cat([world0[:3], torch.cat([offset, world0[3, 2:]])[None]], 0)
        return dataclasses.replace(base, draws=(dataclasses.replace(base.draws[0], worlds=w[None]),))

    with torch.no_grad():
        target = render_soft(scene_at(torch.as_tensor(true_offset)), cam, width=64, height=64, sigma=1.0, gamma=1e-2)
    offset = torch.as_tensor(start).clone().requires_grad_()
    opt = torch.optim.Adam([offset], lr=lr, betas=(b1, b2), eps=1e-8)
    for i in range(steps):
        opt.zero_grad()
        loss = torch.mean((render_soft(scene_at(offset), cam, width=64, height=64, sigma=1.0, gamma=1e-2)
                           - target) ** 2)
        l0 = float(loss.detach()) if i == 0 else l0
        loss.backward()
        opt.step()
    got = offset.detach().numpy()
    assert np.isfinite(got).all() and np.isfinite(float(loss.detach()))
    np.testing.assert_allclose(np.asarray(jo), true_offset, atol=0.03)
    np.testing.assert_allclose(got, true_offset, atol=0.03)
    assert float(jloss) < 0.6 * jl0 and float(loss) < 0.6 * l0, (float(jloss), jl0, float(loss), l0)
