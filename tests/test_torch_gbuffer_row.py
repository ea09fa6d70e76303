"""PyTorch port vs the JAX package: the raster + G-buffer step (the G-buffer
mode of the row kernel) and its differentiable wrapper.

The port's plain version (``raster_gbuffer_tiles_plain``, what CPU tensors
run) is held against the JAX ``rasterize_binned_gbuffer_row`` in Pallas
interpret mode from identical clip coordinates: triangle and material ids
exactly equal; attributes within atol 2e-4 (the row kernel's G-buffer
tolerance in ``tests/test_torch_raster_row.py``: world positions ~10, and
XLA contracts some binning products into FMAs); depth within atol 2e-6 (NDC
depth in [0, 1], the same ulp-level field differences). Cases: the full
frame at C = 6, a band at ``y_offset`` ≠ 0 that ends in a partial 8-row
tile, C = 14 seeded attributes without material ids, and a two-layer depth
peel (a sphere in front of a sphere) through ``z_floor``, each side peeling
against its own first layer's depths (they differ by ulps, and against the
other side's floor a front triangle an ulp behind it would survive). Then
``raster_gbuffer``'s gradients to the clip coordinates and the attributes
against JAX's VJP, at the gradient tolerance of
``tests/test_torch_backward.py``. The CUDA kernel is held against the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.material import MaterialBuilder as JMaterialBuilder
from physically_based_renderer_tpu.models.mesh import sphere_mesh as jsphere_mesh
from physically_based_renderer_tpu.models.scene import InstancedDraw as JDraw
from physically_based_renderer_tpu.models.scene import Scene as JScene
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster_pallas as jpallas
from physically_based_renderer_tpu.ops import raster_row as jrow
from physically_based_renderer_tpu.ops.brdf import Lights as JLights
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from torch_parity import grad_tolerance

ATTR_ATOL = 2e-4
DEPTH_ATOL = 2e-6
W, H = 128, 64
BINS = dict(tile_h=8, max_span=16)  # the triangle-sharded ring's settings


def _grid_geometry():
    scene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    cam = JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H)
    g = jflatten(scene, textured=False)
    return jmath3d.transform_points_h(g.pos_w, cam.view_proj()), g.attrs, g.face_material, 49


def _two_spheres():
    """A red sphere in front of a larger blue one, seen down +z: two layers."""
    mb = JMaterialBuilder()
    mb.add("front", diffuse=(0.9, 0.1, 0.1))
    mb.add("back", diffuse=(0.1, 0.1, 0.9))
    worlds = np.stack([np.eye(4, dtype=np.float32)] * 2)
    worlds[0, :3, :3] *= 0.8
    worlds[1, :3, :3] *= 1.6
    worlds[1, 3, :3] = (0.3, 0.2, 3.0)
    scene = JScene(draws=(JDraw.create(jsphere_mesh(1.0, 16, 8), worlds, [0, 1]),), materials=mb.build(),
                   atlas=None, lights=JLights.default_scene_lights(), ambient=jnp.zeros(3))
    cam = JCamera.create(position=(0.0, 0.0, -5.0), aspect=W / H)
    g = jflatten(scene, textured=False)
    return jmath3d.transform_points_h(g.pos_w, cam.view_proj()), g.attrs, g.face_material, 2


def _c14(clip, attrs, fm, m):
    rng = np.random.default_rng(3)
    extra = rng.normal(size=attrs.shape[:2] + (8,)).astype(np.float32)
    return clip, jnp.concatenate([attrs, jnp.asarray(extra)], -1), None, 0


CASES = {
    "c6_full_frame": (lambda: _grid_geometry(), dict()),
    "c6_band_partial_tile": (lambda: _grid_geometry(), dict(rows=20, y_offset=37)),
    "c14_no_materials": (lambda: _c14(*_grid_geometry()), dict(rows=32, y_offset=16)),
}


def _both(clip, attrs, fm, num_materials, floors=(None, None), **kw):
    """The JAX kernel (interpret mode) and the port's plain version on the
    same inputs → (jax outputs as numpy, port GBufferRowResult). ``floors``:
    each side's own z_floor (a peel compares against the depths that side
    wrote, which differ by ulps between the two)."""
    kw = dict(width=W, height=H, num_materials=num_materials, **BINS, **kw)
    zj, zp = floors
    ref = jrow.rasterize_binned_gbuffer_row(clip, attrs, fm, interpret=True,
                                            z_floor=None if zj is None else jnp.asarray(zj), **kw)
    t = lambda x: None if x is None else torch.as_tensor(np.array(x))
    out = raster_row.rasterize_binned_gbuffer_row(t(clip), t(attrs), t(fm), z_floor=t(zp), **kw)
    assert not bool(out.overflowed)
    return [None if r is None else np.asarray(r) for r in ref], out


def _assert_match(ref, out):
    np.testing.assert_array_equal(out.tri_id.numpy(), ref[2])
    if ref[3] is None:
        assert out.mat_id is None
    else:
        np.testing.assert_array_equal(out.mat_id.numpy(), ref[3])
    np.testing.assert_allclose(out.attrs.numpy(), ref[0], atol=ATTR_ATOL, rtol=0)
    np.testing.assert_allclose(out.depth.numpy(), ref[1], atol=DEPTH_ATOL, rtol=0)
    bg = ref[2] < 0
    assert not out.attrs.numpy()[bg].any() and not out.depth.numpy()[bg].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_gbuffer_kernel(case):
    make, kw = CASES[case]
    ref, out = _both(*make(), **kw)
    _assert_match(ref, out)
    assert out.attrs.shape[-1] == (14 if case.startswith("c14") else 6)
    assert 0.05 < (ref[2] >= 0).mean() < 0.95


def test_z_floor_peels_the_second_layer():
    """Layer 2 is the G-buffer strictly behind layer 1's depth (−inf where
    layer 1 missed): the back sphere where the front one covers it, nothing
    behind the back sphere (its back faces are culled)."""
    geo = _two_spheres()
    ref1, out1 = _both(*geo)
    _assert_match(ref1, out1)
    hit1 = ref1[2] >= 0
    floors = (np.where(hit1, ref1[1], -np.inf).astype(np.float32),
              torch.where(out1.tri_id >= 0, out1.depth, -torch.inf))
    ref2, out2 = _both(*geo, floors=floors)
    _assert_match(ref2, out2)
    front = hit1 & (ref1[3] == 0)
    hit2 = ref2[2] >= 0
    assert front.sum() > 100 and hit2[front].mean() > 0.9
    assert (ref2[3][hit2] == 1).all(), "the peel found something other than the back sphere"
    assert not hit2[hit1 & (ref1[3] == 1)].any() and not hit2[~hit1].any()
    assert (ref2[1][hit2] > ref1[1][hit2]).all()


def test_raster_gbuffer_gradients_match_jax():
    """Gradients of a seeded weighting of the attributes and the depth to
    the clip coordinates and the corner attributes, through the recompute."""
    clip, attrs, fm, m = _grid_geometry()
    kw = dict(width=W, height=H, rows=48, y_offset=8, num_materials=m, **BINS)
    rng = np.random.default_rng(11)
    wa = rng.normal(size=(48, W, 6)).astype(np.float32)
    wd = rng.normal(size=(48, W)).astype(np.float32)

    def jloss(vc, pa):
        a, d, _, _ = jpallas.raster_gbuffer(vc, pa, None, fm, row_layout=True, interpret=True, **kw)
        return jnp.sum(a * wa) + jnp.sum(d * wd)

    jg = jax.grad(jloss, argnums=(0, 1))(clip, attrs)
    vc = torch.as_tensor(np.array(clip)).requires_grad_()
    pa = torch.as_tensor(np.array(attrs)).requires_grad_()
    out = raster_pallas.raster_gbuffer(vc, pa, torch.as_tensor(np.array(fm)), **kw)
    before = raster_pallas.GEOMETRY_RECOMPUTES
    loss = torch.sum(out.attrs * torch.as_tensor(wa)) + torch.sum(out.depth * torch.as_tensor(wd))
    g_vc, g_pa = torch.autograd.grad(loss, (vc, pa))
    assert raster_pallas.GEOMETRY_RECOMPUTES == before + 1
    grad_tolerance(np.asarray(jg[0]), g_vc.numpy())
    grad_tolerance(np.asarray(jg[1]), g_pa.numpy())
    assert np.abs(g_vc.numpy()).max() > 0 and np.abs(g_pa.numpy()).max() > 0
