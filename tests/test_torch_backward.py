"""PyTorch port vs the JAX package: the backward of the fused raster+shade
path.

* ``shade_backward_plain`` (what CPU tensors run in place of the kernel
  ``csrc/shade_backward.cu``) against JAX ``shade_backward(interpret=True)``
  on a random G-buffer under every light kind, and against a float64
  evaluation of itself at 0.05-roughness highlights, where the JAX
  package's own float32 paths differ by ~3e-4 and are no tighter reference;
* ``_scatter_props_by_id`` and ``interpolate_corners`` (values and VJP)
  against JAX;
* ``render`` gradients (materials, light strength, eye, world matrices)
  against JAX ``render(raster_backend="jnp")`` on the grid, the point/spot
  scene and a band.

Tolerance: ``|Δ| ≤ 5e-5·max|ref| + 1e-10 + 2e-3·|ref|``, the JAX suite's own
for its fused backward (``tests/test_raster_shade.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.ops import raster as jraster
from physically_based_renderer_tpu.ops import raster_pallas as jrp
from physically_based_renderer_tpu.ops import shade_core as jsc
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch import math3d, render
from physically_based_renderer_tpu_torch.models.scene import flatten_scene_corners
from physically_based_renderer_tpu_torch.ops import raster, raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops import shade_core as tsc
from test_torch_render import _grid, _lit_spheres
from torch_parity import grad_tolerance, random_gbuffer, to_port


def _port_inputs(gb, dtype=torch.float32):
    t = lambda x: torch.as_tensor(x)
    uni = tsc.pack_shading_uniforms(**{k: t(v) for k, v in gb["lights"].items()})
    return (t(gb["g_chan"]).to(dtype), t(gb["attrs"]).to(dtype), t(gb["mat_id"]), t(gb["hit"]),
            t(gb["mat_props"]).to(dtype), uni.to(dtype))


@pytest.mark.parametrize("apply_tonemap", [True, False])
def test_shade_backward_plain_matches_jax_kernel(apply_tonemap):
    gb = random_gbuffer(5 + apply_tonemap)
    kw = dict(gb["counts"], apply_tonemap=apply_tonemap)
    uni_j = jsc.pack_shading_uniforms(**{k: jnp.asarray(v) for k, v in gb["lights"].items()})
    ref = jrp.shade_backward(
        jnp.asarray(gb["g_chan"]), jnp.asarray(gb["attrs"]), jnp.asarray(gb["mat_id"]),
        jnp.asarray(gb["hit"]), jnp.asarray(gb["mat_props"]), uni_j, ibl=False, interpret=True, **kw,
    )
    got = raster_pallas.shade_backward(*_port_inputs(gb), **kw)
    for name, a, b in zip(("g_attrs", "g_props", "g_uni"), ref, got):
        assert b.shape == a.shape, name
        if name != "g_uni":
            assert not b.numpy()[~gb["hit"]].any(), f"{name} must be exactly zero off-hit"
        grad_tolerance(np.asarray(a), b.numpy())
    # every light's slots carry a gradient (the spot light's power included)
    g_lights = got[2].numpy()[0, 8:].reshape(4, 10)
    assert (np.abs(g_lights[:, 0:3]).max(1) > 0).all() and g_lights[3, 9] != 0
    # the table cotangent against the JAX package's scatter of its g_props
    ref_table = jrp._scatter_props_by_id(
        jnp.where(jnp.asarray(gb["hit"])[..., None], ref[1], 0.0), jnp.asarray(gb["mat_id"]), 5, 9)
    assert got[3].shape == (5, 9)
    grad_tolerance(np.asarray(ref_table), got[3].numpy())


def test_shade_backward_plain_at_sharp_highlights_matches_float64():
    """Roughness 0.05 with normals on the first light's half vector: the
    float32 adjoint against the same adjoint in float64."""
    gb = random_gbuffer(9, roughness=0.05, highlight_frac=0.5)
    kw = dict(gb["counts"], apply_tonemap=True)
    got = raster_pallas.shade_backward(*_port_inputs(gb), **kw)
    ref = raster_pallas.shade_backward_plain(*_port_inputs(gb, torch.float64), **kw)
    for a, b in zip(ref, got):
        assert a.dtype == torch.float64 and b.dtype == torch.float32
        grad_tolerance(a.numpy(), b.numpy())
    # The highlights are really there: many hit pixels shade far above 1 in HDR.
    _, attrs, _, hit, props, uni = _port_inputs(gb)
    a, p = attrs[hit], props[torch.as_tensor(gb["mat_id"])[hit].long()]
    hdr = tsc.shade_core(a[:, :3].unbind(1), a[:, 3:].unbind(1), p.unbind(1), uni,
                         apply_tonemap=False, **gb["counts"])
    assert (hdr[0] > 10).float().mean() > 0.05


def test_scatter_props_by_id_matches_jax():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(16, 24, 9)).astype(np.float32)
    mid = rng.integers(-1, 8, (16, 24)).astype(np.int32)  # −1 and 7 fall outside M = 7
    ref = jrp._scatter_props_by_id(jnp.asarray(g), jnp.asarray(mid), 7, 12)
    got = raster_pallas._scatter_props_by_id(torch.as_tensor(g), torch.as_tensor(mid), 7, 12)
    assert got.shape == (7, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("y_offset", [0, 20])
def test_interpolate_corners_matches_jax(y_offset):
    jscene, jcam = _grid(128, 64)
    scene, cam = to_port(jscene, jcam)
    g = flatten_scene_corners(scene)
    clip = math3d.transform_points_h(g.pos_w, cam.view_proj())
    rows = 64 - y_offset
    tri_id = raster_row.rasterize_binned_shade_row(
        clip, g.attrs, g.face_material, scene.materials.props_table(), scene.lights.strength,
        scene.lights.direction, scene.lights.position, scene.lights.spot_power, scene.ambient,
        cam.position, width=128, height=64, rows=rows, y_offset=y_offset, tile_h=8,
        num_materials=49, num_dir=4,
    ).tri_id
    assert (tri_id >= 0).float().mean() > 0.05
    # Cotangents on hit pixels only: JAX sends background cotangents into
    # triangle 0, the port none (render masks them to hits either way).
    m = tri_id.numpy() >= 0
    cot = np.random.default_rng(4).normal(size=(rows, 128, 6)).astype(np.float32) * m[..., None]
    cot_d = np.random.default_rng(5).normal(size=(rows, 128)).astype(np.float32) * m

    def jfn(pa, vc):
        a, d, _ = jraster.interpolate_corners(pa, vc, jnp.asarray(tri_id.numpy()), width=128,
                                              height=64, y_offset=y_offset)
        return a, d

    (ja, jd), pull = jax.vjp(jfn, jnp.asarray(g.attrs.numpy()), jnp.asarray(clip.numpy()))
    jga, jgc = pull((jnp.asarray(cot), jnp.asarray(cot_d)))
    pa = g.attrs.clone().requires_grad_()
    vc = clip.clone().requires_grad_()
    a, d, mask = raster.interpolate_corners(pa, vc, tri_id, width=128, height=64, y_offset=y_offset)
    torch.autograd.backward((a, d), (torch.as_tensor(cot), torch.as_tensor(cot_d)))
    assert torch.equal(mask, tri_id >= 0)
    np.testing.assert_allclose(a.detach().numpy()[m], np.asarray(ja)[m], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(d.detach().numpy()[m], np.asarray(jd)[m], atol=1e-6)
    grad_tolerance(np.asarray(jga), pa.grad.numpy())
    grad_tolerance(np.asarray(jgc), vc.grad.numpy())


GRAD_CASES = {
    "grid_128x64": (_grid, 128, 64, {}),
    "lit_spheres_64x64": (_lit_spheres, 64, 64, {}),
    "grid_band_24_at_20": (_grid, 128, 64, dict(rows=24, y_offset=20)),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_render_gradients_match_jax(case):
    make, width, height, band = GRAD_CASES[case]
    jscene, jcam = make(width, height)
    kw = dict(width=width, height=height, **band)

    def jloss(mats, strength, eye, worlds):
        s = dataclasses.replace(
            jscene, materials=mats, lights=dataclasses.replace(jscene.lights, strength=strength),
            draws=tuple(dataclasses.replace(d, worlds=w) for d, w in zip(jscene.draws, worlds)),
        )
        img = jrender(s, dataclasses.replace(jcam, position=eye), raster_backend="jnp", **kw)
        return jnp.mean(img[..., :3] ** 2)

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3), allow_int=True)(
        jscene.materials, jscene.lights.strength, jcam.position, tuple(d.worlds for d in jscene.draws)
    )
    scene, cam = to_port(jscene, jcam)
    mats = {k: getattr(scene.materials, k).clone().requires_grad_()
            for k in ("diffuse", "roughness", "metallic", "fresnel_r0")}
    strength = scene.lights.strength.clone().requires_grad_()
    eye = cam.position.clone().requires_grad_()
    worlds = [d.worlds.clone().requires_grad_() for d in scene.draws]
    s = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mats),
        lights=dataclasses.replace(scene.lights, strength=strength),
        draws=tuple(dataclasses.replace(d, worlds=w) for d, w in zip(scene.draws, worlds)),
    )
    before = raster_pallas.GEOMETRY_RECOMPUTES
    torch.mean(render(s, dataclasses.replace(cam, position=eye), **kw)[..., :3] ** 2).backward()
    assert raster_pallas.GEOMETRY_RECOMPUTES == before + 1
    for k, t in mats.items():
        grad_tolerance(getattr(gj[0], k), t.grad.numpy())
    grad_tolerance(gj[1], strength.grad.numpy())
    grad_tolerance(gj[2], eye.grad.numpy())
    for a, w in zip(gj[3], worlds):
        grad_tolerance(a, w.grad.numpy())
        assert float(w.grad.abs().sum()) > 0


def test_material_only_gradients_skip_the_geometry_recompute():
    scene, cam = to_port(*_grid(64, 32))
    rough = scene.materials.roughness.clone().requires_grad_()
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, roughness=rough))
    before = raster_pallas.GEOMETRY_RECOMPUTES, raster_pallas.SHADE_BWD_LAUNCHES
    torch.mean(render(s, cam, width=64, height=32)[..., :3] ** 2).backward()
    assert (raster_pallas.GEOMETRY_RECOMPUTES, raster_pallas.SHADE_BWD_LAUNCHES) == before
    assert torch.isfinite(rough.grad).all() and float(rough.grad.abs().sum()) > 0


def test_cpu_tensors_never_reach_the_backward_kernel():
    gb = random_gbuffer(2, rows=4, width=8)
    with pytest.raises(ValueError, match="CUDA"):
        raster_pallas.shade_backward_cuda(*_port_inputs(gb), **gb["counts"], apply_tonemap=True)
