"""PyTorch port vs the JAX package: shading of a resolved G-buffer band.

* ``shade_forward_plain`` (what CPU tensors run in place of the kernel
  ``csrc/shade_forward.cu``) against JAX ``shade_forward(interpret=True)``
  on a random G-buffer under every light kind, in the shade mode (with and
  without the tonemap) and the IBL mode: atol 2e-4, the fused kernels'
  shading tolerance (``tests/test_raster_shade.py``), plus rtol 1e-4 for the
  IBL mode's HDR channels.
* ``shade_fused`` gradients (attributes, material table, light strength,
  direction, position and spot power, ambient, eye) against JAX
  ``shade_fused``'s custom VJP: ``|Δ| ≤ 5e-5·max|ref| + 1e-10 +
  2e-3·|ref|``, the JAX suite's gradient tolerance.
* ``shade_compose_band_attrs`` and ``shade_compose_band`` on the grid
  against JAX's: on the CPU the JAX package shades a band through
  ``shade_pixels``, the port through ``shade_fused``; the two agree within
  2e-5, the bound of ``tests/test_raster_shade.py:273``, on every pixel but
  those of the roughness-0 spheres (clamped to 0.05). There the JAX
  package's float32 GGX noise reaches 3.2e-4 (ROADMAP §C), so the port is
  held within 2e-5 of its own shader in float64, and within that noise of
  JAX. Alpha-tested and IBL-lit bands shade through ``shade_pixels`` on
  both sides, within the same bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu import renderer as jrenderer
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster as jraster
from physically_based_renderer_tpu.ops import raster_pallas as jrp
from physically_based_renderer_tpu.ops import shade_core as jsc
from physically_based_renderer_tpu_torch import renderer
from physically_based_renderer_tpu_torch.ops import raster_pallas
from physically_based_renderer_tpu_torch.ops import shade_core as tsc
from torch_parity import grad_tolerance, random_gbuffer, seeded_env, to_port

ATOL, IBL_RTOL = 2e-4, 1e-4
BAND_ATOL = 2e-5
JAX_GGX_NOISE = 3.2e-4  # the JAX package's own float32 paths at 0.05 roughness (ROADMAP §C)
W, H = 128, 64
LIGHT_KEYS = ("light_strength", "light_direction", "light_position", "light_spot_power", "ambient", "eye")


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("mode", ["tonemap", "hdr", "ibl"])
def test_shade_forward_plain_matches_jax_kernel(mode):
    gb = random_gbuffer(31 + len(mode))
    ibl = mode == "ibl"
    sh9 = np.random.default_rng(4).normal(size=(9, 3)).astype(np.float32) if ibl else None
    kw = dict(gb["counts"], ibl=ibl, apply_tonemap=mode == "tonemap")
    uni_j = jsc.pack_shading_uniforms(**{k: jnp.asarray(v) for k, v in gb["lights"].items()},
                                      sh9=None if sh9 is None else jnp.asarray(sh9))
    args = [gb["attrs"], gb["mat_id"], gb["hit"], gb["mat_props"]]
    ref = np.asarray(jrp.shade_forward(*(jnp.asarray(a) for a in args), uni_j, interpret=True, **kw))
    uni = tsc.pack_shading_uniforms(**{k: _t(v) for k, v in gb["lights"].items()},
                                    sh9=None if sh9 is None else _t(sh9))
    got = raster_pallas.shade_forward(*(_t(a) for a in args), uni, **kw).numpy()
    assert got.shape == ref.shape == (32, 128, 11 if ibl else 4)
    assert not got[~gb["hit"]].any(), "background must be exact zeros"
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=IBL_RTOL if ibl else 0)
    assert np.abs(got[gb["hit"]]).max() > 0.1


def test_shade_fused_gradients_match_jax():
    gb = random_gbuffer(41)
    counts = gb["counts"]
    cot = np.random.default_rng(42).normal(size=(32, 128, 4)).astype(np.float32)
    lights = [gb["lights"][k] for k in LIGHT_KEYS]

    def jloss(attrs, table, *lts):
        out = jrp.shade_fused(attrs, jnp.asarray(gb["mat_id"]), jnp.asarray(gb["hit"]), table, *lts,
                              interpret=True, **counts)
        return jnp.sum(out * cot)

    argnums = tuple(range(2 + len(lights)))
    ref = jax.grad(jloss, argnums=argnums)(jnp.asarray(gb["attrs"]), jnp.asarray(gb["mat_props"]),
                                           *(jnp.asarray(v) for v in lights))
    leaves = [_t(gb["attrs"]), _t(gb["mat_props"]), *(_t(v) for v in lights)]
    leaves = [t.requires_grad_() for t in leaves]
    out = raster_pallas.shade_fused(leaves[0], _t(gb["mat_id"]), _t(gb["hit"]), *leaves[1:], **counts)
    before = raster_pallas.SHADE_FWD_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    got = torch.autograd.grad(torch.sum(out * _t(cot)), leaves)
    assert (raster_pallas.SHADE_FWD_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES) == before  # plain on the CPU
    for name, a, b in zip(("attrs", "table") + LIGHT_KEYS, ref, got):
        assert b.shape == a.shape, name
        grad_tolerance(np.asarray(a), b.numpy())
    assert not got[0].numpy()[~gb["hit"]].any()
    assert all(np.abs(g.numpy()).max() > 0 for g in got)


def _grid_band(sky: bool):
    """The grid (with a seeded f32 sky, or the clear colour) and the JAX
    G-buffer of the band [8, 56): tri ids from the jnp raster, attributes
    from the JAX interpolation."""
    scene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    if sky:
        scene = dataclasses.replace(scene, sky_map=jnp.asarray(seeded_env(6)))
    cam = JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H)
    geom = jflatten(scene, textured=False)
    clip = jmath3d.transform_points_h(geom.pos_w, cam.view_proj())
    tri_id = jraster.rasterize(clip, None, width=W, height=H, rows=48, y_offset=8)
    attrs, _, mask = jraster.interpolate_corners(geom.attrs, clip, tri_id, width=W, height=H, y_offset=8)
    return scene, cam, geom, clip, tri_id, attrs, mask


@pytest.mark.parametrize("sky", [False, True])
@pytest.mark.parametrize("entry", ["attrs", "ids"])
def test_shade_compose_band_matches_jax(entry, sky):
    scene, cam, geom, clip, tri_id, attrs, mask = _grid_band(sky)
    kw = dict(width=W, height=H, y_offset=8)
    pscene, pcam = to_port(scene, cam)
    if entry == "attrs":
        pix_mat = geom.face_material[jnp.maximum(tri_id, 0)]
        ref = jrenderer.shade_compose_band_attrs(scene, cam, attrs, mask, pix_mat, **kw)
        got = renderer.shade_compose_band_attrs(pscene, pcam, _t(attrs), _t(mask), _t(pix_mat), **kw)
    else:
        ref = jrenderer.shade_compose_band(scene, cam, geom, clip, tri_id, **kw)
        pgeom = dataclasses.replace(geom, attrs=_t(geom.attrs), face_material=_t(geom.face_material))
        got = renderer.shade_compose_band(pscene, pcam, pgeom, _t(clip), _t(tri_id), **kw)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (48, W, 4)
    assert 0.05 < np.asarray(mask).mean() < 0.95
    pix_mat = np.asarray(geom.face_material)[np.maximum(np.asarray(tri_id), 0)]
    sharp = np.asarray(mask) & (np.asarray(scene.materials.roughness)[pix_mat] <= 0.05)
    np.testing.assert_allclose(got[~sharp], ref[~sharp], atol=BAND_ATOL, rtol=0)
    np.testing.assert_allclose(got[sharp], ref[sharp], atol=JAX_GGX_NOISE, rtol=0)
    L = pscene.lights
    uni = tsc.pack_shading_uniforms(L.strength, L.direction, L.position, L.spot_power, pscene.ambient,
                                    pcam.position).double()
    f64 = raster_pallas.shade_forward_plain(
        _t(attrs)[..., :6].double(), _t(pix_mat), _t(mask), pscene.materials.props_table().double(), uni,
        num_dir=L.num_dir, num_point=L.num_point, num_spot=L.num_spot,
    ).numpy()
    assert sharp.sum() > 100
    np.testing.assert_allclose(got[sharp], f64[sharp], atol=BAND_ATOL, rtol=0)


def test_shade_compose_band_alpha_and_ibl():
    """Alpha-tested and IBL-lit bands no longer raise: like the JAX package,
    they shade through ``shade_pixels`` (no alpha peel, the IBL ambient in
    the shader), within the band-compose bound of JAX's (and the JAX
    package's float32 GGX noise on the roughness-0 spheres). Textured bands:
    ``tests/test_torch_sharded.py``."""
    scene, cam, geom, clip, tri_id, attrs, mask = _grid_band(False)
    pix_mat = geom.face_material[jnp.maximum(tri_id, 0)]
    sharp = np.asarray(mask) & (np.asarray(scene.materials.roughness)[np.asarray(pix_mat)] <= 0.05)
    env = jnp.asarray(seeded_env(6))
    cutout = dataclasses.replace(scene.materials, alpha_test=jnp.ones_like(scene.materials.alpha_test),
                                 any_alpha_test=True)
    for variant in (dataclasses.replace(scene, materials=cutout),
                    dataclasses.replace(scene, env_map=env).with_ibl()):
        kw = dict(width=W, height=H, y_offset=8)
        ref = np.asarray(jrenderer.shade_compose_band_attrs(variant, cam, attrs, mask, pix_mat, **kw))
        pscene, pcam = to_port(variant, cam)
        before = raster_pallas.SHADE_FWD_LAUNCHES
        got = renderer.shade_compose_band_attrs(pscene, pcam, _t(attrs), _t(mask), _t(pix_mat), **kw).numpy()
        assert raster_pallas.SHADE_FWD_LAUNCHES == before
        np.testing.assert_allclose(got[~sharp], ref[~sharp], atol=BAND_ATOL, rtol=0)
        np.testing.assert_allclose(got[sharp], ref[sharp], atol=JAX_GGX_NOISE, rtol=0)
