"""PyTorch port vs the JAX package: ``render_layered``, the material-layer
draw (solid depth peels with the alpha test, then transparent layers blended
front to back), on the two-sphere scene of ``tests/test_layered.py`` at
96×96 in each of its cases, and on a small textured scene.

The JAX package's CPU branch peels with its jnp rasterizer
(``raster.rasterize``); the port peels with kernel 5 (``rasterize_binned``)
on both devices. So each case first replays the frame's four peels through
JAX's two rasterizers and the port's, each behind its own depths: the ids
of JAX's two rasterizers must agree, and the port's must equal JAX's
kernel's. Then the image elementwise (atol 2e-4, the untextured frame
tolerance of ``tests/test_torch_render.py``) and the gradient of
mean(img[..., :3]²) to the material bank (``torch_parity.grad_tolerance``:
rtol 2e-3 + 5e-5·max). The textured case compares under
``tests/test_raster_gbuf.py:43-63``'s pixel-fraction bounds (plane-evaluated
uv differ by ulps, so a bilinear tap can move).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import alpha_test_fields, fill_asset_cache, seeded_texture_pages
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster as jraster
from physically_based_renderer_tpu.ops import raster_pallas as jpallas
from physically_based_renderer_tpu.renderer import render_layered as jrender_layered
from physically_based_renderer_tpu_torch import flatten_scene_corners, math3d
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from physically_based_renderer_tpu_torch.renderer import render_layered
from test_layered import W, H, _two_sphere_scene
from torch_parity import grad_tolerance, to_port

ATOL = 2e-4
FIELDS = ("diffuse", "roughness", "metallic", "fresnel_r0", "opacity")


def _fully_transparent():
    scene = _two_sphere_scene(dict(diffuse=(1, 0, 0), opacity=0.0, transparent=True), dict(diffuse=(0, 1, 0)))
    draw = scene.draws[0]  # the back sphere moved far right: the centre shows the background
    return dataclasses.replace(scene, draws=(dataclasses.replace(draw, worlds=draw.worlds.at[1, 3, 0].set(50.0)),))


CASES = {
    "opaque": lambda: _two_sphere_scene(dict(diffuse=(1, 0, 0)), dict(diffuse=(0, 1, 0))),
    "transparent_50": lambda: _two_sphere_scene(dict(diffuse=(1, 0, 0), opacity=0.5, transparent=True),
                                                dict(diffuse=(0, 1, 0))),
    "fully_transparent": _fully_transparent,
    "alpha_test_0.05": lambda: _two_sphere_scene(dict(diffuse=(1, 0, 0), opacity=0.05, alpha_test=True),
                                                 dict(diffuse=(0, 1, 0))),
    "alpha_test_0.5": lambda: _two_sphere_scene(dict(diffuse=(1, 0, 0), opacity=0.5, alpha_test=True),
                                                dict(diffuse=(0, 1, 0))),
}


def _peel_ids(raster_fn, transparent, where, full):
    """The ids of ``render_layered``'s 2 + 2 peels through ``raster_fn(tri_mask,
    z_floor, cull) → (ids, depth)``, each peel behind its own chain's depths."""
    ids = []
    for mask, cull in ((~transparent, True), (transparent, False)):
        z_floor = full
        for _ in range(2):
            tid, z = raster_fn(mask, z_floor, cull)
            ids.append(np.asarray(tid))
            z_floor = where(tid >= 0, z, z_floor)
    return ids


def _check_peels(jscene, jcam, scene, cam, width, height):
    """JAX's jnp peels against JAX's kernel 5 (interpret mode), and the port's
    kernel-5 peels against JAX's kernel → whether JAX's two agree."""
    g = jflatten(jscene, textured=jscene.atlas is not None)
    clip = jmath3d.transform_points_h(g.pos_w, jcam.view_proj())
    jt = jscene.materials.transparent[g.face_material] > 0.5
    jfull = jnp.full((height, width), -jnp.inf, jnp.float32)
    kw = dict(width=width, height=height, return_depth=True)
    jnp_ids = _peel_ids(lambda m, zf, c: jraster.rasterize(clip, None, tri_mask=m, z_floor=zf, cull_backface=c, **kw),
                        jt, jnp.where, jfull)
    kern_ids = _peel_ids(lambda m, zf, c: jpallas.rasterize_binned(clip, None, tri_mask=m, z_floor=zf,
                                                                   cull_backface=c, interpret=True, **kw), jt,
                         jnp.where, jfull)
    pg = flatten_scene_corners(scene, textured=scene.atlas is not None)
    pclip = math3d.transform_points_h(pg.pos_w, cam.view_proj())
    pt = scene.materials.transparent[pg.face_material.long()] > 0.5

    def port(m, zf, c):
        out = raster_pallas.rasterize_binned(pclip, None, tri_mask=m, z_floor=zf, cull_backface=c, **kw)
        return out.tri_id, out.depth

    port_ids = _peel_ids(port, pt, torch.where, torch.full((height, width), -torch.inf))
    for k, (a, b) in enumerate(zip(kern_ids, port_ids)):
        np.testing.assert_array_equal(b, a, err_msg=f"peel {k}")
    return all(np.array_equal(a, b) for a, b in zip(jnp_ids, kern_ids)), port_ids


def _material_grads_jax(jscene, jcam):
    def loss(mats):
        s = dataclasses.replace(jscene, materials=mats)
        return jnp.mean(jrender_layered(s, jcam, width=W, height=H)[..., :3] ** 2)

    return jax.grad(loss, allow_int=True)(jscene.materials)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_layered_matches_jax(case):
    jscene = CASES[case]()
    jcam = JCamera.create(aspect=1.0)
    scene, cam = to_port(jscene, jcam)
    jax_rasters_agree, ids = _check_peels(jscene, jcam, scene, cam, W, H)
    assert jax_rasters_agree, "JAX's jnp rasterizer and its kernel 5 disagree on this frame"
    ref = np.asarray(jrender_layered(jscene, jcam, width=W, height=H))
    before = raster_row.IDS_KERNEL_LAUNCHES
    img = render_layered(scene, cam, width=W, height=H)
    assert raster_row.IDS_KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    np.testing.assert_allclose(img.numpy(), ref, atol=ATOL, rtol=0)
    assert max((i >= 0).mean() for i in ids) > 0.05  # the peels hit

    jg = _material_grads_jax(jscene, jcam)
    leaves = {k: getattr(scene.materials, k).clone().requires_grad_() for k in FIELDS}
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves))
    loss = torch.mean(render_layered(s, cam, width=W, height=H)[..., :3] ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    for k, g in zip(FIELDS, grads):
        g = torch.zeros_like(leaves[k]) if g is None else g
        assert bool(torch.isfinite(g).all()), k
        grad_tolerance(np.asarray(getattr(jg, k)), g.numpy())
    assert any(g is not None and float(g.abs().sum()) > 0 for g in grads)


def test_textured_render_layered_matches_jax():
    """``pbr_scene`` on seeded 32² pages (quad combined pages) at 64×32: the
    rusted-iron sphere alpha-tested through a seeded opacity page, the
    rock-copper sphere transparent at opacity 0.5."""
    width, height = 64, 32
    cache = fill_asset_cache(jscenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32, alpha=True))
    jscene = jscenes.pbr_scene(cache, texture_size=32, slices=16, stacks=8)
    f = alpha_test_fields(jscene.materials, cache, 0)
    transparent = np.asarray(jscene.materials.transparent).copy()
    opacity = np.asarray(jscene.materials.opacity).copy()
    transparent[1], opacity[1] = 1.0, 0.5
    mats = dataclasses.replace(jscene.materials, any_alpha_test=True, transparent=jnp.asarray(transparent),
                               opacity=jnp.asarray(opacity), **{k: jnp.asarray(v) for k, v in f.items()})
    jscene = dataclasses.replace(jscene, materials=mats).with_combined_textures(mode="quad")
    jcam = JCamera.create(position=(-1.25, 0.0, -4.0), aspect=width / height)
    scene, cam = to_port(jscene, jcam)
    ref = np.asarray(jrender_layered(jscene, jcam, width=width, height=height))
    got = render_layered(scene, cam, width=width, height=height).numpy()
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() < 1e-3 and np.median(d) < 1e-6 and d.max() < 1e-2
    # the transparent sphere blends: its pixels differ from an opaque frame's
    opaque = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, transparent=torch.zeros_like(scene.materials.transparent)))
    changed = np.abs(render_layered(opaque, cam, width=width, height=height).numpy() - got).max(-1) > 1e-3
    assert changed.sum() > 20
