"""PyTorch port vs the JAX package: the textured deferred path of ``render``
— kernel 4 (raster + 15-channel G-buffer in the v1 binning), the combined
pages, ``shade_pixels``, the alpha-test peel and the textured IBL tail.

Scenes: ``pbr_scene`` and ``rustediron_sphere_scene`` at small sizes
(spheres 16×8, 32² pages seeded by ``chip_smoke.seeded_texture_pages``, the
same pages through both packages' ``AssetCache``), 128×64 frames. The JAX
side runs ``render(raster_backend="pallas_gbuf_interpret")`` (kernel 4 in
interpret mode, then its XLA shader). Tolerances:

* kernel 4's plain version (``raster_gbuffer_tiles_plain`` in the v1
  binning, what CPU tensors run) against JAX ``rasterize_binned_gbuffer
  (interpret=True)``: ids equal but at exact quantized-depth ties (the TPU
  kernel also evaluates up to 127 pairs before each run; each differing
  pixel is checked to be such a tie), attributes within 2e-4 and depth
  within 2e-6 (``tests/test_torch_gbuffer_row.py``'s bounds);
* frames: ``tests/test_raster_gbuf.py:43-63``'s bounds — plane-evaluated uv
  differ by ulps, so a bilinear tap (with ``mip_lod``, a whole mip level) can
  move: under 0.1% of the values off by more than 1e-5 (0.5% with
  ``mip_lod``), a median under 1e-6, and a maximum (0.999-quantile with
  ``mip_lod``) under 1e-2;
* gradients to the material bank and the quad pages: the JAX suite's
  gradient tolerance (``torch_parity.grad_tolerance``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import alpha_test_fields, fill_asset_cache, seeded_env, seeded_texture_pages
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster_pallas as jpallas
from physically_based_renderer_tpu.renderer import render as jrender
import physically_based_renderer_tpu_torch as pbr
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops.raster import setup_corners
from physically_based_renderer_tpu_torch.ops.raster_bin import RASTER_FIELDS, pack_triangle_fields
from physically_based_renderer_tpu_torch.ops.texture_combined import QuadCombinedAtlas
from physically_based_renderer_tpu_torch.renderer import default_mip_lod
from torch_parity import grad_tolerance, to_port

W, H = 128, 64
TEX = 32
ATTR_ATOL, DEPTH_ATOL = 2e-4, 2e-6
GRID_CAMERA = (0.0, -3.0, -18.0)


def _cache(alpha=False):
    return fill_asset_cache(jscenes.AssetCache(texture_size=TEX), seeded_texture_pages(5, TEX, alpha=alpha))


def _pbr(mode="quad", alpha=False):
    cache = _cache(alpha)
    scene = jscenes.pbr_scene(cache, texture_size=TEX, slices=16, stacks=8)
    if alpha:
        f = alpha_test_fields(scene.materials, cache, 0)
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, any_alpha_test=True, **{k: jnp.asarray(v) for k, v in f.items()}))
    return scene.with_combined_textures(mode=mode)


def _jrender(scene, cam, **kw):
    return np.asarray(jrender(scene, cam, width=W, height=H, raster_backend="pallas_gbuf_interpret", **kw))


def _assert_frame_close(got, ref, mip_lod):
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() < (5e-3 if mip_lod else 1e-3), f"{(d > 1e-5).mean():.5%} values off"
    assert np.median(d) < 1e-6
    assert (np.quantile(d, 0.999) if mip_lod else d.max()) < 1e-2


# -- kernel 4 ----------------------------------------------------------------


def _kernel4_case(case):
    """(clip, attrs, face_material, kwargs) of a kernel-4 parity case."""
    cache = _cache()
    if case == "pbr_frame":
        scene = jscenes.pbr_scene(cache, texture_size=TEX, slices=16, stacks=8)
        cam, kw = JCamera.create(position=GRID_CAMERA, aspect=W / H), dict(width=W, height=H, max_span=8)
    else:  # the rustediron sphere close up: wide triangles; max span 2 sends them to the jumbo run
        scene = jscenes.rustediron_sphere_scene(cache, texture_size=TEX)
        scene = dataclasses.replace(scene, draws=(dataclasses.replace(scene.draws[0],
                                                                      mesh=jscenes.sphere_mesh(1.0, 16, 8)),))
        cam, kw = JCamera.create(position=(0.0, 0.0, -2.5), aspect=2 * W / H), dict(width=2 * W, height=H,
                                                                                     max_span=2)
    g = jflatten(scene, textured=True)
    clip = jmath3d.transform_points_h(g.pos_w, cam.view_proj())
    return clip, g.attrs, g.face_material, dict(num_materials=scene.materials.num_materials, **kw)


def _tie_ok(clip, attrs, fm, kw, pixels, tri_a, tri_b):
    """Whether triangles ``tri_a`` and ``tri_b`` have the same quantized
    depth at each pixel centre (the only place the two kernels may pick
    differently)."""
    st = setup_corners(torch.as_tensor(np.array(clip)), kw["width"], kw["height"], kw.get("cull_backface", True),
                       None)
    fields = pack_triangle_fields(st)
    ys, xs = pixels
    px, py = torch.as_tensor(xs, dtype=torch.float32) + 0.5, torch.as_tensor(ys, dtype=torch.float32) + 0.5

    def zq(tri):
        f = fields[torch.as_tensor(tri).long(), :RASTER_FIELDS]
        z = (px - f[:, 9]) * f[:, 11] + (py - f[:, 10]) * f[:, 12] + f[:, 13]
        return z.contiguous().view(torch.int32) & raster_row.QMASK

    return bool(torch.equal(zq(tri_a), zq(tri_b)))


def _kernel4_both(clip, attrs, fm, kw, floors=(None, None)):
    ref = jpallas.rasterize_binned_gbuffer(clip, None, attrs, face_material=fm, interpret=True,
                                           z_floor=None if floors[0] is None else jnp.asarray(floors[0]), **kw)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    out = raster_pallas.rasterize_binned_gbuffer(t(clip), t(attrs), t(fm), z_floor=floors[1], **kw)
    assert not bool(out.overflowed)
    ref = [np.asarray(r) for r in ref]
    diff = out.tri_id.numpy() != ref[2]
    if diff.any():  # exact quantized ties only, and only between two hits
        assert (out.tri_id.numpy()[diff] >= 0).all() and (ref[2][diff] >= 0).all()
        assert _tie_ok(clip, attrs, fm, kw, np.nonzero(diff), out.tri_id.numpy()[diff], ref[2][diff])
    same = ~diff
    np.testing.assert_array_equal(out.mat_id.numpy()[same], ref[3][same])
    np.testing.assert_allclose(out.attrs.numpy()[same], ref[0][same], atol=ATTR_ATOL, rtol=0)
    np.testing.assert_allclose(out.depth.numpy()[same], ref[1][same], atol=DEPTH_ATOL, rtol=0)
    return ref, out, int(diff.sum())


@pytest.mark.parametrize("case", ["pbr_frame", "jumbo"])
def test_kernel4_plain_version_matches_jax(case):
    clip, attrs, fm, kw = _kernel4_case(case)
    binned = raster_row.bin_for_shade(torch.as_tensor(np.array(clip)), torch.as_tensor(np.array(attrs)),
                                      torch.as_tensor(np.array(fm)), rows=kw["height"], y_offset=0, tile_h=16,
                                      tile_w=128, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None,
                                      cull_backface=True, width=kw["width"], height=kw["height"],
                                      max_span=kw["max_span"])
    assert (int(binned.starts[0]) > 0) == (case == "jumbo")  # the jumbo run, and only where forced
    ref, out, ties = _kernel4_both(clip, attrs, fm, kw)
    assert out.attrs.shape[-1] == 14 and 0.05 < (ref[2] >= 0).mean() < 0.95 and ties <= 4


def test_kernel4_z_floor_peel_matches_jax():
    """Two layers without back-face culling: the peel behind each side's own
    first-layer depths finds the back faces."""
    clip, attrs, fm, kw = _kernel4_case("jumbo")
    kw = dict(kw, cull_backface=False)
    ref1, out1, _ = _kernel4_both(clip, attrs, fm, kw)
    floors = (np.where(ref1[2] >= 0, ref1[1], -np.inf).astype(np.float32),
              torch.where(out1.tri_id >= 0, out1.depth, -torch.inf))
    ref2, out2, _ = _kernel4_both(clip, attrs, fm, kw, floors)
    hit1, hit2 = ref1[2] >= 0, ref2[2] >= 0
    assert hit2[hit1].mean() > 0.9 and (ref2[1][hit2] > ref1[1][hit2]).all()


def test_raster_gbuffer_routes_by_layout():
    """``raster_gbuffer``'s defaults are kernel 4's v1 binning; ``row_layout``
    gives kernel 2's. On CPU tensors neither launches a kernel."""
    clip, attrs, fm, kw = _kernel4_case("pbr_frame")
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    launches = raster_row.GBUF_KERNEL_LAUNCHES, raster_row.GBUF_V1_KERNEL_LAUNCHES
    a = raster_pallas.raster_gbuffer(t(clip), t(attrs), t(fm), **kw)
    b = raster_pallas.rasterize_binned_gbuffer(t(clip), t(attrs), t(fm), **kw)
    c = raster_pallas.raster_gbuffer(t(clip), t(attrs), t(fm), row_layout=True, **dict(kw, max_span=16),
                                     tile_h=8)
    d = raster_row.rasterize_binned_gbuffer_row(t(clip), t(attrs), t(fm), **dict(kw, max_span=16), tile_h=8)
    assert torch.equal(a.attrs, b.attrs) and torch.equal(a.tri_id, b.tri_id)
    assert torch.equal(c.attrs, d.attrs) and torch.equal(c.tri_id, d.tri_id)
    assert (raster_row.GBUF_KERNEL_LAUNCHES, raster_row.GBUF_V1_KERNEL_LAUNCHES) == launches


# -- frames ------------------------------------------------------------------


@pytest.fixture(scope="module")
def pbr_quad():
    jscene = _pbr("quad")
    jcam = JCamera.create(position=GRID_CAMERA, aspect=W / H)
    return jscene, jcam, *to_port(jscene, jcam)


@pytest.mark.parametrize("mip_lod", [False, True])
def test_textured_frame_matches_jax(pbr_quad, mip_lod):
    jscene, jcam, scene, cam = pbr_quad
    got = pbr.render(scene, cam, width=W, height=H, mip_lod=mip_lod).numpy()
    _assert_frame_close(got, _jrender(jscene, jcam, mip_lod=mip_lod), mip_lod)
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    if mip_lod:  # the pyramid is read: the frame differs from the 1-mip one
        assert np.abs(got - pbr.render(scene, cam, width=W, height=H, mip_lod=False).numpy()).max() > 1e-3


def test_default_mip_lod_follows_the_jax_rule(pbr_quad):
    """``mip_lod=None``: the JAX package's rule — on at most 2²⁰ sampled
    texels (the small test scene), off for the bench's 9 quad pages at 512²."""
    _, _, scene, cam = pbr_quad
    assert default_mip_lod(scene) is True
    assert torch.equal(pbr.render(scene, cam, width=W, height=H), pbr.render(scene, cam, width=W, height=H,
                                                                            mip_lod=True))
    big = torch.empty((9, 512, 512, 16), device="meta")
    quad = QuadCombinedAtlas(taps=big, pages=big, material_page=torch.zeros(58, dtype=torch.int64))
    assert default_mip_lod(dataclasses.replace(scene, combined_atlas=quad)) is False
    assert default_mip_lod(dataclasses.replace(scene, atlas=None, combined_atlas=None)) is False


def test_alpha_tested_frame_matches_jax():
    """One textured sphere alpha-tested through a seeded opacity page: killed
    fragments show what one depth peel finds behind them."""
    jscene = _pbr("quad", alpha=True)
    jcam = JCamera.create(position=(0.0, 0.0, -4.0), aspect=W / H)
    scene, cam = to_port(jscene, jcam)
    got = pbr.render(scene, cam, width=W, height=H).numpy()
    _assert_frame_close(got, _jrender(jscene, jcam), mip_lod=True)
    opaque = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, any_alpha_test=False, alpha_test=torch.zeros_like(scene.materials.alpha_test)))
    changed = np.abs(pbr.render(opaque, cam, width=W, height=H).numpy() - got).max(-1) > 1e-3
    assert changed.sum() > 50  # the peel changed pixels


def test_textured_ibl_frame_matches_jax():
    """rustediron under a seeded HDR env, IBL maps with SH9 and the f16
    stack: the merged-IBL tail completes the shader's split output."""
    jscene = jscenes.rustediron_sphere_scene(_cache(), texture_size=TEX)
    jscene = dataclasses.replace(jscene, env_map=jnp.asarray(seeded_env(9, 16, 32))).with_ibl()
    jscene = jscene.with_combined_textures(mode="quad")
    jcam = JCamera.create(position=(0.0, 0.0, -2.5), aspect=W / H)
    scene, cam = to_port(jscene, jcam)
    got = pbr.render(scene, cam, width=W, height=H).numpy()
    ref = _jrender(jscene, jcam)
    d = np.abs(got - ref)
    # the IBL tail reads f16 taps of the specular stack: HDR ulps, looser
    assert (d > 1e-4).mean() < 1e-3 and np.median(d) < 1e-6 and d.max() < 1e-2
    assert (ref[..., 3] < 1).mean() == 0 and (got[..., :3] != got[0, 0, :3]).any(-1).mean() > 0.3


def test_material_and_texel_gradients_match_jax(pbr_quad):
    """The bench loss mean(img[..., :3]²): gradients to every float field of
    the material bank and to the quad pages (mip_lod off: the pages
    themselves are sampled)."""
    jscene, jcam, scene, cam = pbr_quad
    fields = ("diffuse", "metallic", "fresnel_r0", "roughness", "opacity", "has_tex", "uv_transform",
              "height_scale")

    def jloss(mats, pages):
        s = dataclasses.replace(jscene, materials=mats,
                                combined_atlas=dataclasses.replace(jscene.combined_atlas, pages=pages))
        img = jrender(s, jcam, width=W, height=H, raster_backend="pallas_gbuf_interpret", mip_lod=False)
        return jnp.mean(img[..., :3] ** 2)

    jm, jp = jax.grad(jloss, argnums=(0, 1), allow_int=True)(jscene.materials, jscene.combined_atlas.pages)
    leaves = {k: getattr(scene.materials, k).clone().requires_grad_() for k in fields}
    pages = scene.combined_atlas.pages.clone().requires_grad_()
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves),
                            combined_atlas=dataclasses.replace(scene.combined_atlas, pages=pages))
    loss = torch.mean(pbr.render(s, cam, width=W, height=H, mip_lod=False)[..., :3] ** 2)
    grads = torch.autograd.grad(loss, [*leaves.values(), pages], allow_unused=True)
    for k, g in zip(fields, grads):
        grad_tolerance(np.asarray(getattr(jm, k)), torch.zeros_like(leaves[k]).numpy() if g is None else g.numpy())
    grad_tolerance(np.asarray(jp), grads[-1].numpy())
    assert float(grads[-1].abs().sum()) > 0 and float(grads[0].abs().sum()) > 0


def test_band_matches_full_frame(pbr_quad):
    """A band of the textured frame: without mip_lod every row equals the
    full frame's; with it, all but the band's last row (whose screen-space
    derivative replicates its neighbour's, the JAX package's edge rule)."""
    _, _, scene, cam = pbr_quad
    for mip_lod in (False, True):
        full = pbr.render(scene, cam, width=W, height=H, mip_lod=mip_lod)
        band = pbr.render(scene, cam, width=W, height=H, rows=24, y_offset=20, mip_lod=mip_lod)
        last = 23 if mip_lod else 24
        torch.testing.assert_close(band[:last], full[20 : 20 + last], atol=1e-6, rtol=0)
