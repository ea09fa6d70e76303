"""Render — the counterpart of ``physically_based_renderer_tpu/renderer.py``
for untextured scenes, through the JAX package's fused row backends
(``pallas_shade_row``; ``pallas_shade_ibl_row`` when the scene has IBL maps):

  1. ``flatten_scene_corners``: instance expansion to world space;
  2. the clip transform ``pos_w @ ViewProj``;
  3. ``setup_corners``, ``bin_triangles`` and the fused raster+shade step
     (``ops/raster_pallas.raster_shade`` over ``ops/raster_row.py``; the CUDA
     kernel on CUDA tensors); with IBL its IBL mode, whose 11 channels the
     env gather completes (``sample_spec_sky_merged``,
     ``specular_levels_lerp``);
  4. the compose over the background: the sky (``sky_map``, else
     ``env_map``) along each pixel's view ray, or the clear colour.

Gradients reach materials, lights, ambient, the eye, geometry (world
matrices, mesh vertices) and the IBL maps (the specular stack and the SH9
coefficients, and so the environment map they are built from) through
``raster_shade``'s backward, on the CPU and on the card alike.

``shade_compose_band_attrs`` and ``shade_compose_band`` are the deferred tail
for paths that resolve a band's G-buffer elsewhere (the triangle-sharded
ring, ``parallel/sharded.render_tri_sharded``): ``shade_fused`` over the
band's attributes (``csrc/shade_forward.cu`` on CUDA tensors), then the sky
and the compose.

The clip transform and the instance expansion are explicit float32 sums,
never a TF32 matmul; TF32 in screen space moves pixel coverage.
"""

from __future__ import annotations

import torch

from . import math3d
from .camera import Camera
from .models.scene import LATER_SLICE_FIELDS, CornerGeometry, Scene, flatten_scene_corners
from .ops import raster
from .ops.ibl import sample_spec_sky_merged, specular_levels_lerp
from .ops.raster_pallas import raster_shade, raster_shade_ibl, shade_fused
from .ops.sky import camera_ray_directions, sample_sky
from .ops.tonemap import tonemap


def ibl_fusable(scene: Scene) -> bool:
    """The fused IBL path's condition (the JAX renderer's ``ibl_fusable``
    for an untextured scene): IBL maps carrying the SH9 coefficients and the
    f16 specular stack, no alpha test."""
    return (
        scene.ibl is not None
        and not scene.materials.any_alpha_test
        and scene.ibl.irradiance_sh9 is not None
        and scene.ibl.specular_stack_f16 is not None
    )


def check_scene(scene: Scene, camera: Camera) -> None:
    for name, slice_name in LATER_SLICE_FIELDS.items():
        if getattr(scene, name) is not None:
            raise NotImplementedError(f"render with Scene.{name} set comes with {slice_name}")
    if scene.materials.any_alpha_test:
        raise NotImplementedError("alpha-tested materials (the depth-peel pass) come with the textured slice")
    if scene.ibl is not None and not ibl_fusable(scene):
        raise NotImplementedError(
            "IBL maps without irradiance_sh9 and specular_stack_f16 shade through ambient_ibl, "
            "which comes with the textured slice"
        )
    device = camera.device
    tensors = [scene.ambient, scene.clear_color, scene.lights.strength, scene.lights.direction,
               scene.lights.position, scene.lights.spot_power, camera.yaw, camera.pitch]
    tensors += [t for t in (scene.env_map, scene.sky_map) if t is not None]
    if scene.ibl is not None:
        tensors += [scene.ibl.irradiance_sh9, scene.ibl.specular_stack, scene.ibl.specular_stack_f16]
    tensors += [getattr(scene.materials, k) for k in scene.materials.tensor_fields()]
    for d in scene.draws:
        tensors += [d.worlds, d.material_ids, d.mesh.positions, d.mesh.normals, d.mesh.tris]
    for t in tensors:
        if t.device != device:
            raise ValueError(f"scene tensor on {t.device}, camera on {device}")


def binning_params(num_tris: int, width: int, height: int) -> dict:
    """The JAX renderer's binning parameters for the row kernel
    (renderer.py:431-446, :499-500), so the bins equal the JAX package's:
    wide spans for small scenes, caps scaled past 2× the 1080p pixel count."""
    span_wide = num_tris <= (1 << 15)
    res_scale = max(1, (width * height) // (1 << 21))
    return dict(
        max_span=(64 if span_wide else 16) * (2 if res_scale >= 2 else 1),
        pairs_cap=max(num_tris, 1 << 16) * (res_scale + 1) if res_scale > 1 else None,
        big_cap=num_tris if res_scale >= 2 else None,
        big2_span=4096 if span_wide else 0,
        big2_cap=256,
    )


def render(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int = 8,
    tile_w: int = 128,
    cull_backface: bool = True,
    apply_tonemap: bool = True,
) -> torch.Tensor:
    """Render → (rows, W, 4) float32 RGBA, display encoded when
    ``apply_tonemap``, over the sky or the clear colour.

    ``rows``/``y_offset`` select the horizontal band [y_offset, y_offset+rows)
    of the width×height viewport (default: the whole frame). Raises
    ``RuntimeError`` when binning overflowed its pair cap (triangles would be
    missing); that check waits for the frame."""
    check_scene(scene, camera)
    if rows is None:
        rows = height
    geom = flatten_scene_corners(scene, textured=False)
    vp = camera.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)  # (T, 3, 4)

    lights = scene.lights
    args = (
        clip,
        geom.attrs,
        geom.face_material,
        scene.materials.props_table(),
        lights.strength,
        lights.direction,
        lights.position,
        lights.spot_power,
        scene.ambient,
        camera.position,
    )
    kw = dict(
        width=width,
        height=height,
        rows=rows,
        y_offset=y_offset,
        tile_h=tile_h,
        tile_w=tile_w,
        cull_backface=cull_backface,
        num_materials=scene.materials.num_materials,
        num_dir=lights.num_dir,
        num_point=lights.num_point,
        num_spot=lights.num_spot,
        **binning_params(geom.num_triangles, width, height),
    )
    bg = background(scene, vp, width=width, height=height, rows=rows, y_offset=y_offset,
                    apply_tonemap=apply_tonemap)
    if scene.ibl is not None:
        out = raster_shade_ibl(*args, scene.ibl.irradiance_sh9, **kw)
        img = compose_ibl(out.rgba, out.tri_id, scene, bg, apply_tonemap)
    else:
        out = raster_shade(*args, apply_tonemap=apply_tonemap, **kw)
        img = compose(out.rgba, out.tri_id >= 0, bg)
    if bool(out.overflowed):
        raise RuntimeError(
            f"raster binning overflow: {int(out.num_pairs)} (tile, triangle) pairs "
            "hit the pair cap; triangles would be missing"
        )
    return img


def background(scene: Scene, vp: torch.Tensor, *, width: int, height: int, rows: int, y_offset: int,
               apply_tonemap: bool) -> torch.Tensor:
    """What shows behind the foreground of the band [y_offset, y_offset +
    rows): the sky (``sky_map``, else ``env_map``) along each pixel's view
    ray through the view-projection ``vp``, display encoded when
    ``apply_tonemap`` (rows, W, 3); else the clear colour (3,)."""
    sky = scene.sky_map if scene.sky_map is not None else scene.env_map
    if sky is None:
        return scene.clear_color
    sky_rgb = sample_sky(sky, camera_ray_directions(math3d.inverse(vp), width, height, rows, y_offset))
    return tonemap(sky_rgb) if apply_tonemap else sky_rgb


def compose_ibl(chan: torch.Tensor, tri_id: torch.Tensor, scene: Scene, bg: torch.Tensor,
                apply_tonemap: bool) -> torch.Tensor:
    """The env-gather epilogue of the fused IBL path (renderer.py:550-592):
    the kernel's 11 channels ``chan`` (rows, W, 11) completed with the
    prefiltered specular along their reflect directions, over ``bg``
    (:func:`background`)."""
    hit = tri_id >= 0
    ibl = scene.ibl
    smp_all = sample_spec_sky_merged(ibl, chan[..., 6:9], hit)
    # Background taps are not meaningful (and, with the JAX package's merged
    # gather, may be NaN): mask before any arithmetic.
    smp_all = torch.where(hit[..., None], smp_all, 0.0)
    prefiltered = specular_levels_lerp(smp_all, chan[..., 9], ibl.num_specular_levels)
    hdr = chan[..., 0:3] + chan[..., 3:6] * prefiltered
    fg = tonemap(hdr) if apply_tonemap else hdr
    return compose(torch.cat([fg, chan[..., 10:11]], dim=-1), hit, bg)


def compose(rgba_fg: torch.Tensor, hit: torch.Tensor, background: torch.Tensor) -> torch.Tensor:
    """Foreground over the background (renderer.py:644-659) — the clear
    colour (3,) or the sky (rows, W, 3): rgb blends by the hit mask, alpha
    is the material opacity on hits and 1 elsewhere."""
    m = hit[..., None].to(torch.float32)
    rgb = m * rgba_fg[..., :3] + (1.0 - m) * background
    alpha = m[..., 0] * rgba_fg[..., 3] + (1.0 - m[..., 0]) * 1.0
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def shade_compose_band(
    scene: Scene,
    camera: Camera,
    geom: CornerGeometry,
    clip: torch.Tensor,  # (T, 3, 4) corner-major clip coords of ``geom``
    tri_id: torch.Tensor,  # (rows, W) resolved triangle ids, −1 at background
    *,
    width: int,
    height: int,
    y_offset: int = 0,
    apply_tonemap: bool = True,
) -> torch.Tensor:
    """Shade + sky + compose a band given its resolved triangle ids
    (renderer.py:899-929): interpolate the G-buffer for ``tri_id``, then
    :func:`shade_compose_band_attrs`. Differentiable through the
    interpolation and the shader."""
    attrs, _, mask = raster.interpolate_corners(geom.attrs, clip, tri_id, width=width, height=height,
                                                y_offset=y_offset)
    pix_mat = geom.face_material[tri_id.clamp(min=0).long()]
    return shade_compose_band_attrs(scene, camera, attrs, mask, pix_mat, width=width, height=height,
                                    y_offset=y_offset, apply_tonemap=apply_tonemap)


def shade_compose_band_attrs(
    scene: Scene,
    camera: Camera,
    attrs: torch.Tensor,  # (rows, W, C) interpolated G-buffer attributes, [pos_w, normal_w, …]
    mask: torch.Tensor,  # (rows, W) bool foreground coverage
    pix_mat: torch.Tensor,  # (rows, W) int material ids
    *,
    width: int,
    height: int,
    y_offset: int = 0,
    apply_tonemap: bool = True,
) -> torch.Tensor:
    """Shade + sky + compose a band from pre-interpolated attributes
    (renderer.py:932-1005) → (rows, W, 4). Untextured scenes without IBL or
    alpha test shade through ``shade_fused`` on both devices (the JAX
    package takes it off the CPU only); the sky (``sky_map``, else
    ``env_map``) or the clear colour goes behind."""
    if any(getattr(scene, name) is not None for name in LATER_SLICE_FIELDS) or scene.ibl is not None \
            or scene.materials.any_alpha_test:
        raise NotImplementedError(
            "shading a G-buffer band of a textured, IBL or alpha-tested scene (shade_pixels) comes with "
            "the textured slice"
        )
    rows = mask.shape[0]
    lights = scene.lights
    rgba_fg = shade_fused(
        attrs[..., :6], pix_mat, mask, scene.materials.props_table(), lights.strength, lights.direction,
        lights.position, lights.spot_power, scene.ambient, camera.position, num_dir=lights.num_dir,
        num_point=lights.num_point, num_spot=lights.num_spot, apply_tonemap=apply_tonemap,
    )
    bg = background(scene, camera.view_proj(), width=width, height=height, rows=rows, y_offset=y_offset,
                    apply_tonemap=apply_tonemap)
    return compose(rgba_fg, mask, bg)
