"""Forward render — the counterpart of ``physically_based_renderer_tpu/renderer.py``
for the untextured, non-IBL scene (the JAX package's ``pallas_shade_row``
backend):

  1. ``flatten_scene_corners``: instance expansion to world space;
  2. the clip transform ``pos_w @ ViewProj``;
  3. ``setup_corners``, ``bin_triangles`` and the fused raster+shade step
     (``ops/raster_row.py``; the CUDA kernel on CUDA tensors);
  4. the clear-colour compose.

The clip transform and the instance expansion are explicit float32 sums,
never a TF32 matmul; TF32 in screen space moves pixel coverage.
"""

from __future__ import annotations

import torch

from . import math3d
from .camera import Camera
from .models.scene import LATER_SLICE_FIELDS, Scene, flatten_scene_corners
from .ops.raster_row import rasterize_binned_shade_row


def _check_scene(scene: Scene, camera: Camera) -> None:
    for name, slice_name in LATER_SLICE_FIELDS.items():
        if getattr(scene, name) is not None:
            raise NotImplementedError(f"render with Scene.{name} set comes with {slice_name}")
    if scene.materials.any_alpha_test:
        raise NotImplementedError("alpha-tested materials (the depth-peel pass) come with the textured slice")
    device = camera.device
    tensors = [scene.ambient, scene.clear_color, scene.lights.strength, scene.lights.direction,
               scene.lights.position, scene.lights.spot_power, camera.yaw, camera.pitch]
    tensors += [getattr(scene.materials, k) for k in scene.materials.tensor_fields()]
    for d in scene.draws:
        tensors += [d.worlds, d.material_ids, d.mesh.positions, d.mesh.normals, d.mesh.tris]
    for t in tensors:
        if t.device != device:
            raise ValueError(f"scene tensor on {t.device}, camera on {device}")
    if device.type == "cuda" and any(t.requires_grad for t in tensors + [camera.position]):
        raise NotImplementedError(
            "gradients through the CUDA render path come with the backward slice"
        )


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
    """Render → (rows, W, 4) float32 display-encoded RGBA over the clear colour.

    ``rows``/``y_offset`` select the horizontal band [y_offset, y_offset+rows)
    of the width×height viewport (default: the whole frame). Raises
    ``RuntimeError`` when binning overflowed its pair cap (triangles would be
    missing); that check waits for the frame."""
    _check_scene(scene, camera)
    if rows is None:
        rows = height
    geom = flatten_scene_corners(scene, textured=False)
    clip = math3d.transform_points_h(geom.pos_w, camera.view_proj())  # (T, 3, 4)

    lights = scene.lights
    out = rasterize_binned_shade_row(
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
        apply_tonemap=apply_tonemap,
        **binning_params(geom.num_triangles, width, height),
    )
    img = compose(out.rgba, out.tri_id, scene.clear_color)
    if bool(out.overflowed):
        raise RuntimeError(
            f"raster binning overflow: {int(out.num_pairs)} (tile, triangle) pairs "
            "hit the pair cap; triangles would be missing"
        )
    return img


def compose(rgba_fg: torch.Tensor, tri_id: torch.Tensor, clear_color: torch.Tensor) -> torch.Tensor:
    """Foreground over the clear colour (renderer.py:644-659): rgb blends by
    the hit mask, alpha is the material opacity on hits and 1 elsewhere."""
    m = (tri_id >= 0)[..., None].to(torch.float32)
    rgb = m * rgba_fg[..., :3] + (1.0 - m) * clear_color
    alpha = m[..., 0] * rgba_fg[..., 3] + (1.0 - m[..., 0]) * 1.0
    return torch.cat([rgb, alpha[..., None]], dim=-1)
