"""Render — the counterpart of ``physically_based_renderer_tpu/renderer.py``.
``render`` picks its path by the scene, as the JAX package's ``"auto"``
backend does (renderer.py:456-478):

  * untextured, no IBL, no alpha test: the fused row kernel
    (``pallas_shade_row``: ``ops/raster_pallas.raster_shade`` over
    ``ops/raster_row.py``, ``csrc/raster_shade_row.cu`` on CUDA tensors);
  * untextured with IBL maps that carry the SH9 coefficients and the f16
    specular stack, no alpha test: its IBL mode (``pallas_shade_ibl_row``),
    whose 11 channels the env gather completes (``compose_ibl``);
  * everything else — textured scenes, alpha-tested materials, other IBL
    maps: the G-buffer path (``pallas_gbuf``). Kernel 4
    (``raster_gbuffer`` in the v1 binning: 16×128 tiles, the G-buffer mode
    of ``csrc/raster_shade_row.cu`` on CUDA tensors) writes the attributes;
    :func:`shade_pixels`, the PS stage, shades them in PyTorch (material
    table fetch, uv transform, parallax, screen-space mip LOD and aniso
    taps, the combined or per-slot atlas, normal mapping, IBL); one depth
    peel re-rasterizes behind pixels an alpha-tested material kills; with
    SH9 + f16 maps and no alpha test the IBL ambient's specular half rides
    the env gather after shading (``ibl_split``, the merged-IBL tail).

Every path composes over the sky (``sky_map``, else ``env_map``) along each
pixel's view ray, or the clear colour. Gradients reach materials, textures
(the atlas, or the combined pages), lights, ambient, the eye, geometry and
the IBL maps, on the CPU and on the card alike.

``shade_compose_band_attrs`` and ``shade_compose_band`` are the deferred tail
for paths that resolve a band's G-buffer elsewhere (the triangle-sharded
ring, ``parallel/sharded.render_tri_sharded``): ``shade_fused`` over the
band's attributes for untextured scenes without IBL or alpha test
(``csrc/shade_forward.cu`` on CUDA tensors), :func:`shade_pixels`
otherwise, then the sky and the compose.

The clip transform and the instance expansion are explicit float32 sums,
never a TF32 matmul; TF32 in screen space moves pixel coverage.
"""

from __future__ import annotations

import dataclasses

import torch

from . import math3d
from .camera import Camera
from .models.material import SLOT_DIFFUSE, SLOT_DISPLACEMENT, SLOT_METALLIC, SLOT_NORMAL, SLOT_OPACITY
from .models.material import SLOT_ROUGHNESS, SLOT_SPECULAR, MaterialBank
from .models.scene import CornerGeometry, Scene, flatten_scene_corners
from .ops import raster
from .ops.brdf import Lights, MaterialSample, compute_lighting, normal_sample_to_world_space
from .ops.fetch import fetch_columns
from .ops.ibl import (
    IBLMaps,
    ambient_ibl,
    env_brdf_approx,
    sample_spec_sky_merged,
    sh9_irradiance,
    specular_levels_lerp,
)
from .ops.raster_pallas import raster_gbuffer, raster_shade, raster_shade_ibl, shade_fused
from .ops.sky import camera_ray_directions, sample_sky
from .ops.texture import TextureAtlas, sample_atlas, screen_space_lod, screen_space_lod_aniso
from .ops.texture_combined import sample_any
from .ops.tonemap import tonemap


def ibl_fusable(scene: Scene) -> bool:
    """The fused IBL path's condition (the JAX renderer's ``ibl_fusable``):
    an untextured scene, IBL maps carrying the SH9 coefficients and the f16
    specular stack, no alpha test."""
    return (
        scene.atlas is None
        and scene.ibl is not None
        and not scene.materials.any_alpha_test
        and scene.ibl.irradiance_sh9 is not None
        and scene.ibl.specular_stack_f16 is not None
    )


def _tensors(x):
    """The tensors of a scene field (a tensor, a dataclass of tensors and
    tuples of them, or None)."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x) for t in _tensors(getattr(x, f.name))]
    return []


def check_scene(scene: Scene, camera: Camera) -> None:
    """Every tensor of the scene on the camera's device."""
    device = camera.device
    tensors = [scene.ambient, scene.clear_color, scene.lights.strength, scene.lights.direction,
               scene.lights.position, scene.lights.spot_power, camera.yaw, camera.pitch]
    for field in (scene.env_map, scene.sky_map, scene.ibl, scene.atlas, scene.combined_atlas):
        tensors += _tensors(field)
    tensors += [getattr(scene.materials, k) for k in scene.materials.tensor_fields()]
    for d in scene.draws:
        tensors += [d.worlds, d.material_ids, d.mesh.positions, d.mesh.normals, d.mesh.tris]
    for t in tensors:
        if t.device != device:
            raise ValueError(f"scene tensor on {t.device}, camera on {device}")


def binning_params(num_tris: int, width: int, height: int, *, row_layout: bool = True) -> dict:
    """The JAX renderer's binning parameters (renderer.py:431-446,
    :499-500, :710), so the bins equal the JAX package's: for the row
    kernels (``row_layout``) wide spans for small scenes and a big2 class;
    for kernel 4 max span 64, or 8 past 2¹⁵ triangles, and no big2 class;
    spans doubled and caps scaled past 2× the 1080p pixel count."""
    span_wide = num_tris <= (1 << 15)
    res_scale = max(1, (width * height) // (1 << 21))
    ms_scale = 2 if res_scale >= 2 else 1
    return dict(
        max_span=(64 if span_wide else (16 if row_layout else 8)) * ms_scale,
        pairs_cap=max(num_tris, 1 << 16) * (res_scale + 1) if res_scale > 1 else None,
        big_cap=num_tris if res_scale >= 2 else None,
        big2_span=4096 if (span_wide and row_layout) else 0,
        big2_cap=256,
    )


def default_mip_lod(scene: Scene) -> bool:
    """The JAX package's ``mip_lod=None`` rule (renderer.py:398-413):
    trilinear mip filtering for textured scenes whose sampled pages (the
    combined pages, else the atlas) hold at most 2²⁰ texels. The rule is a
    TPU gather-cost law; the port keeps it so one call gives the same image
    in both packages."""
    src = scene.combined_atlas if scene.combined_atlas is not None else scene.atlas
    texels = 0 if src is None else src.num_pages * src.size * src.size
    return scene.atlas is not None and texels <= (1 << 20)


def shade_pixels(
    *,
    pos_w: torch.Tensor,  # (..., 3)
    normal_w: torch.Tensor,  # (..., 3)
    tangent_w: torch.Tensor,  # (..., 3)
    bitangent_w: torch.Tensor,  # (..., 3)
    uv: torch.Tensor,  # (..., 2)
    material_id: torch.Tensor,  # (...,) int
    materials: MaterialBank,
    atlas: TextureAtlas | None,
    lights: Lights,
    ambient: torch.Tensor,  # (3,)
    eye: torch.Tensor,  # (3,)
    ibl: IBLMaps | None = None,
    combined=None,
    mip_lod: bool = False,
    ibl_split: bool = False,
    aniso_taps: int = 1,
) -> tuple:
    """The PS stage (``Default.hlsl:47-161``) over any pixel batch dims →
    (hdr (..., 3), opacity (...,), keep (...,) bool or None).

    ``keep`` is the parallax uv clip (``Default.hlsl:65-68``): False where a
    displacement-mapped material's offset uv left [0, 1]; None when no
    material binds a displacement map. ``mip_lod`` with a (rows, W) layout
    and a pyramid: trilinear at the screen-space LOD (``aniso_taps`` > 1:
    that many taps along the footprint's major axis). ``ibl_split=True``
    (needs ``ibl.irradiance_sh9``) returns three more — spec_f (..., 3),
    rdir (..., 3), roughness (...,) — and ``hdr`` holds direct + SH9
    diffuse: the caller completes hdr + spec_f·prefiltered(rdir, roughness)
    with the env gather (the merged-IBL tail)."""
    mid = material_id
    textured = combined is not None or atlas is not None
    keep = None
    n_geom = math3d.normalize(normal_w)  # Default.hlsl:50; the tangent frame stays raw
    v = math3d.normalize(eye - pos_w)
    props = fetch_columns(materials.props_table(textured), mid)
    c_diffuse, c_metallic, c_f0 = props[..., 0:3], props[..., 3], props[..., 4:7]
    c_roughness, c_opacity = props[..., 7], props[..., 8]

    if textured:
        has = props[..., 16:28]
        a = props[..., 10:16].reshape(*uv.shape[:-1], 3, 2)
        uv_t = uv[..., 0:1] * a[..., 0, :] + uv[..., 1:2] * a[..., 1, :] + a[..., 2, :]  # Default.hlsl:42
        if atlas is not None and materials.any_displacement:
            # Parallax offset mapping (Default.hlsl:55-69, completed) and its uv clip.
            h_disp = has[..., SLOT_DISPLACEMENT]
            t_height = sample_atlas(atlas, materials.tex_index[mid.long()][..., SLOT_DISPLACEMENT], uv_t)[..., 0]
            v_tan = torch.stack([math3d.dot(v, math3d.normalize(tangent_w)),
                                 math3d.dot(v, math3d.normalize(bitangent_w))], dim=-1)
            uv_t = uv_t - h_disp[..., None] * (v_tan * (t_height * props[..., 9])[..., None])
            oob = (uv_t[..., 0] < 0.0) | (uv_t[..., 1] < 0.0) | (uv_t[..., 0] > 1.0) | (uv_t[..., 1] > 1.0)
            keep = ~((h_disp > 0.5) & oob)

        lod = aniso_axis = None
        if mip_lod and uv_t.ndim >= 3:
            src_sz = None
            if combined is not None:
                if combined.num_levels > 1:
                    src_sz = combined.size
            elif atlas.num_levels > 1:
                src_sz = atlas.size
            if src_sz is not None:
                if aniso_taps > 1:
                    lod, aniso_axis = screen_space_lod_aniso(uv_t, src_sz, aniso_taps)
                else:
                    lod = screen_space_lod(uv_t, src_sz)

        def multi_tap(sample_fn):
            """The mean of ``aniso_taps`` samples along the major footprint
            axis (one plain sample when aniso is off)."""
            if aniso_axis is None:
                return sample_fn(uv_t)
            acc = None
            for k in range(aniso_taps):
                s_ = sample_fn(uv_t + aniso_axis * ((k + 0.5) / aniso_taps - 0.5))
                acc = s_ if acc is None else acc + s_
            return acc / aniso_taps

        if combined is not None:
            smp = multi_tap(lambda u: sample_any(combined, mid, u, lod=lod))
            t_diffuse, t_specular, t_metallic = smp[..., 0:3], smp[..., 3:6], smp[..., 6:7]
            t_roughness, t_normal, t_opacity = smp[..., 7:8], smp[..., 8:11], smp[..., 11:12]
        else:
            pages = materials.tex_index[mid.long()]

            def tex(slot):
                return multi_tap(lambda u: sample_atlas(atlas, pages[..., slot], u, lod=lod))

            t_diffuse, t_specular, t_metallic = tex(SLOT_DIFFUSE), tex(SLOT_SPECULAR), tex(SLOT_METALLIC)
            t_roughness, t_normal, t_opacity = tex(SLOT_ROUGHNESS), tex(SLOT_NORMAL), tex(SLOT_OPACITY)

        h = lambda s: has[..., s : s + 1]  # noqa: E731
        albedo = h(SLOT_DIFFUSE) * t_diffuse[..., :3] + (1.0 - h(SLOT_DIFFUSE)) * c_diffuse
        metallic = has[..., SLOT_METALLIC] * t_metallic[..., 0] + (1.0 - has[..., SLOT_METALLIC]) * c_metallic
        # No specular map: F0 = lerp(const F0, albedo, metallic) (Default.hlsl:94-96).
        f0_const = math3d.lerp(c_f0, albedo, metallic[..., None])
        f0 = h(SLOT_SPECULAR) * t_specular[..., :3] + (1.0 - h(SLOT_SPECULAR)) * f0_const
        roughness = has[..., SLOT_ROUGHNESS] * t_roughness[..., 0] + (1.0 - has[..., SLOT_ROUGHNESS]) * c_roughness
        n_mapped = normal_sample_to_world_space(t_normal[..., :3], n_geom, tangent_w, bitangent_w)
        n = h(SLOT_NORMAL) * n_mapped + (1.0 - h(SLOT_NORMAL)) * n_geom  # not renormalised
        opacity = has[..., SLOT_OPACITY] * t_opacity[..., 0] + (1.0 - has[..., SLOT_OPACITY]) * c_opacity
    else:
        albedo, metallic, roughness, n, opacity = c_diffuse, c_metallic, c_roughness, n_geom, c_opacity
        f0 = math3d.lerp(c_f0, albedo, metallic[..., None])

    mat = MaterialSample(diffuse_albedo=albedo, metallic=metallic, fresnel_r0=f0, roughness=roughness)
    direct = compute_lighting(lights, mat, pos_w, n, v)
    if ibl is not None and ibl_split:
        if ibl.irradiance_sh9 is None:
            raise ValueError("ibl_split needs the SH9 irradiance")
        n_unit = math3d.normalize(n)
        ndotv = math3d.maximum(math3d.dot(n_unit, v), 0.0)
        ks = f0 + (1.0 - f0) * torch.pow(1.0 - ndotv, 5.0)[..., None]
        kd = (1.0 - ks) * (1.0 - metallic)[..., None]
        ab = env_brdf_approx(ndotv, roughness)
        spec_f = f0 * ab[..., 0:1] + ab[..., 1:2]
        rdir = math3d.normalize(2.0 * ndotv[..., None] * n_unit - v)
        lit = direct + kd * sh9_irradiance(ibl.irradiance_sh9, n_unit) * albedo
        return lit, opacity, keep, spec_f, rdir, roughness
    if ibl is not None:
        amb = ambient_ibl(ibl, math3d.normalize(n), v, albedo, f0, metallic, roughness)
    else:
        amb = ambient * albedo  # g_AmbientLight·albedo (Default.hlsl:150)
    return amb + direct, opacity, keep


def _split_attrs(attrs: torch.Tensor, textured: bool):
    """(pos, normal, tangent, bitangent, uv) of a G-buffer's attributes; an
    untextured one has no tangent frame or uv (the shader reads none)."""
    pos_w, normal_w = attrs[..., 0:3], attrs[..., 3:6]
    if textured:
        return pos_w, normal_w, attrs[..., 6:9], attrs[..., 9:12], attrs[..., 12:14]
    return pos_w, normal_w, normal_w, normal_w, attrs[..., 0:2] * 0.0


def _raise_on_overflow(outs) -> None:
    for out in outs:
        if bool(out.overflowed):
            raise RuntimeError(
                f"raster binning overflow: {int(out.num_pairs)} (tile, triangle) pairs "
                "hit the pair cap; triangles would be missing"
            )


def render(
    scene: Scene,
    camera: Camera,
    *,
    width: int,
    height: int,
    rows: int | None = None,
    y_offset: int = 0,
    tile_h: int | None = None,
    tile_w: int = 128,
    cull_backface: bool = True,
    apply_tonemap: bool = True,
    mip_lod: bool | None = None,
    ibl_merged: bool | None = None,
    aniso_taps: int = 1,
) -> torch.Tensor:
    """Render → (rows, W, 4) float32 RGBA, display encoded when
    ``apply_tonemap``, over the sky or the clear colour.

    ``rows``/``y_offset`` select the horizontal band [y_offset, y_offset+rows)
    of the width×height viewport (default: the whole frame). ``tile_h``:
    None picks each path's own, 8 for the row kernels and 16 for kernel 4.
    ``mip_lod`` (textured scenes): None follows :func:`default_mip_lod`.
    ``ibl_merged``: None (or True) completes the IBL ambient in the env
    gather where the maps allow it (SH9 + f16 stack, no alpha test); False
    shades it in ``shade_pixels`` (``ambient_ibl``). ``aniso_taps`` > 1:
    anisotropic taps on the mip_lod path. Raises ``RuntimeError`` when
    binning overflowed its pair cap (triangles would be missing); that
    check waits for the frame."""
    check_scene(scene, camera)
    if rows is None:
        rows = height
    textured = scene.atlas is not None
    geom = flatten_scene_corners(scene, textured=textured)
    vp = camera.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)  # (T, 3, 4)
    bg = background(scene, vp, width=width, height=height, rows=rows, y_offset=y_offset,
                    apply_tonemap=apply_tonemap)
    kw = dict(width=width, height=height, rows=rows, y_offset=y_offset, tile_w=tile_w,
              cull_backface=cull_backface, num_materials=scene.materials.num_materials)
    if textured or scene.materials.any_alpha_test or (scene.ibl is not None and not ibl_fusable(scene)):
        return _render_gbuffer(
            scene, camera, geom, clip, bg, tile_h=16 if tile_h is None else tile_h,
            apply_tonemap=apply_tonemap, mip_lod=default_mip_lod(scene) if mip_lod is None else mip_lod,
            ibl_merged=ibl_merged, aniso_taps=aniso_taps, **kw,
            **binning_params(geom.num_triangles, width, height, row_layout=False),
        )

    lights = scene.lights
    args = (clip, geom.attrs, geom.face_material, scene.materials.props_table(), lights.strength,
            lights.direction, lights.position, lights.spot_power, scene.ambient, camera.position)
    kw.update(tile_h=8 if tile_h is None else tile_h, num_dir=lights.num_dir, num_point=lights.num_point,
              num_spot=lights.num_spot, **binning_params(geom.num_triangles, width, height))
    if scene.ibl is not None:
        out = raster_shade_ibl(*args, scene.ibl.irradiance_sh9, **kw)
        img = compose_ibl(out.rgba, out.tri_id, scene, bg, apply_tonemap)
    else:
        out = raster_shade(*args, apply_tonemap=apply_tonemap, **kw)
        img = compose(out.rgba, out.tri_id >= 0, bg)
    _raise_on_overflow([out])
    return img


def _render_gbuffer(scene: Scene, camera: Camera, geom: CornerGeometry, clip: torch.Tensor, bg, *,
                    apply_tonemap: bool, mip_lod: bool, ibl_merged: bool | None, aniso_taps: int,
                    **raster_kw) -> torch.Tensor:
    """The G-buffer path of :func:`render` (renderer.py:683-896): kernel 4
    and :func:`shade_pixels`, the one-peel alpha test, the merged-IBL tail
    or the plain tonemap, the compose."""
    textured = scene.atlas is not None
    mats, ibl = scene.materials, scene.ibl
    split_ok = (ibl is not None and ibl.irradiance_sh9 is not None and ibl.specular_stack_f16 is not None
                and not mats.any_alpha_test)
    use_split = split_ok if ibl_merged is None else (ibl_merged and split_ok)
    rasters = []

    def raster_and_shade(z_floor):
        """One raster + shade layer → (hdr, opacity, mask, depth, mat_id[,
        spec_f, rdir, roughness]); ``z_floor`` (rows, W) peels."""
        out = raster_gbuffer(clip, geom.attrs, geom.face_material, z_floor=z_floor, **raster_kw)
        rasters.append(out)
        pos_w, normal_w, tangent_w, bitangent_w, uv = _split_attrs(out.attrs, textured)
        shaded = shade_pixels(
            pos_w=pos_w, normal_w=normal_w, tangent_w=tangent_w, bitangent_w=bitangent_w, uv=uv,
            material_id=out.mat_id, materials=mats, atlas=scene.atlas, lights=scene.lights,
            ambient=scene.ambient, eye=camera.position, ibl=ibl, combined=scene.combined_atlas,
            mip_lod=mip_lod, ibl_split=use_split, aniso_taps=aniso_taps,
        )
        hdr, opacity, keep = shaded[:3]
        mask = out.tri_id >= 0
        if keep is not None:
            mask = mask & keep  # parallax uv clip: the fragment falls through to the background
        return (hdr, opacity, mask, out.depth, out.mat_id) + tuple(shaded[3:])

    shaded = raster_and_shade(None)
    hdr, opacity, mask, depth, mat_id = shaded[:5]
    if mats.any_alpha_test:
        # Alpha test (clip(opacity − 0.1), Default.hlsl:111-116): a fragment
        # an alpha-tested material kills shows the next one behind it, found
        # by one depth peel behind this layer's own depths.
        killed = mask & (mats.alpha_test[mat_id.long()] > 0.5) & (opacity < 0.1)
        hdr2, op2, mask2, _, mat2 = raster_and_shade(torch.where(mask, depth, -torch.inf))[:5]
        accept2 = mask2 & ((mats.alpha_test[mat2.long()] <= 0.5) | (op2 >= 0.1))
        hdr = torch.where(killed[..., None], hdr2, hdr)
        opacity = torch.where(killed, op2, opacity)
        mask = torch.where(killed, accept2, mask)
    _raise_on_overflow(rasters)
    if use_split:
        return ibl_compose(hdr, *shaded[5:], opacity, mask, scene, bg, apply_tonemap)
    fg = tonemap(hdr) if apply_tonemap else hdr
    return compose(torch.cat([fg, opacity[..., None]], dim=-1), mask, bg)


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
    return ibl_compose(chan[..., 0:3], chan[..., 3:6], chan[..., 6:9], chan[..., 9], chan[..., 10], tri_id >= 0,
                       scene, bg, apply_tonemap)


def ibl_compose(hdr, spec_f, rdir, roughness, opacity, hit, scene: Scene, bg: torch.Tensor,
                apply_tonemap: bool) -> torch.Tensor:
    """The merged-IBL tail of both IBL paths (renderer.py:550-592,
    :837-872): hdr + spec_f·prefiltered(rdir, roughness), the prefiltered
    specular from the env gather, then tonemap and compose over ``bg``."""
    ibl = scene.ibl
    smp_all = sample_spec_sky_merged(ibl, rdir, hit)
    # Background taps are not meaningful (and, with the JAX package's merged
    # gather, may be NaN): mask before any arithmetic.
    smp_all = torch.where(hit[..., None], smp_all, 0.0)
    hdr = hdr + spec_f * specular_levels_lerp(smp_all, roughness, ibl.num_specular_levels)
    fg = tonemap(hdr) if apply_tonemap else hdr
    return compose(torch.cat([fg, opacity[..., None]], dim=-1), hit, bg)


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
    (renderer.py:932-1046) → (rows, W, 4). Untextured scenes without IBL or
    alpha test shade through ``shade_fused`` on both devices (the JAX
    package takes it off the CPU only); other scenes through
    :func:`shade_pixels` (bilinear mip 0, the IBL ambient in the shader, no
    alpha peel: the JAX package's general tail). The sky (``sky_map``, else
    ``env_map``) or the clear colour goes behind."""
    rows = mask.shape[0]
    textured = scene.atlas is not None
    bg = background(scene, camera.view_proj(), width=width, height=height, rows=rows, y_offset=y_offset,
                    apply_tonemap=apply_tonemap)
    if not textured and scene.ibl is None and not scene.materials.any_alpha_test:
        lights = scene.lights
        rgba_fg = shade_fused(
            attrs[..., :6], pix_mat, mask, scene.materials.props_table(), lights.strength, lights.direction,
            lights.position, lights.spot_power, scene.ambient, camera.position, num_dir=lights.num_dir,
            num_point=lights.num_point, num_spot=lights.num_spot, apply_tonemap=apply_tonemap,
        )
        return compose(rgba_fg, mask, bg)
    pos_w, normal_w, tangent_w, bitangent_w, uv = _split_attrs(attrs, textured)
    hdr, opacity, keep = shade_pixels(
        pos_w=pos_w, normal_w=normal_w, tangent_w=tangent_w, bitangent_w=bitangent_w, uv=uv,
        material_id=pix_mat, materials=scene.materials, atlas=scene.atlas, lights=scene.lights,
        ambient=scene.ambient, eye=camera.position, ibl=scene.ibl, combined=scene.combined_atlas,
    )
    if keep is not None:
        mask = mask & keep
    fg = tonemap(hdr) if apply_tonemap else hdr
    return compose(torch.cat([fg, opacity[..., None]], dim=-1), mask, bg)
