"""Render — the counterpart of ``physically_based_renderer_tpu/renderer.py``.
``render(raster_backend=)`` takes any of the JAX package's route names
(:func:`raster_route`: kernels 1, 1b, 7, 7b, 4, 2 and 5, and the oracles
``"jnp"`` and ``"brute"``). With ``"auto"`` it picks its path by the scene,
as the JAX package's ``"auto"`` does on an accelerator (renderer.py:456-478):

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

The render modes: :func:`render_layered` (the reference's material-layer
draw: solid depth peels with the alpha test, then transparent layers
blended front to back; every peel is kernel 5, ``rasterize_binned``),
:func:`render_wireframe` (kernel 5, then ``ops/raster_soft.
signed_distance_px``), :func:`render_ssaa` (``render`` at factor×, then a
box filter) and :func:`render_soft` (the differentiable-visibility render:
K depth peels through kernel 5's dilated mode, each layer shaded, then the
SoftRas composite; gradients reach the geometry through silhouettes and
occlusion order).

:func:`check_raster_capacity` counts the binning's (tile, triangle) pairs
on the host and suggests a pair cap; :func:`render_checked` validates the
binning's invariants and raises before it renders (``app.RenderLoop`` heals
an overflowing cap with the first, on its first frame).

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
from .ops.raster import setup_corners
from .ops.raster_bin import bin_triangles, check_binning_invariants
from .ops.raster_pallas import raster_gbuffer, raster_shade, raster_shade_ibl, rasterize_binned, shade_fused
from .ops.raster_soft import peel_layers, signed_distance_px, soft_composite
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


# render's raster routes (raster_backend=), each the port's counterpart of
# the JAX backend of that name
SHADE_ROUTES = ("pallas_shade_row", "pallas_shade")  # kernels 1, 7: fused raster + shade
IBL_ROUTES = ("pallas_shade_ibl_row", "pallas_shade_ibl")  # kernels 1b, 7b
GBUF_ROUTES = ("pallas_gbuf", "pallas_gbuf_row")  # kernels 4, 2 + shade_pixels
ID_ROUTES = ("pallas", "jnp", "brute")  # kernel 5, the tiled oracle, the brute oracle + interpolate + shade
INTERPRET_ROUTES = ("pallas_interpret", "pallas_gbuf_interpret", "pallas_shade_interpret",
                    "pallas_shade_ibl_interpret")


def raster_route(raster_backend: str, scene: Scene, device) -> str:
    """The route ``render`` takes for ``raster_backend`` on tensors of
    ``device``. ``"auto"``: the fused row kernel for untextured scenes
    without IBL or alpha test, its IBL mode where the maps allow it
    (:func:`ibl_fusable`), else kernel 4 — on the CPU as on the card (the
    JAX package's ``"auto"`` on the CPU is ``"jnp"``). A ``*_interpret``
    name is its route on CPU tensors, where every kernel runs its plain
    version anyway, and raises ``ValueError`` on CUDA tensors: no name runs
    a plain version on the card. An unknown name raises ``ValueError``; so
    does a route the scene cannot take (as the JAX package's asserts)."""
    route = raster_backend
    if route == "auto":
        if scene.atlas is None and scene.ibl is None and not scene.materials.any_alpha_test:
            route = "pallas_shade_row"
        elif ibl_fusable(scene):
            route = "pallas_shade_ibl_row"
        else:
            route = "pallas_gbuf"
    elif route in INTERPRET_ROUTES:
        if torch.device(device).type == "cuda":
            raise ValueError(f"raster_backend {raster_backend!r} names a plain version, which runs on CPU "
                             f"tensors only; on the card use {route.removesuffix('_interpret')!r}")
        route = route.removesuffix("_interpret")
    if route not in SHADE_ROUTES + IBL_ROUTES + GBUF_ROUTES + ID_ROUTES:
        raise ValueError(f"unknown raster_backend {raster_backend!r}")
    if route in IBL_ROUTES and not ibl_fusable(scene):
        raise ValueError(f"{route} needs an untextured scene with IBLMaps carrying irradiance_sh9 and "
                         "specular_stack_f16, and no alpha test")
    if route in SHADE_ROUTES and (scene.atlas is not None or scene.ibl is not None):
        raise ValueError(f"{route} fuses the untextured constant-material shader only")
    if route in SHADE_ROUTES and scene.materials.any_alpha_test:
        raise ValueError(f"{route} has no depth-peel hook for the alpha test; use pallas_gbuf")
    if route == "brute" and scene.materials.any_alpha_test:
        raise ValueError("the brute rasterizer has no depth peel for the alpha test")
    return route


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
    tri_block: int = 128,
    cull_backface: bool = True,
    apply_tonemap: bool = True,
    raster_backend: str = "auto",
    raster_pairs_cap: int | None = None,
    mip_lod: bool | None = None,
    ibl_merged: bool | None = None,
    aniso_taps: int = 1,
) -> torch.Tensor:
    """Render → (rows, W, 4) float32 RGBA, display encoded when
    ``apply_tonemap``, over the sky or the clear colour.

    ``rows``/``y_offset`` select the horizontal band [y_offset, y_offset+rows)
    of the width×height viewport (default: the whole frame). ``tile_h``:
    None picks each route's own (the JAX package's). ``raster_backend``
    picks the route (:func:`raster_route`):

      * ``"pallas_shade_row"`` / ``"pallas_shade"``: kernel 1 / kernel 7,
        fused raster + shade (untextured, no IBL, no alpha test);
      * ``"pallas_shade_ibl_row"`` / ``"pallas_shade_ibl"``: their IBL
        modes, kernels 1b / 7b, then the env gather;
      * ``"pallas_gbuf"`` / ``"pallas_gbuf_row"``: kernel 4 / kernel 2 (raster
        + G-buffer), then :func:`shade_pixels`;
      * ``"pallas"``: kernel 5 (ids and material codes), then
        ``interpolate_corners`` and :func:`shade_pixels`;
      * ``"jnp"`` / ``"brute"``: the oracles ``raster.rasterize`` (tiles of
        ``tile_h`` × ``tile_w``, ``tri_block`` triangles a block) and
        ``raster.rasterize_brute`` (whole frames, no peel, so no alpha
        test), then the same;
      * ``"auto"``: kernel 1 for untextured scenes without IBL or alpha test,
        kernel 1b where the IBL maps allow it, else kernel 4 — on either
        device (the JAX package's ``"auto"`` is ``"jnp"`` on its CPU);
      * the JAX package's ``*_interpret`` names, on CPU tensors only.

    ``mip_lod`` (textured scenes): None follows :func:`default_mip_lod`.
    ``ibl_merged``: None (or True) completes the IBL ambient in the env
    gather where the maps allow it (SH9 + f16 stack, no alpha test; not on
    the oracle routes); False shades it in ``shade_pixels``
    (``ambient_ibl``). ``aniso_taps`` > 1: anisotropic taps on the mip_lod
    path. ``raster_pairs_cap``: the binning's pair cap; None scales the
    default with the resolution (:func:`binning_params`). Raises
    ``RuntimeError`` when a kernel's binning overflowed its pair cap
    (triangles would be missing; the JAX package drops them); that check
    waits for the frame."""
    check_scene(scene, camera)
    if rows is None:
        rows = height
    route = raster_route(raster_backend, scene, camera.device)
    textured = scene.atlas is not None
    geom = flatten_scene_corners(scene, textured=textured)
    vp = camera.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)  # (T, 3, 4)
    bg = background(scene, vp, width=width, height=height, rows=rows, y_offset=y_offset,
                    apply_tonemap=apply_tonemap)
    kw = dict(width=width, height=height, rows=rows, y_offset=y_offset, tile_w=tile_w,
              cull_backface=cull_backface, num_materials=scene.materials.num_materials)
    row_layout = route.endswith("_row")
    if route in ("jnp", "brute"):
        bins = {}
    else:
        bins = binning_params(geom.num_triangles, width, height,
                              row_layout=row_layout or route in SHADE_ROUTES + IBL_ROUTES)
        if route in ("pallas_shade", "pallas_shade_ibl", "pallas"):
            bins["big2_span"] = 0  # the v1 binning has no big2 class
        if raster_pairs_cap is not None:  # the caller's cap replaces the resolution scaling
            bins["pairs_cap"] = raster_pairs_cap

    if route in GBUF_ROUTES + ID_ROUTES:
        default_tile_h = {"pallas_gbuf": 16, "pallas_gbuf_row": 4, "pallas": 16, "jnp": 32, "brute": 32}[route]
        return _render_deferred(
            scene, camera, geom, clip, bg, route=route, tile_h=default_tile_h if tile_h is None else tile_h,
            tri_block=tri_block, apply_tonemap=apply_tonemap,
            mip_lod=default_mip_lod(scene) if mip_lod is None else mip_lod, ibl_merged=ibl_merged,
            aniso_taps=aniso_taps, **kw, **bins,
        )

    lights = scene.lights
    args = (clip, geom.attrs, geom.face_material, scene.materials.props_table(), lights.strength,
            lights.direction, lights.position, lights.spot_power, scene.ambient, camera.position)
    # row_layout=True: the row kernel (kernel 1 / 1b); raster_shade's own
    # default is the v1 binning at 4-row tiles (kernel 7 / 7b).
    kw.update(tile_h=(8 if row_layout else 4) if tile_h is None else tile_h, num_dir=lights.num_dir,
              num_point=lights.num_point, num_spot=lights.num_spot, row_layout=row_layout, **bins)
    if route in IBL_ROUTES:
        out = raster_shade_ibl(*args, scene.ibl.irradiance_sh9, **kw)
        img = compose_ibl(out.rgba, out.tri_id, scene, bg, apply_tonemap)
    else:
        out = raster_shade(*args, apply_tonemap=apply_tonemap, **kw)
        img = compose(out.rgba, out.tri_id >= 0, bg)
    _raise_on_overflow([out])
    return img


def _render_deferred(scene: Scene, camera: Camera, geom: CornerGeometry, clip: torch.Tensor, bg, *, route: str,
                     tri_block: int, apply_tonemap: bool, mip_lod: bool, ibl_merged: bool | None,
                     aniso_taps: int, **raster_kw) -> torch.Tensor:
    """The deferred routes of :func:`render` (renderer.py:683-896): a raster
    that resolves the G-buffer — kernel 4 or 2 (``raster_gbuffer``), or
    kernel 5 or an oracle for the ids and then ``interpolate_corners`` —
    and :func:`shade_pixels`, the one-peel alpha test, the merged-IBL tail
    or the plain tonemap, the compose."""
    textured = scene.atlas is not None
    mats, ibl = scene.materials, scene.ibl
    split_ok = (ibl is not None and ibl.irradiance_sh9 is not None and ibl.specular_stack_f16 is not None
                and not mats.any_alpha_test and route not in ("jnp", "brute"))
    use_split = split_ok if ibl_merged is None else (ibl_merged and split_ok)
    rows, width, height, y_offset = raster_kw["rows"], raster_kw["width"], raster_kw["height"], raster_kw["y_offset"]
    if route == "brute" and (rows != height or y_offset != 0):
        raise ValueError("the brute rasterizer renders whole frames only")
    want_depth = mats.any_alpha_test
    rasters = []

    def resolve(z_floor):
        """One raster layer → (attrs, depth, tri_id, mat_id); ``z_floor``
        (rows, W) peels."""
        if route in GBUF_ROUTES:
            out = raster_gbuffer(clip, geom.attrs, geom.face_material, z_floor=z_floor,
                                 row_layout=route == "pallas_gbuf_row", **raster_kw)
            rasters.append(out)
            return out.attrs, out.depth, out.tri_id, out.mat_id
        depth = None
        if route == "pallas":
            out = rasterize_binned(clip, None, face_material=geom.face_material, z_floor=z_floor,
                                   return_depth=z_floor is not None or want_depth, **raster_kw)
            rasters.append(out)
            tri_id, mat_id, depth = out.tri_id, out.mat_id, out.depth
        else:
            if route == "jnp":
                out = raster.rasterize(clip, None, width=width, height=height, rows=rows, y_offset=y_offset,
                                       tile_h=raster_kw["tile_h"], tile_w=raster_kw["tile_w"], tri_block=tri_block,
                                       cull_backface=raster_kw["cull_backface"], z_floor=z_floor,
                                       return_depth=z_floor is not None or want_depth)
                tri_id, depth = out if isinstance(out, tuple) else (out, None)
            else:
                tri_id = raster.rasterize_brute(clip, None, width=width, height=height,
                                                cull_backface=raster_kw["cull_backface"])
            mat_id = geom.face_material[tri_id.clamp(min=0).long()]
        attrs, depth_i, _ = raster.interpolate_corners(geom.attrs, clip, tri_id, width=width, height=height,
                                                       y_offset=y_offset)
        return attrs, depth_i if depth is None else depth, tri_id, mat_id

    def raster_and_shade(z_floor):
        """One raster + shade layer → (hdr, opacity, mask, depth, mat_id[,
        spec_f, rdir, roughness])."""
        attrs, depth, tri_id, mat_id = resolve(z_floor)
        pos_w, normal_w, tangent_w, bitangent_w, uv = _split_attrs(attrs, textured)
        shaded = shade_pixels(
            pos_w=pos_w, normal_w=normal_w, tangent_w=tangent_w, bitangent_w=bitangent_w, uv=uv,
            material_id=mat_id, materials=mats, atlas=scene.atlas, lights=scene.lights,
            ambient=scene.ambient, eye=camera.position, ibl=ibl, combined=scene.combined_atlas,
            mip_lod=mip_lod, ibl_split=use_split, aniso_taps=aniso_taps,
        )
        hdr, opacity, keep = shaded[:3]
        mask = tri_id >= 0
        if keep is not None:
            mask = mask & keep  # parallax uv clip: the fragment falls through to the background
        return (hdr, opacity, mask, depth, mat_id) + tuple(shaded[3:])

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


def render_ssaa(scene: Scene, camera: Camera, *, width: int, height: int, factor: int = 2,
                apply_tonemap: bool = True) -> torch.Tensor:
    """Anti-aliased render by ordered supersampling (renderer.py:1204-1224):
    :func:`render` at ``factor``× in each dimension, then a box filter down —
    the reference's 4×MSAA toggle (F2) at ``factor=2``. ``binning_params``
    scales the pair cap and the spans to the larger frame."""
    img = render(scene, camera, width=width * factor, height=height * factor, apply_tonemap=apply_tonemap)
    return img.reshape(height, factor, width, factor, 4).mean(dim=(1, 3))


def render_wireframe(scene: Scene, camera: Camera, *, width: int, height: int, thickness_px: float = 0.7,
                     line_color=(0.05, 0.05, 0.05)) -> torch.Tensor:
    """Wireframe render, the reference's F1 toggle (renderer.py:1228-1249):
    an id raster, then the pixels within ``thickness_px`` of their
    triangle's boundary take ``line_color``, the rest the clear colour;
    alpha 1. The raster is kernel 5 (``rasterize_binned``; the JAX package
    takes its jnp rasterizer here). Raises on binning overflow."""
    check_scene(scene, camera)
    geom = flatten_scene_corners(scene, textured=False)
    clip = math3d.transform_points_h(geom.pos_w, camera.view_proj())
    out = rasterize_binned(clip, None, width=width, height=height)
    _raise_on_overflow([out])
    sd = signed_distance_px(clip, None, out.tri_id, width=width, height=height)
    on_wire = (out.tri_id >= 0) & (sd < thickness_px)
    line = torch.stack([clip.new_full((), c) for c in line_color])  # fills, no host copy
    rgb = torch.where(on_wire[..., None], line, scene.clear_color)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def render_layered(scene: Scene, camera: Camera, *, width: int, height: int, solid_layers: int = 2,
                   transparent_layers: int = 2, apply_tonemap: bool = True) -> torch.Tensor:
    """Render with the material-layer semantics of the reference's seven-pass
    draw (``PBRApp.cpp:292-320``; renderer.py:1256-1380) → (H, W, 4), alpha
    1: opaque and alpha-tested surfaces resolved by ``solid_layers`` depth
    peels (back faces culled; the alpha test, clip(opacity − 0.1), and the
    parallax uv clip peel through), then ``transparent_layers`` peels of the
    transparent materials (no culling) blended front to back with
    accumulated transmittance where they lie in front of the solid layer,
    over the sky (``sky_map``, else ``env_map``) or the clear colour.

    Every peel is ``rasterize_binned`` (kernel 5) with ``tri_mask`` and
    ``z_floor``, on both devices; each layer is shaded by
    ``interpolate_corners`` + :func:`shade_pixels` (bilinear mip 0, the IBL
    ambient in the shader). Every merge is a ``torch.where``: a background
    pixel's shade may be NaN. Differentiable to materials, textures, lights,
    ambient and the eye through the shading (the peels' ids and depths carry
    no gradient). Raises on binning overflow in any peel."""
    check_scene(scene, camera)
    textured = scene.atlas is not None
    mats = scene.materials
    geom = flatten_scene_corners(scene, textured=textured)
    vp = camera.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)  # (T, 3, 4)
    face_transparent = mats.transparent[geom.face_material.long()] > 0.5
    rasters = []

    def peel(tri_mask, z_floor, cull):
        out = rasterize_binned(clip, None, width=width, height=height, tri_mask=tri_mask, cull_backface=cull,
                               z_floor=z_floor, return_depth=True)
        rasters.append(out)
        return out.tri_id, out.depth

    def shade_at(tri_id):
        attrs, _, _ = raster.interpolate_corners(geom.attrs, clip, tri_id, width=width, height=height)
        pos_w, normal_w, tangent_w, bitangent_w, uv = _split_attrs(attrs, textured)
        pix_mat = geom.face_material[tri_id.clamp(min=0).long()]
        hdr, opacity, keep = shade_pixels(
            pos_w=pos_w, normal_w=normal_w, tangent_w=tangent_w, bitangent_w=bitangent_w, uv=uv,
            material_id=pix_mat, materials=mats, atlas=scene.atlas, lights=scene.lights, ambient=scene.ambient,
            eye=camera.position, ibl=scene.ibl, combined=scene.combined_atlas,
        )
        color = tonemap(hdr) if apply_tonemap else hdr
        if keep is None:
            keep = torch.ones_like(tri_id, dtype=torch.bool)
        return color, opacity, pix_mat, keep

    # Solid resolve (opaque + alpha-tested) by depth peeling.
    z_floor = clip.new_full((height, width), -torch.inf)
    solid_rgb = clip.new_zeros((height, width, 3))
    solid_z = clip.new_ones((height, width))  # the far plane
    resolved = torch.zeros((height, width), dtype=torch.bool, device=clip.device)
    for _ in range(solid_layers):
        tid, z = peel(~face_transparent, z_floor, True)
        color, opacity, pix_mat, keep = shade_at(tid)
        at_flag = mats.alpha_test[pix_mat.long()] > 0.5
        hit = tid >= 0
        # clip(opacity − 0.1) of alpha-tested materials (Default.hlsl:113) and
        # the parallax uv clip (Default.hlsl:65-68) both peel through
        accept = hit & (~at_flag | (opacity >= 0.1)) & keep
        take = accept & ~resolved
        solid_rgb = torch.where(take[..., None], color, solid_rgb)
        solid_z = torch.where(take, z, solid_z)
        resolved = resolved | take
        z_floor = torch.where(hit, z, z_floor)

    bg = background(scene, vp, width=width, height=height, rows=height, y_offset=0, apply_tonemap=apply_tonemap)
    rgb = torch.where(resolved[..., None], solid_rgb, bg)

    # Transparent layers, front to back with transmittance (PBRApp.cpp:830-844).
    if transparent_layers > 0:
        trans_acc = clip.new_zeros((height, width, 3))
        transmit = clip.new_ones((height, width, 1))
        z_floor_t = clip.new_full((height, width), -torch.inf)
        for _ in range(transparent_layers):
            tid, z = peel(face_transparent, z_floor_t, False)  # the transparent PSO is CULL_NONE
            color, opacity, _, keep = shade_at(tid)
            visible = (tid >= 0) & (z < solid_z) & keep  # the depth test against the solids
            a = torch.where(visible, opacity, 0.0)[..., None]
            trans_acc = trans_acc + torch.where(visible[..., None], transmit * a * color, 0.0)
            transmit = transmit * (1.0 - a)
            z_floor_t = torch.where(tid >= 0, z, z_floor_t)
        rgb = trans_acc + transmit * rgb
    _raise_on_overflow(rasters)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def render_soft(scene: Scene, camera: Camera, *, width: int, height: int, num_layers: int = 3, sigma: float = 1.0,
                gamma: float = 1e-2, cull_backface: bool = True, apply_tonemap: bool = True,
                fused_shading: bool = True) -> torch.Tensor:
    """Differentiable-visibility render (renderer.py:1396-1551) → (H, W, 3)
    RGB, display encoded when ``apply_tonemap``.

    Peels the ``num_layers`` nearest fragments per pixel with kernel 5's
    dilated mode (``ops/raster_soft.peel_layers`` at ``edge_margin_px =
    3·sigma``, the coverage sigmoid's support), shades each layer and blends
    them with sigmoid coverage × softmax-depth weights
    (``ops/raster_soft.soft_composite``) over the sky or the clear colour.
    Gradients reach vertex positions and world matrices through silhouettes
    and occlusion order (through ``interpolate_corners(clamp=True)``'s
    depth and attributes and ``signed_distance_px``; the peels' ids and
    depths carry none), and the materials, lights, ambient and eye through
    the shading. sigma → 0, gamma → 0 approaches :func:`render`.

    An untextured scene without IBL or alpha test shades each layer through
    ``shade_fused`` (kernel 6 forward, kernel 3 backward) when
    ``fused_shading``; otherwise :func:`shade_pixels`. The CPU takes the
    same branch as the card (the JAX package shades with ``shade_pixels``
    on its CPU backend). Raises ``RuntimeError`` on binning overflow in any
    peel."""
    check_scene(scene, camera)
    textured = scene.atlas is not None
    geom = flatten_scene_corners(scene, textured=textured)
    vp = camera.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)  # (T, 3, 4)
    ids, _ = peel_layers(clip, None, width=width, height=height, num_layers=num_layers,
                         cull_backface=cull_backface, edge_margin_px=3.0 * sigma)
    mats, lights = scene.materials, scene.lights
    fusable = fused_shading and not textured and scene.ibl is None and not mats.any_alpha_test
    table = mats.props_table() if fusable else None

    colors, depths, sdists, valids = [], [], [], []
    for tri_id in ids:
        # clamp: a dilated pixel lies just outside its triangle; the attributes
        # stay on the face rather than extrapolate
        attrs, depth, mask = raster.interpolate_corners(geom.attrs, clip, tri_id, width=width, height=height,
                                                        clamp=True)
        pix_mat = geom.face_material[tri_id.clamp(min=0).long()]
        if fusable:
            color = shade_fused(attrs[..., :6], pix_mat, mask, table, lights.strength, lights.direction,
                                lights.position, lights.spot_power, scene.ambient, camera.position,
                                num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
                                apply_tonemap=apply_tonemap)[..., :3]
        else:
            pos_w, normal_w, tangent_w, bitangent_w, uv = _split_attrs(attrs, textured)
            hdr, _, keep = shade_pixels(
                pos_w=pos_w, normal_w=normal_w, tangent_w=tangent_w, bitangent_w=bitangent_w, uv=uv,
                material_id=pix_mat, materials=mats, atlas=scene.atlas, lights=lights, ambient=scene.ambient,
                eye=camera.position, ibl=scene.ibl, combined=scene.combined_atlas,
            )
            color = tonemap(hdr) if apply_tonemap else hdr
            if keep is not None:
                mask = mask & keep  # the parallax uv clip discards the fragment
        colors.append(color)
        depths.append(torch.where(mask, depth, torch.inf))
        sdists.append(signed_distance_px(clip, None, tri_id, width=width, height=height))
        valids.append(mask)

    bg = background(scene, vp, width=width, height=height, rows=height, y_offset=0, apply_tonemap=apply_tonemap)
    return soft_composite(torch.stack(colors), torch.stack(depths), torch.stack(sdists), torch.stack(valids),
                          bg, sigma=sigma, gamma=gamma)


def check_raster_capacity(scene: Scene, camera: Camera, *, width: int, height: int, rows: int | None = None,
                          y_offset: int = 0, tile_h: int | None = None, tile_w: int = 128,
                          pairs_cap: int | None = None, headroom: float = 1.25) -> dict:
    """Host-side binning-capacity check (renderer.py:1049-1136) → {"num_pairs",
    "pairs_cap", "overflowed", "suggested_pairs_cap"} as Python scalars:
    the (tile, triangle) pairs the frame's binning emits, under JAX's tile
    and span choices (8-row tiles for the fused kernels' scenes, 16 else;
    max span 64 for scenes of at most 2¹⁵ triangles), and a cap with
    ``headroom`` rounded up to 128. When the first binning overflowed, the
    frame is binned again at cap max(cap·16, 2²²) to count every pair. Pass
    ``suggested_pairs_cap`` back as ``render(raster_pairs_cap=...)``;
    ``app.RenderLoop`` does so on its first frame."""
    geom = flatten_scene_corners(scene, textured=scene.atlas is not None)
    clip = math3d.transform_points_h(geom.pos_w, camera.view_proj())
    span_wide = geom.num_triangles <= (1 << 15)
    if tile_h is None:
        # render's own paths: the row kernels (fused shade, fused IBL) bin at
        # 8-row tiles with max span 16, kernel 4 at 16 with max span 8
        fused = scene.atlas is None and not scene.materials.any_alpha_test
        tile_h = 8 if fused else 16
        max_span = 64 if span_wide else (16 if fused else 8)
    else:
        max_span = 64 if span_wide else 8
    with torch.no_grad():
        st = setup_corners(clip, width, height, True, None)
        kw = dict(width=width, height=height, rows=rows, y_offset=y_offset, tile_h=tile_h, tile_w=tile_w,
                  max_span=max_span)
        binned = bin_triangles(st, pairs_cap=pairs_cap, **kw)
        overflowed = bool(binned.overflowed)
        cap = pairs_cap if pairs_cap is not None else max(geom.num_triangles, 1 << 16)
        if overflowed:
            # num_pairs is clipped at the cap: count them all under a cap
            # above every slot (2T + max_span·big_cap + T)
            binned = bin_triangles(st, pairs_cap=max(cap * 16, 1 << 22), **kw)
        num_pairs = int(binned.num_pairs)
    suggested = -(-int(num_pairs * headroom) // 128) * 128
    return {"num_pairs": num_pairs, "pairs_cap": cap, "overflowed": overflowed,
            "suggested_pairs_cap": max(suggested, 128)}


def render_checked(scene: Scene, camera: Camera, *, width: int, height: int, tile_h: int | None = None,
                   tile_w: int = 128, raster_pairs_cap: int | None = None, **render_kw) -> torch.Tensor:
    """Debug-mode render (renderer.py:1139-1201): bins the frame as the fused
    kernels do (4-row tiles unless ``tile_h``; max span 64, or 16 past 2¹⁵
    triangles; ``raster_pairs_cap``) and validates the binning's invariants
    with ``raster_bin.check_binning_invariants`` — no pair-cap overflow,
    run bounds in range, triangle ids in [−1, T) — raising ``RuntimeError``
    on the first violated one (the JAX package checks them under checkify),
    then renders with :func:`render`."""
    check_scene(scene, camera)
    geom = flatten_scene_corners(scene, textured=scene.atlas is not None)
    num_tris = geom.num_triangles
    with torch.no_grad():
        clip = math3d.transform_points_h(geom.pos_w, camera.view_proj())
        binned = bin_triangles(setup_corners(clip, width, height, True, None), width=width, height=height,
                               tile_h=4 if tile_h is None else tile_h, tile_w=tile_w,
                               max_span=64 if num_tris <= (1 << 15) else 16, pairs_cap=raster_pairs_cap)
        check_binning_invariants(binned, num_tris)
    return render(scene, camera, width=width, height=height, tile_h=tile_h, tile_w=tile_w,
                  raster_pairs_cap=raster_pairs_cap, **render_kw)
