"""The yardstick of the roofline shares: the H100's published peaks and the
work each layer's frame needs, counted from the scene and the frame by the
benchmark's own reference (its geometry, its z-buffer, its sampler's taps),
never from the program's binning or tensors. A faster implementation of a
layer is judged against the same work."""

from __future__ import annotations

import torch

from .reference import render as ref

# NVIDIA H100 SXM, published, dense, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

F32 = 4
GBUF_CHANNELS = 14  # pos, normal, tangent, bitangent, uv
SLOT_CHANNELS = {"diffuse": 3, "specular": 3, "metallic": 1, "roughness": 1, "normal": 3, "opacity": 1}
MATERIAL_ROW = 28  # floats of a material's row in the textured path


def least_seconds(moved_bytes: float, flops: float) -> float:
    """The least time for the work: the larger of its bytes over HBM
    bandwidth and its float32 operations over the float32 rate."""
    return max(moved_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def shade_flops(num_dir: int, num_point: int, num_spot: int, tonemap: bool, ibl: bool) -> int:
    """float32 operations of one shaded pixel (the CUDA shader's count,
    ``csrc/shade_core.cuh``): 51 before the lights, 95 a directional light
    (+15 point, +22 spot), the ambient term and tonemap 15 (6 without), the
    IBL tail 162 instead."""
    return 51 + 95 * num_dir + 110 * num_point + 117 * num_spot + (162 if ibl else 15 if tonemap else 6)


def filter_flops(channels: int, trilinear: bool) -> int:
    """A bilinear sample: the two weights' complements and three lerps of
    three operations a channel; trilinear: two of them and a lerp."""
    one = 2 + 9 * channels
    return 2 * one + 3 * channels if trilinear else one


def plane_flops(num_ch: int) -> int:
    """A G-buffer write: the pixel offset, num_ch planes of four operations,
    the perspective divides and the depth plane."""
    return 2 + 4 * num_ch + (num_ch - 1) + 4


@torch.no_grad()
def frame_work(scene: ref.RefScene, pose: torch.Tensor, width: int, height: int) -> dict:
    """The work one frame asks of the raster layer's kernel and of the PS
    stage, as (bytes, flops) each, from the reference's own view of the
    frame: its triangles in view, its hit pixels, the texels its samples
    touch."""
    vp = ref.view_proj(pose[0:3], pose[3], pose[4], width / height)
    clip = ref.to_clip(scene.corners[..., 0:3], vp)
    xy, _, _, valid = ref.front_triangles(clip, width, height)
    on_screen = ((xy[..., 0].amax(-1) >= 0) & (xy[..., 0].amin(-1) <= width)
                 & (xy[..., 1].amax(-1) >= 0) & (xy[..., 1].amin(-1) <= height))
    tris = int((valid & on_screen).sum())
    tri_id = ref.rasterize(clip, width, height)
    hit = tri_id >= 0
    hits = int(hit.sum())
    pixels = width * height
    # kernel 4: each triangle's corners (clip xyzw and 14 attributes) and its
    # material read once; every pixel's hit code and each hit pixel's 14
    # attributes and depth written once
    k4_bytes = tris * (3 * (4 + GBUF_CHANNELS) + 1) * F32 + pixels * F32 + hits * (GBUF_CHANNELS + 1) * F32
    k4_flops = hits * plane_flops(GBUF_CHANNELS + 1)

    gbuf = ref.interpolate(scene.corners, clip, tri_id, width, height)
    mid = torch.where(hit, scene.face_material[tri_id.clamp(min=0)], 0)
    bank = scene.bank
    a = bank["uv_transform"][mid].reshape(height, width, 3, 2)
    uv = gbuf[..., 12:14]
    uv_t = uv[..., 0:1] * a[..., 0, :] + uv[..., 1:2] * a[..., 1, :] + a[..., 2, :]
    lod = ref.screen_space_lod(uv_t, scene.pages.size) if scene.mip_lod else None
    texel_bytes, filt = 0, 0
    for slot, ch in SLOT_CHANNELS.items():
        s = ref.SLOT[slot]
        bound = hit & (bank["has_tex"][mid, s] > 0)  # the material's own binding: a masked read is no work
        n = int(bound.sum())
        if n == 0:
            continue
        page = scene.tex_index[mid, s][bound]
        rows = _tap_rows(scene.pages, page, uv_t[bound], None if lod is None else lod[bound])
        texel_bytes += int(torch.unique(rows).numel()) * ch * F32
        filt += n * filter_flops(ch, lod is not None)
    materials = int(torch.unique(mid[hit]).numel()) if hits else 0
    ibl = scene.ibl is not None
    out_ch = 4 + (7 if ibl else 0)  # hdr and opacity; the IBL split's spec_f, reflect direction, roughness
    ps_bytes = hits * (GBUF_CHANNELS + 1) * F32 + texel_bytes + materials * MATERIAL_ROW * F32 + hits * out_ch * F32
    ps_flops = hits * shade_flops(scene.lights["strength"].shape[0], 0, 0, False, False) + filt
    return dict(tris=tris, hits=hits, kernel4=(k4_bytes, k4_flops), ps_stage=(ps_bytes, ps_flops))


def _tap_rows(pages: ref.Pages, page, uv, lod):
    """Stack rows of the four bilinear taps of each sample (both levels of a
    trilinear one)."""
    if lod is None:
        levels = [torch.zeros_like(page)]
    else:
        lodc = torch.clamp(lod, 0.0, pages.num_levels - 1.0)
        l0 = torch.floor(lodc).to(torch.int64)
        levels = [l0, torch.clamp(l0 + 1, max=pages.num_levels - 1)]
    out = []
    n, s = pages.num_pages, pages.size
    for level in levels:
        sl = torch.bitwise_right_shift(torch.full_like(level, s), level)
        base = (4 * n * (s * s - sl * sl)) // 3 + page * (sl * sl)
        slf = sl.to(torch.float32)
        x0 = torch.floor(uv[..., 0] * slf - 0.5).to(torch.int64)
        y0 = torch.floor(uv[..., 1] * slf - 0.5).to(torch.int64)
        m = sl - 1
        for dy in (0, 1):
            for dx in (0, 1):
                out.append(base + ((y0 + dy) & m) * sl + ((x0 + dx) & m))
    return torch.cat(out)
