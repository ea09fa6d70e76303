"""Device time of the main path's kernels, for one tree of the port (PyTorch).

    python scripts/profile_torch_kernels.py [TREE]

TREE (default: this checkout) is the root of a checkout of the repository,
so that a parent and a change can be timed by one method in one call, in
turns: ``git archive <parent> | tar -x -C build/parent``, then run this
script with ``build/parent``, ``.``, ``.``, ``build/parent``. On the 1080p
sphere grid (``red_sphere_grid_scene(64, 32)``, the ``bench.py`` camera) it
prints the card and its power limit, the ptxas report of each library it
builds (``rm -rf TREE/build/kernels`` first); for the row binning (8×128 tiles,
kernels 1 / 1b) and the v1 binning (4×128, kernels 7 / 7b) the run lengths
and the (pair, pixel) tests — against every pixel of the tile, inside each
triangle's pixel box, and kept by the shade mode's per-warp reject where
the tree has one (``chip_smoke.raster_tests`` / ``culled_tests``); then one
JSON line of milliseconds: each mode of the fused raster+shade, and the
adjoint (kernel 3 / 3b) with every output and, where the tree's
``shade_backward`` takes ``want_attrs`` / ``want_props``, without the
per-pixel outputs (the fused step's call); and the id raster at 16×128
tiles: kernel 5 on ``chip_smoke.py`` phase s's first solid peel of the
layer-mixed grid and the transparent peel behind it, kernel 5b on
``render_soft``'s three dilated peels (margin 3 px, each behind the last),
each with its tests — against every pixel, inside each (dilated)
triangle's box, kept by the per-warp reject at the margin (where the
tree has ``chip_smoke.warp_kept_pairs``), and kept if a depth reject also
dropped each (pair, warp) whose depth plane lies outside [0, 1] or nowhere
above the warp's smallest z floor (a model of a reject the kernel does not
run) — and the spread of the kept pairs over the tiles: each tile's busiest
warp sets its CTA's pace, so the largest of those against their sum over
the CTA slots says how far a tail of dense tiles bounds the kernel; and the
G-buffer mode: kernel 2 on ``chip_smoke.py`` phase h's full frame (the
grid, the triangle-sharded ring's row binning at 8×128 tiles, C = 6, and
the same at C = 14), kernel 4 on phase n's ``pbr_scene`` (seeded pages, the
v1 binning at 16×128 tiles, C = 14) and on the alpha frame's peel behind it
(phase r's second launch), each with the same test counts at the G-buffer
mode's pixel map (PPT 4 at 8×128, PPT 8 at 16×128) and the busiest-warp
spread. Each time is device time: the stream spins (``torch.cuda._sleep``) while the
host enqueues 30 calls between two CUDA events. Needs a CUDA card; imports
no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


SMS = 132  # an H100's streaming multiprocessors
CTAS_PER_SM = {4: 3, 8: 2}  # the culled raster's resident CTAs an SM by PPT (registers: ≤ 80 at PPT 4, ≤ 128 at 8)


def device_ms(fn, iters: int = 30) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * host_s * iters + 1e-3)))  # cycles, at up to ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(end) / iters, 4)


def depth_kept_tests(cs, raster_row, starts, packed, pair_tri, *, z_floor=None, margin=0.0, **kw) -> int:
    """The tests ``chip_smoke.culled_tests`` counts at PPT 8, less those of
    each kept (pair, warp) whose depth plane over the warp's box of pixel
    centres (float64, no slack) is entirely below 0, entirely above 1, or
    nowhere above the smallest z floor of the warp's pixels in the image."""
    import torch

    box, row, col, ok = cs.warp_boxes(ppt=8, device=packed.device, **kw)
    rows, width = kw["rows"], kw["width"]
    zf = (torch.full(ok.shape[:2], -torch.inf, device=packed.device) if z_floor is None else
          torch.where(ok, z_floor[row.clamp(max=rows - 1), col.clamp(max=width - 1)], torch.inf).amin(-1))
    count = ok.sum(-1)
    tile = torch.arange(ok.shape[0], device=packed.device)
    st = starts.long()
    g, end = int(st[0]), int(st[-1])

    def kept(f, tiles):
        x_lo, x_hi, y_lo, y_hi = (b[tiles].double() for b in box)
        f = f[:, None, :].double()
        za, zb, zc = f[..., 11], f[..., 12], f[..., 13]
        dx = torch.stack([x_lo - f[..., 9], x_hi - f[..., 9]]) * za
        dy = torch.stack([y_lo - f[..., 10], y_hi - f[..., 10]]) * zb
        z_hi, z_lo = dx.amax(0) + dy.amax(0) + zc, dx.amin(0) + dy.amin(0) + zc
        drop = (z_hi < 0) | (z_lo > 1) | (z_hi <= zf[tiles].double())
        drop |= raster_row.footprint_rejects(f[..., :11].float(), *(b[tiles] for b in box), margin=margin)
        return torch.where(drop, 0, count[tiles])

    own_tile = torch.repeat_interleave(tile, st[1:] - st[:-1])
    total = int(kept(packed[g:end, :14], own_tile).sum())
    for j in range(g):
        total += int(kept(packed[j : j + 1, :14].expand(tile.shape[0], 14), tile).sum())
    return total


def reject_counts(cs, args, xy, kw, ppt: int) -> str:
    """The culled resolve's (pair, pixel) tests on one binning at the pixel
    map of ``ppt``: against every pixel of the tile, inside each (dilated)
    triangle's box, kept by the per-warp reject (at ``kw``'s margin); and
    each tile's busiest warp against the balanced share of the card's CTA
    slots."""
    slots = SMS * CTAS_PER_SM[ppt]
    starts = args[0]
    every = ((starts.shape[0] - 1) * int(starts[0]) + int(starts[-1] - starts[0])) * kw["tile_h"] * kw["tile_w"]
    in_box = cs.raster_tests(starts, args[2], xy, **kw)
    kept_pairs, pixels = cs.warp_kept_pairs(*args, ppt=ppt, **kw)
    kept = int((kept_pairs * pixels).sum())
    busiest = kept_pairs.amax(1)
    return (f"{cs.run_stats(starts)}; (pair, pixel) tests {every} against every pixel, {in_box} "
            f"({in_box / every:.2%}) inside the (dilated) triangle's box, {kept} ({kept / every:.2%}) kept by the per-warp "
            f"reject at PPT {ppt} ({kept / max(in_box, 1):.1f}x the in-box ones); kept pairs of each tile's busiest "
            f"warp: {int(busiest.max())} at most, {int(busiest.sum())} in all ({float(busiest.sum()) / slots:.0f} a "
            f"CTA slot at {CTAS_PER_SM[ppt]} CTAs an SM)")


def ids_kernels(cs, pbr, grid, cam, dev, width, height, out, timer=device_ms) -> None:
    """Kernel 5 on phase s's two peels and kernel 5b on render_soft's three:
    their tests, and their device times into ``out``."""
    import torch

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_row

    counted = hasattr(cs, "warp_kept_pairs")  # the tree models the ids mode's reject
    v1_ids = dict(tile_h=16, tile_w=128, max_span=8, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)
    scene = cs.with_fields(grid, cs.layer_mix_fields(grid.materials, 11), dev, any_alpha_test=True)
    geom = pbr.flatten_scene_corners(scene)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    transparent = scene.materials.transparent[geom.face_material.long()] > 0.5
    xy = cs.screen_xy(clip, width, height)

    def peel(key, name, floor, margin=0.0, cull=True, tri_mask=None):
        b = raster_row.bin_for_shade(clip, None, None, width=width, height=height, rows=height, y_offset=0,
                                     cull_backface=cull, tri_mask=tri_mask, bbox_margin_px=margin, **v1_ids)
        kw = dict(width=width, rows=height, y_offset=0, tile_h=16, tile_w=128, mat_stride=1, want_depth=True,
                  z_floor=floor, margin=margin)
        args = (b.starts, b.packed, b.pair_tri)
        code, depth = raster_row.raster_ids_tiles_cuda(*args, **kw)
        if counted:
            deep = depth_kept_tests(cs, raster_row, *args, **kw)
            print(f"{name}: " + reject_counts(cs, args, xy, kw, 8) + f"; {deep} tests kept with a depth reject too")
        out[key] = timer(lambda: raster_row.raster_ids_tiles_cuda(*args, **kw))
        return torch.where(code >= 0, depth, floor).contiguous()

    floor0 = torch.full((height, width), -torch.inf, device=dev)
    solid = peel("k5_solid_peel", "kernel 5, first solid peel", floor0, tri_mask=~transparent)
    peel("k5_peel_behind", "kernel 5, transparent peel behind it", solid, cull=False, tri_mask=transparent)
    floor = floor0
    for k in range(3):
        floor = peel(f"k5b_peel{k}", f"kernel 5b, render_soft peel {k}", floor, margin=3.0)


def gbuffer_kernels(cs, pbr, grid, cam, dev, width, height, out, timer=device_ms) -> None:
    """Kernel 2 on phase h's full frame (C = 6 and 14) and kernel 4 on phase
    n's ``pbr_scene`` and its alpha peel: their tests, and their device
    times into ``out``."""
    import torch

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.renderer import binning_params

    def case(key, name, clip, attrs, fm, num_materials, bins, ppt, z_floor=None, v1=False, counted=True):
        b = raster_row.bin_for_shade(clip, attrs, fm, width=width, height=height, rows=height, y_offset=0,
                                     cull_backface=True, **bins)
        kw = dict(width=width, rows=height, y_offset=0, tile_h=bins["tile_h"], tile_w=bins["tile_w"],
                  z_floor=z_floor, num_ch=attrs.shape[-1] + 1,
                  mat_stride=raster_row.material_stride(num_materials, clip.shape[0]))
        args = (b.starts, b.packed, b.pair_tri)
        code, gbuf = raster_row.raster_gbuffer_tiles_cuda(*args, v1=v1, **kw)
        if counted:
            print(f"{name}: " + reject_counts(cs, args, cs.screen_xy(clip, width, height), kw, ppt))
        out[key] = timer(lambda: raster_row.raster_gbuffer_tiles_cuda(*args, v1=v1, **kw))
        return torch.where(code >= 0, gbuf[..., -1], -torch.inf).contiguous()

    geom = pbr.flatten_scene_corners(grid)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    nm = grid.materials.num_materials
    case("k2", "kernel 2, phase h's full frame (8x128, C = 6)", clip, geom.attrs, geom.face_material, nm,
         cs.TRI_BINS, 4)
    gen = torch.Generator(device=dev).manual_seed(14)
    extra = torch.randn((geom.num_triangles, 3, 8), generator=gen, device=dev)
    case("k2_c14", "kernel 2, C = 14", clip, torch.cat([geom.attrs, extra], dim=-1), geom.face_material, nm,
         cs.TRI_BINS, 4, counted=False)

    pages = cs.seeded_texture_pages(5, cs.TEXTURE_SIZE, alpha=True)
    cache = cs.fill_asset_cache(pbr.scenes.AssetCache(texture_size=cs.TEXTURE_SIZE), pages)
    scene = pbr.scenes.pbr_scene(cache, texture_size=cs.TEXTURE_SIZE, device=dev)
    tcam = pbr.Camera.create(position=cs.CAMERA_POS, aspect=width / height, device=dev)
    geom = pbr.flatten_scene_corners(scene, textured=True)
    clip = math3d.transform_points_h(geom.pos_w, tcam.view_proj())
    bins = dict(binning_params(geom.num_triangles, width, height, row_layout=False), tile_h=16, tile_w=128)
    nm = scene.materials.num_materials
    floor = case("k4", "kernel 4, phase n's pbr_scene (16x128, C = 14)", clip, geom.attrs, geom.face_material, nm,
                 bins, 8, v1=True)
    case("k4_peel", "kernel 4, the alpha frame's peel behind it", clip, geom.attrs, geom.face_material, nm, bins,
         8, z_floor=floor, v1=True, counted=False)


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(__file__)))
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import physically_based_renderer_tpu_torch as pbr
    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import ibl, raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.renderer import binning_params
    from physically_based_renderer_tpu_torch.utils import cuda_build

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    logs = cuda_build.build_libraries(["raster_shade_row", "shade_backward"])
    for name, log in logs.items():  # only what this call built: a cached library prints nothing
        print(f"ptxas, {name}.cu: " + "; ".join(cs.ptxas_summary(log)))
    dev = torch.device("cuda:0")
    width, height = 1920, 1080
    scene = pbr.scenes.red_sphere_grid_scene(64, 32, device=dev)
    cam = pbr.Camera.create(position=(0.0, -3.0, -18.0), aspect=width / height, device=dev)
    mats, lights = scene.materials, scene.lights
    geom = pbr.flatten_scene_corners(scene)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    table = mats.props_table().contiguous()
    sh9 = ibl.IBLMaps.build(torch.as_tensor(cs.seeded_env(7, 256, 512), device=dev)).irradiance_sh9
    light_args = (lights.strength, lights.direction, lights.position, lights.spot_power, scene.ambient, cam.position)
    counts = dict(num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot)
    mat_stride = raster_row.material_stride(mats.num_materials, geom.num_triangles)
    lean_call = "want_attrs" in raster_pallas.shade_backward_cuda.__code__.co_varnames
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else "."}
    bins = {"1": (8, binning_params(geom.num_triangles, width, height)),
            "7": (4, dict(max_span=16, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None))}
    for name, (tile_h, params) in bins.items():
        b = raster_row.bin_for_shade(clip, geom.attrs, geom.face_material, width=width, height=height, rows=height,
                                     y_offset=0, tile_h=tile_h, tile_w=128, cull_backface=True, **params)
        tkw = dict(width=width, rows=height, y_offset=0, tile_h=tile_h, tile_w=128)
        every = ((b.starts.shape[0] - 1) * int(b.starts[0]) + int(b.starts[-1] - b.starts[0])) * tile_h * 128
        kept = cs.culled_tests(b.starts, b.packed, b.pair_tri, **tkw) if hasattr(cs, "culled_tests") else None
        in_box = (cs.raster_tests(b.starts, b.pair_tri, cs.screen_xy(clip, width, height), **tkw)
                  if hasattr(cs, "screen_xy") else None)
        stats = cs.run_stats(b.starts) if hasattr(cs, "run_stats") else f"{int(b.starts[-1])} pairs"
        print(f"kernel {name}'s binning ({tile_h}x128): {stats}; (pair, pixel) tests: {every} against every pixel "
              f"of the tile, {in_box} inside the triangle's pixel box, {kept} kept by the per-warp reject")
        for ibl_mode in (False, True):
            uni = pack_shading_uniforms(*light_args, sh9 if ibl_mode else None)
            kw = dict(tkw, mat_stride=mat_stride, apply_tonemap=not ibl_mode, ibl=ibl_mode, **counts)
            args = (b.starts, b.packed, b.pair_tri, table, uni)
            key = f"k{name}{'b' if ibl_mode else ''}"
            out[key] = device_ms(lambda: raster_row.raster_shade_tiles_cuda(
                *args, want_gbuf=False, v1=tile_h == 4, **kw))
            if name != "1":
                continue
            # the adjoint on this frame: the bench loss's cotangent, or a nonzero one on the 11 IBL channels
            code, chan, gbuf = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=True, **kw)
            hit = code >= 0
            _, mat_id = raster_row.decode_codes(code, mat_stride, geom.face_material)
            if ibl_mode:
                g = torch.where(hit[..., None], 1e-6 * chan, 0.0)
            else:
                g = torch.zeros_like(chan)
                g[..., :3] = torch.where(hit[..., None], 2.0 * chan[..., :3] / (3 * width * height), 0.0)
            bargs = (g, gbuf[..., :6], mat_id, hit, table, uni)
            bkw = dict(counts, apply_tonemap=not ibl_mode, ibl=ibl_mode)
            k3 = f"k3{'b' if ibl_mode else ''}"
            out[k3 + "_every_output"] = device_ms(lambda: raster_pallas.shade_backward_cuda(*bargs, **bkw))
            if lean_call:
                out[k3 + "_no_per_pixel_output"] = device_ms(lambda: raster_pallas.shade_backward_cuda(
                    *bargs, want_attrs=False, want_props=False, **bkw))
    ids_kernels(cs, pbr, scene, cam, dev, width, height, out)
    gbuffer_kernels(cs, pbr, scene, cam, dev, width, height, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
