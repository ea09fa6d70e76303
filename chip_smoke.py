#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of JAX.
It builds ``physically_based_renderer_tpu_torch/csrc/raster_shade_row.cu``,
``csrc/shade_backward.cu`` and ``csrc/shade_forward.cu`` into
``build/kernels/`` (one nvcc each, in parallel), then on the 1920×1080
frame of the 7×7 sphere grid
(``red_sphere_grid_scene(64, 32)``, 194,432 triangles, the ``bench.py``
camera):

  1. prints the binning's run lengths and its (pair, pixel) tests: against
     every pixel of the tile, inside each triangle's pixel box (what the
     bound counts), and kept by the kernel's per-warp reject; holds the
     kernel against its plain PyTorch version on the card at the main path's
     shapes (codes exact, RGBA within 2e-4, G-buffer within 1e-4, no binning
     overflow) and times both;
  2. times the frame's stages (setup+bin, kernel, compose) with CUDA events;
  3. renders 5 frames through ``render(...)`` and checks that each launched
     the kernel once; writes ``build/chip_smoke_grid.png``;
  4. checks a small frame against the CPU render (the plain version, which the
     CPU tests hold against the JAX package);
  5. holds the backward kernel against its plain version on the phase-1
     frame with the bench loss's cotangent (g_attrs/g_props within rtol 1e-3
     and 1e-6·max|value|, g_uni within rtol 1e-3, the material-table
     cotangent within what those imply summed over each material), checks
     that g_uni and the table are the same bits on two launches and without
     the per-pixel outputs (the material step's call), and times that call,
     the call with every output, the plain version and the plain material
     scatter;
  6. runs 5 forward+backward steps of the bench loss (material gradients)
     through ``render``: each launches each kernel once, skips the geometry
     recompute, and gives finite gradients, the same bits every step; prints
     the step time;
  7. runs 5 ``make_train_step`` steps from a perturbed grid toward the
     original's render: the loss must fall;
  8. checks render gradients on the card (materials, light strength, eye,
     world matrices) against the CPU on a small frame.

Then the same grid under image-based lighting: a seeded 256×512 HDR
environment (a sky gradient and two sun lobes up to ~50), its IBL maps and a
seeded 1536×3072 u8 LDR background, which switch ``render`` to the fused IBL
path (both kernels' IBL modes, then the env gather):

  a. builds the IBL maps on the card, times the build, holds them against
     the CPU build;
  b. holds the forward kernel's IBL mode against its plain version at 1080p
     (codes exact, the 11 HDR channels within 2e-4 + 1e-4·|value|, G-buffer
     within 1e-4, no overflow) and times both;
  c. holds the adjoint's IBL mode against its plain version with the
     cotangent autograd gives through the env-gather epilogue (the bench loss
     over all four image channels, so every one of the 11 is nonzero): as
     phase 5, the 27 SH9 slots of g_uni included; same bits on two launches
     and without the per-pixel outputs; times both calls and the plain
     version;
  d. renders 5 IBL frames through ``render``: one IBL forward launch each,
     no adjoint; writes ``build/chip_smoke_grid_ibl.png``;
  e. runs 5 bench steps on the IBL frame: one launch of each IBL kernel a
     step, the same material-gradient bits every step;
  f. one step with the gradient to the environment map through the map
     build: finite, nonzero; its time and peak memory; whether two runs give
     the same bits;
  g. a 128×64 IBL frame on the card against the CPU: the image, and the
     gradients to materials, the specular stack, the SH9 coefficients and
     the environment map.

Then the sharded paths (``parallel/sharded.py``), on the grid again, in a
world-1 NCCL process group (a ``FileStore`` under ``build/``):

  h. holds the G-buffer mode of the row kernel (``csrc/raster_shade_row.cu``,
     kernel 2) against its plain version at 1080p with the triangle-sharded
     ring's binning (8-row tiles, max span 16): the full frame over all
     triangles; a 270-row band at y_offset 540 (it ends in a partial tile)
     over the first quarter of the triangles, zero-padded; the C = 14
     instantiation on seeded 14-channel attributes; and a depth peel behind
     the first layer's depth (no back-face culling, so the second layer is
     the spheres' back faces). Codes exact, G-buffer within phase 1's 1e-4;
     times both; prints the full frame's (pair, pixel) tests (against every
     pixel, inside each triangle's box, kept by the per-warp reject at 16×8
     warp blocks, with their shares), each tile's busiest warp, and the
     ptxas lines of ``raster_gbuffer_row_kernel<4,7>`` and ``<4,15>``;
  i. holds the G-buffer shading kernel (``csrc/shade_forward.cu``, kernel 6)
     against its plain version on phase h's full-frame G-buffer, in the shade
     mode and the IBL mode (a seeded SH9); times both;
  j. runs 5 bench steps through ``render_tri_sharded`` (material gradients):
     each launches kernels 2, 6 and 3 once, and the gradients are the same
     bits every step;
  k. measures ``bench.py``'s three overhead ratios at 1080p, each the ratio
     of two medians of 20 runs after a warm-up, the two sides interleaved run
     by run, with the quartiles of the run-by-run ratios as their spread:
     ``render_sharded`` over ``render``, ``make_train_step`` in the group
     over the plain step, ``render_tri_sharded`` over ``render``; and
     ``render`` alone before the group is made;
  l. a 128×64 frame on the card against the CPU through ``render_sharded``
     and ``render_tri_sharded``: the images and the material gradients.

Then the textured deferred path (phases m-r, ``textured_phases``: n holds
kernel 4 against its plain version and prints its (pair, pixel) tests at
16×16 warp blocks, each tile's busiest warp and the ptxas line of
``raster_gbuffer_row_kernel<8,15>``; r's alpha frame launches it twice on
n's binning), and the
peel-based render modes and the v1 fused raster+shade on the grid at 1080p
(``render_mode_phases``; the layer mix — rows 0-1 of the sweep transparent
at seeded opacities in [0.3, 0.7], row 2 alpha-tested at 0.05 — is
``layer_mix_fields``):

  s. holds kernel 5, the ids mode of ``csrc/raster_shade_row.cu`` (exact
     depth, 16×128 tiles), against its plain version: the first solid peel
     (``tri_mask``, culled, a −inf floor), the transparent faces behind its
     depth (no culling) and the material codes; codes exact, depth within
     1e-6 (+inf at background); times both; prints pairs, the jumbo run,
     the tests the per-warp reject keeps (and their share of every test
     and of the tests inside each triangle's box), each tile's busiest warp
     and the kernel's ptxas report;
  t. 5 ``render_layered`` 2+2 frames (four kernel-5 launches each; PNG in
     ``build/chip_smoke_layered.png``), the pixels a transparent blend and
     the alpha peel-through change, and a 128×64 frame and its material
     gradients on the card against the CPU;
  u. 3 textured layered frames (phase m's ``pbr_scene``: material 0
     alpha-tested through a seeded opacity page, material 1 transparent);
  v. 3 ``render_wireframe`` frames (one kernel-5 launch each) and 3
     ``render_ssaa(factor=2)`` frames (a 3840×2160 ``render``: kernel 1 at
     the scaled pair cap and spans, no overflow);
  w. holds kernel 7 / 7b — the shade mode at ``raster_shade``'s JAX
     defaults (the v1 binning at 4×128 tiles) — against its plain version
     with and without IBL (a seeded SH9), counts the pixels whose id
     differs from kernel 1's (each a quantized-depth tie), and runs 5 (IBL:
     3) bench steps through ``raster_shade[_ibl](row_layout=False)``: one
     kernel-7 and one kernel-3 launch a step, the same gradient bits.

Then the soft rasterizer and the app on the grid (``soft_phases``):

  x. holds kernel 5b — the ids mode's dilated edge test, e ≥ −3 px on
     unit-gradient edges (``render_soft``'s margin at σ = 1) — against its
     plain version on the three peels of ``render_soft`` (culled, each
     behind the last): codes exact, depth bit-equal; prints the pairs with
     and without the margin and the tests the per-warp reject keeps (their
     share of every test and of the tests inside each dilated triangle's
     box, and each tile's busiest warp), and times both;
  y. 5 ``render_soft`` frames (K 3, σ 1, γ 1e-2): per frame three kernel-5b
     and three kernel-6 launches, kernel 1 never; PNG in
     ``build/chip_smoke_soft.png``; the 128×64 peels and frame card vs CPU;
  z. 5 geometry steps (mean(img²) back to the world matrices and the bank):
     three launches each of kernels 5b, 6 and 3 a step; step time, peak
     memory, whether the gradient bits repeat; 128×64 gradients card vs CPU;
  aa. ``render_checked`` refuses a 128-pair cap and renders with
     ``check_raster_capacity``'s suggestion; ``RenderLoop`` heals the same
     cap on its first frame, then renders 10 ``turntable_inputs`` frames.

Then ``render``'s routes, the indexed input and the geometry layer
(``route_phases``):

  ab. each kernel route of ``render(raster_backend=)`` at 1080p — kernels 1,
      7, 4, 2 and 5 on the grid, 1b and 7b on it under the seeded IBL maps —
      for 5 frames: each frame's device time (``frame_device_ms``), exactly
      the route's kernel once a frame, ``pallas_shade_row`` (and its IBL
      mode) bit-equal to ``"auto"``, the ids of the route's own raster in
      that ``render`` call against kernel 1's (quantized-depth ties only),
      that call's kernel launch against its plain version on the inputs the
      route gave it (``recording``; kernel 2's 4-row tiles are the
      ``<2, 7>`` instantiation, whose ptxas line it prints), and its frame
      within the CPU test's tolerance of ``"auto"``'s; PNGs of the
      ``pallas`` and ``pallas_gbuf`` routes;
  ac. kernels 5 (a solid peel, a z-floor peel behind it), 5b (3 px) and 4
      (C = 6 on the grid, C = 14 on ``pbr_scene``) on ``flatten_scene``'s
      indexed geometry, bit-equal to the corner-major ``clip[tris]``, each
      launch against its plain version; ``flatten_scene`` card vs CPU;
  ad. the oracles ``raster.rasterize`` and ``rasterize_brute`` on the card
      at 320×180 against kernel 5 (ties counted), ``render``'s ``"jnp"`` and
      ``"brute"`` routes, and a scene lowered by ``scene_graph.lower`` from a
      graph of every mesh builder and a point and a spot light, rendered at
      1080p (``build/chip_smoke_scene_graph.png``).

Then the asset readers and an OBJ scene (``reader_phases``; no asset tree
is needed: the phases write their own OBJ, MTL, PNG, TGA, BMP and Radiance
files and read the committed JPEG fixtures of ``tests/data/``, made with PIL
by ``tests/data/make_jpeg_fixtures.py``):

  ae. writes the grid (its 49 spheres at 64×32, 194,432 triangles) as one
      OBJ with v/vt/vn, quads where the bands allow and 5 ``usemtl`` groups,
      and its MTL (Kd/Ks/Ns/d/Ke/Pr/Pm; map_Kd the colour and gray JPEG
      fixtures, map_Pr / map_Pm / map_bump 1024² PNGs written by
      ``save_png``); parses it with the native parser (``native/objparse.cpp``
      built by g++ into ``build/native/``) and the Python one, bit-equal,
      with both host times; decodes each JPEG fixture (1024² 4:2:0, 1024²
      gray, 3072×1536 4:2:0), its time, and holds its samples' SHA-256 against
      PIL's (``tests/data/manifest.json``);
  af. ``obj_scene`` of that OBJ at a 512 atlas, rendered at 1080p through
      ``render`` on each route it takes — kernel 4 (C = 14) on the per-slot
      atlas, on the quad and on the packed combined pages, and kernel 1 with
      the maps stripped (a map-less MTL beside the same OBJ) — 5 frames each:
      device time a frame (``frame_device_ms``), the route's kernel once a
      frame, and the route's own launch in its ``render`` call
      (``recording``) against its plain version on the same inputs (codes
      exact; G-buffer 1e-4, depth 1e-6; RGBA 2e-4); the packed frame against
      the f32 combined frame under the JAX package's bounds (99.5th
      percentile of the per-pixel max |Δ| < 0.02, mean < 1e-3, < 0.2% of
      pixels past 0.05); two bench-loss material-gradient steps on the quad
      pages, the same bits;
  ag. the OBJ scene at 128×64, card vs CPU, under the textured frames'
      pixel-fraction bounds; an ``AssetCache`` over a temporary tree laid out
      like the reference's Assets (PNG pages, rustediron's maps the JPEG
      fixtures, a Chelsea_Stairs sIBL set with the ``_3k`` fixture and a
      ``save_hdr`` environment) driving ``pbr_scene`` and
      ``rustediron_sphere_scene(environment="chelsea_stairs")`` (its u8 sky's
      SHA-256 = the fixture's), one 1080p frame each;
  ah. the image kinds past PNG and baseline JPEG (``format_phase``): the
      committed progressive twins of the two 1024² pages decode to their
      baseline twins' digests (host time beside the twin's), the 512² CMYK
      fixture to its own; the decoded colour page written as TGA (raw and
      RLE, bottom-up and top-down) and BMP (24-bit bottom-up, 32-bit
      BI_BITFIELDS top-down) by ``write_tga`` / ``write_bmp`` decodes back
      bit-equal; ae's OBJ with material 0's map_Kd the progressive twin,
      map_Pr a TGA and map_Pm a BMP of ae's PNG pages (material 1's map_Kd
      the gray twin) gives af's atlas and quad pages bit for bit, and 5
      frames at 1080p through ``render``: kernel 4 once a frame, its launch
      against its plain version (codes exact, G-buffer bit-equal), the frame
      bit-equal to af's quad frame, the device time a frame.

Every phase is a plain assertion; any failure exits non-zero. The last two
lines are a JSON summary of the kernels (each mode of each; its launches on
its own main path, phase 6, e, j, o, t, w or y; its time in that path's
call beside the least time the H100 could take for the same work,
``bound_ms``, counted from what these inputs need: a raster's tests inside
each triangle's pixel box, the adjoint's hit pixels and the outputs it
writes) and ``{"ok": true, "device": …}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

WIDTH, HEIGHT = 1920, 1080
DEVICE = "cuda:0"
CAMERA_POS = (0.0, -3.0, -18.0)
RGBA_ATOL = 2e-4  # f32 shading, same expressions; sqrt/div/pow rounding only
GBUF_ATOL = 1e-4  # world positions ~10: a few f32 ulps
SMALL_ATOL = 2e-4  # card vs CPU on the small frame (the JAX parity tolerance)
BWD_RTOL = 1e-3  # adjoint kernel vs autograd on the same inputs: f32 op order only
BWD_ATOL_FRAC = 1e-6  # absolute floor, as a share of the largest |value|; for g_uni it
# covers slots that cancel over the frame (the eye's x: the grid is mirror-symmetric)
TABLE_SUM_RTOL = 1e-5  # f32 sums in a fixed tree order, as a share of the sum of |terms|
GRAD_RTOL, GRAD_ATOL_FRAC = 2e-3, 5e-5  # card vs CPU gradients (the JAX suite's tolerance)
TRAIN_LR = 100.0  # SGD rate at which 5 steps lower the grid's loss (CPU rehearsal at 192×108)
IBL_ATOL, IBL_RTOL = 2e-4, 1e-4  # the IBL mode's HDR channels, kernel vs plain (up to ~1e3 at sun-lit highlights)
MAPS_RTOL, MAPS_ATOL_FRAC = 1e-4, 1e-5  # IBL maps, card vs CPU: f32 quadrature sums in another order
ENV_GRAD_ATOL_FRAC = 1e-4  # env-map gradients, card vs CPU (tests/test_raster_shade_ibl.py's)
IBL_IMAGE_ATOL = 5e-4  # the IBL frame, card vs CPU (tests/test_raster_shade_ibl.py's)
DEPTH_ATOL = 1e-6  # the G-buffer mode's NDC depth, kernel vs plain: the same plane, unfused
TRI_BINS = dict(tile_h=8, tile_w=128, max_span=16, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)
RATIO_RUNS = 10  # runs per side per turn of phase k (two turns a side)
TEXTURE_SIZE = 512  # the seeded texture pages of phases m-r (bench.py's pbr configs)
SOFT_SIGMA = 1.0  # render_soft's default: the peels' edge margin is 3·sigma
SOFT_LAYERS = 3  # render_soft's default K
SPIN_CYCLES_PER_S = 2e9  # cycles of torch.cuda._sleep a second, at most (the H100's boost clock is 1.98 GHz)

# The least time the card could take for a kernel's work (the H100 SXM's
# published figures, at the 700 W limit): the
# larger of the bytes it must move (each input read once, each output
# written once) over the HBM rate and its FP32 operations over the FP32 rate.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# FP32 operations (multiplies, adds, subtracts, divides, square roots,
# powers; not compares), counted from the CUDA sources: a (pair, pixel)
# depth test of the raster loop (two offsets, three edge planes and the
# depth plane at four each).
RASTER_TEST_FLOPS = 18


def shade_flops(num_dir: int, num_point: int, num_spot: int, tonemap: bool, ibl: bool) -> int:
    """FP32 operations of one ``shade_core::shade`` call (csrc/shade_core.cuh):
    51 before the lights, 95 a directional light (+15 point, +22 spot), the
    ambient term and tonemap 15 (6 without), the IBL tail 162 instead."""
    lights = 95 * num_dir + 110 * num_point + 117 * num_spot
    return 51 + lights + (162 if ibl else 15 if tonemap else 6)


def plane_flops(num_ch: int, depth: bool) -> int:
    """FP32 operations of a winner's epilogue: the pixel offset, num_ch
    planes, the perspective divides (and the depth plane)."""
    return 2 + 4 * num_ch + (num_ch - 1) + (4 if depth else 0)


def screen_xy(clip: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(T, 3, 2) pixel coordinates of the triangles' corners, as the
    binning sees them."""
    from physically_based_renderer_tpu_torch.ops.raster import setup_corners

    return setup_corners(clip, width, height, False).xy


def _pixel_span(lo, hi, first, end):
    """Integer pixels i in [first, end) whose centre i + 0.5 lies in [lo, hi]."""
    a = torch.maximum(torch.ceil(lo - 0.5), first)
    b = torch.minimum(torch.floor(hi - 0.5), end - 1)
    return (b - a + 1).clamp(min=0)


def dilated_corners(xy: torch.Tensor, margin: float) -> torch.Tensor:
    """(T, 3, 2) float64 corners of the region e_i ≥ −margin that the
    dilated test covers on unit-gradient edges: each edge line moved out by
    ``margin``, which is the triangle homothetic to ``xy`` about its incentre
    at the ratio (r + margin) / r, r its inradius. A sliver's corners lie
    far outside its box grown by the margin; a degenerate triangle's are
    not finite."""
    p = xy.double()
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    la, lb, lc = (b - c).norm(dim=-1), (c - a).norm(dim=-1), (a - b).norm(dim=-1)
    per = la + lb + lc
    incentre = (la[:, None] * a + lb[:, None] * b + lc[:, None] * c) / per[:, None]
    d1, d2 = b - a, c - a
    r = (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]).abs() / per
    scale = (1.0 + margin / r)[:, None, None]
    return incentre[:, None] + (p - incentre[:, None]) * scale


def raster_tests(starts, pair_tri, xy, *, width: int, rows: int, y_offset: int, tile_h: int, tile_w: int,
                 margin: float = 0.0, **_) -> int:
    """(pair, pixel) depth tests these inputs need: for each pair of a
    tile's run, the pixels of its tile (within the band) whose centres lie
    in its triangle's screen box; for a jumbo pair, every such pixel of the
    band. At ``margin`` > 0 (the dilated test, unit-gradient edges) the box
    is that of the dilated triangle (``dilated_corners``), whose corners a
    sliver pushes far past its box grown by the margin. No pixel outside
    that box can be covered, so no other test is needed."""
    corners = dilated_corners(xy, margin) if margin > 0 else xy.double()
    lo, hi = corners.amin(1), corners.amax(1)  # (T, 2)
    lo, hi = torch.where(lo.isnan(), -torch.inf, lo), torch.where(hi.isnan(), torch.inf, hi)
    st = starts.long()
    g, end = int(st[0]), int(st[-1])
    tiles_x = -(-width // tile_w)
    own_tile = torch.repeat_interleave(torch.arange(st.shape[0] - 1, device=st.device), st[1:] - st[:-1])
    t = pair_tri[g:end].long()
    x0 = (own_tile % tiles_x * tile_w).double()
    r0 = (own_tile // tiles_x * tile_h).double()
    nx = _pixel_span(lo[t, 0], hi[t, 0], x0, (x0 + tile_w).clamp(max=width))
    ny = _pixel_span(lo[t, 1] - y_offset, hi[t, 1] - y_offset, r0, (r0 + tile_h).clamp(max=rows))
    tj = pair_tri[:g].long()
    zero = torch.zeros((), dtype=torch.float64, device=st.device)
    jumbo = (_pixel_span(lo[tj, 0], hi[tj, 0], zero, zero + width)
             * _pixel_span(lo[tj, 1] - y_offset, hi[tj, 1] - y_offset, zero, zero + rows))
    return int((nx * ny).sum() + jumbo.sum())


def run_stats(starts: torch.Tensor) -> str:
    """Tiles, empty tiles, mean / p99 / max pairs a tile's run, and the
    jumbo run, of a binning."""
    n = (starts[1:] - starts[:-1]).double()
    return (f"{n.numel()} tiles, {int((n == 0).sum())} empty, pairs a tile mean {float(n.mean()):.1f} "
            f"p99 {float(torch.quantile(n, 0.99)):.0f} max {int(n.max())}, jumbo {int(starts[0])}")


def warp_boxes(*, width: int, rows: int, y_offset: int, tile_h: int, tile_w: int, ppt: int | None = None,
               device="cpu", **_):
    """The culled resolve's pixel map (``raster_row.warp_pixels(tile_h,
    tile_w, ppt)``; the ids mode runs PPT 8) over every tile: ``box``, each
    warp's box of pixel centres in the image as [x_lo, x_hi, y_lo, y_hi]
    ((tiles, 8) each, ±inf where it holds none), and each slot's image row,
    column and whether it lies in the image ((tiles, 8, S) each)."""
    from physically_based_renderer_tpu_torch.ops import raster_row

    tiles_x, tiles_y = -(-width // tile_w), -(-rows // tile_h)
    wp = raster_row.warp_pixels(tile_h, tile_w, ppt).to(device)  # (8, S, 2)
    tile = torch.arange(tiles_x * tiles_y, device=device)
    row = (tile // tiles_x * tile_h)[:, None, None] + wp[None, ..., 0]  # (tiles, 8, S)
    col = (tile % tiles_x * tile_w)[:, None, None] + wp[None, ..., 1]
    ok = (wp[None, ..., 0] >= 0) & (row < rows) & (col < width)
    cx, cy = col.float() + 0.5, (row + y_offset).float() + 0.5
    inf = torch.tensor(float("inf"), device=device)
    box = [torch.where(ok, cx, inf).amin(-1), torch.where(ok, cx, -inf).amax(-1),
           torch.where(ok, cy, inf).amin(-1), torch.where(ok, cy, -inf).amax(-1)]
    return box, row, col, ok


def warp_kept_pairs(starts, packed, pair_tri, *, margin: float = 0.0, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """(kept, pixels), (tiles, 8) int64 each: for each warp of each tile
    (``warp_boxes``), the pairs of the jumbo run and the tile's run that the
    culled resolve's per-warp reject (``raster_row.footprint_rejects`` at
    ``margin``) keeps, and the warp's pixels in the image."""
    from physically_based_renderer_tpu_torch.ops import raster_row

    box, _, _, ok = warp_boxes(device=packed.device, **kw)
    tile = torch.arange(ok.shape[0], device=packed.device)
    st = starts.long()
    g, end = int(st[0]), int(st[-1])

    def kept(fields, tiles):  # (P, 8): the warps that keep each pair
        return ~raster_row.footprint_rejects(fields[:, None, :], *(b[tiles] for b in box), margin=margin)

    own_tile = torch.repeat_interleave(tile, st[1:] - st[:-1])
    out = torch.zeros(ok.shape[:2], dtype=torch.int64, device=packed.device)
    out.index_add_(0, own_tile, kept(packed[g:end, :11], own_tile).long())
    for j in range(g):  # the jumbo run, against every tile
        out += kept(packed[j : j + 1, :11].expand(tile.shape[0], 11), tile).long()
    return out, ok.sum(-1)


def culled_tests(starts, packed, pair_tri, **kw) -> int:
    """(pair, pixel) tests the culled resolve runs after its per-warp
    reject: each (pair, warp) that ``warp_kept_pairs`` keeps tests the
    warp's pixels in the image."""
    kept, pixels = warp_kept_pairs(starts, packed, pair_tri, **kw)
    return int((kept * pixels).sum())


def reject_share(args, xy, kw, ppt: int = 8, ctas_per_sm: int = 2) -> str:
    """The culled resolve's (pair, pixel) tests on one binning (``args`` =
    starts, packed, pair_tri; ``xy`` the triangles' ``screen_xy``; ``kw``
    its call's keywords, ``margin`` among them for the ids mode) at the
    pixel map of ``ppt`` (the ids mode and kernel 4 run PPT 8, kernel 2 PPT
    4): against every pixel of the tile, inside each (dilated) triangle's
    box, and kept by the per-warp reject, with the kept tests' shares; and
    the pairs each tile's busiest warp keeps, the largest of them against
    their balanced share of the card's CTA slots (132 SMs, ``ctas_per_sm``
    CTAs each): a tile's busiest warp sets its CTA's pace."""
    starts, pair_tri = args[0], args[2]
    every = ((starts.shape[0] - 1) * int(starts[0]) + int(starts[-1] - starts[0])) * kw["tile_h"] * kw["tile_w"]
    in_box = raster_tests(starts, pair_tri, xy, **kw)
    kept_pairs, pixels = warp_kept_pairs(*args, ppt=ppt, **kw)
    kept = int((kept_pairs * pixels).sum())
    busiest = kept_pairs.amax(1)
    return (f"{every} against every pixel, {in_box} ({in_box / every:.2%}) inside the (dilated) triangle's box, "
            f"{kept} kept by the per-warp reject at PPT {ppt} ({kept / every:.2%} of every test, "
            f"{kept / max(in_box, 1):.2f}x the in-box ones); each tile's busiest warp keeps {int(busiest.max())} "
            f"pairs at most, {float(busiest.sum()) / (132 * ctas_per_sm):.0f} a CTA slot if balanced "
            f"({ctas_per_sm} CTAs an SM)")


def ptxas_summary(log: str) -> list[str]:
    """'kernel<template args>: N registers, S B spill stores' for each entry
    function of an nvcc -Xptxas=-v log."""

    def demangle(sym: str) -> str:  # _ZN <len><id>... [I L<type><value>E ... E] E
        i, ids = 3, []
        while i < len(sym) and sym[i].isdigit():
            n = re.match(r"\d+", sym[i:]).group()
            ids.append(sym[i + len(n) : i + len(n) + int(n)])
            i += len(n) + int(n)
        args = re.findall(r"L[a-z](\d+)E", sym[i:]) if sym[i : i + 1] == "I" else []
        return ids[-1] + (f"<{','.join(args)}>" if args else "")

    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_ZN\w+)'", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores")
            name = None
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def raster_read_bytes(starts, packed, pair_tri, *, num_ch: int, width: int, rows: int, y_offset: int,
                      tile_h: int, tile_w: int, z_floor=None, exact: bool = False, margin: float = 0.0, **_) -> int:
    """Bytes a raster kernel must read for this run's binning, each once: the
    tile starts; the RASTER_FIELDS depth-test fields and the triangle id of
    each real pair (``packed`` and ``pair_tri`` are padded to the pair cap,
    and no losing pair's other fields are needed); the z floor when given;
    and the material field and num_ch interpolation planes (3 floats each)
    of each distinct winning pair, found by the plain version's resolve
    (on the exact depth with ``exact``, as the ids mode resolves; with the
    dilated edge test at ``margin`` > 0)."""
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.ops.raster_bin import RASTER_FIELDS

    res = raster_row._resolve_plain(starts, packed, pair_tri, width=width, rows=rows, y_offset=y_offset,
                                    tile_h=tile_h, tile_w=tile_w, z_floor=z_floor, exact=exact, margin=margin)
    winners = int(res.pair.unique().numel())
    floor = 0 if z_floor is None else nbytes(z_floor)
    return nbytes(starts) + floor + 4 * (int(starts[-1]) * (RASTER_FIELDS + 1) + winners * (1 + 3 * num_ch))


def adjoint_bytes(g_chan, attrs, mat_id, hit, table, uni, outs) -> int:
    """Bytes the adjoint must move for these inputs: the hit mask; the
    cotangent, the attributes and the material id of each hit pixel (it
    reads nothing else of a background pixel); the table and the uniform
    row; and each output the call writes (None: not asked for)."""
    hits = int(hit.sum())
    per_hit = (g_chan.shape[-1] + attrs.shape[-1]) * g_chan.element_size() + mat_id.element_size()
    return nbytes(hit, table, uni) + hits * per_hit + nbytes(*(t for t in outs if t is not None))


def bound(moved_bytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the work, and which
    of the two sets it."""
    t_bytes = moved_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd) -> dict:
    """One kernel of the summary line. No single PyTorch call computes any
    of these functions (a tile raster with a quantized depth resolve, or a
    Cook-Torrance shade and its adjoint), so ``library_ms`` is null."""
    return {"name": name, "route": "cuda", "source": f"physically_based_renderer_tpu_torch/csrc/{source}",
            "replaces": f"physically_based_renderer_tpu/{replaces}", "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


def seeded_env(seed: int, height: int, width: int):
    """An HDR equirect (H, W, 3) f32, the sIBL ``_Env.hdr`` convention: a
    smooth sky gradient plus two bright sun lobes (values up to ~50)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    theta, phi = 2 * np.pi * uu, np.pi * (0.5 - vv)
    d = np.stack([np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta)], -1)
    env = np.stack([0.3 + 0.7 * (1 - vv), 0.4 + 0.5 * (1 - vv), 0.6 + 0.6 * (1 - vv)], -1)
    for _ in range(2):
        s = rng.normal(size=3)
        s /= np.linalg.norm(s)
        s[1] = abs(s[1])
        lobe = np.maximum(d @ s, 0.0) ** rng.uniform(20, 60)
        env = env + rng.uniform(30, 50) * lobe[..., None] * rng.uniform(0.7, 1.0, 3)
    return env.astype(np.float32)


def seeded_background(seed: int, height: int, width: int):
    """An LDR equirect background (H, W, 3) in [0, 1]: a horizon gradient
    with texel noise, to be quantised to u8 like an sIBL ``_3k`` JPEG."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vv = ((np.arange(height) + 0.5) / height)[:, None, None]
    base = np.concatenate([0.35 + 0.5 * (1 - vv), 0.45 + 0.4 * (1 - vv), 0.55 + 0.4 * (1 - vv)], -1)
    return np.clip(base + rng.uniform(-0.08, 0.08, (height, width, 3)), 0.0, 1.0).astype(np.float32)


def _seeded_field(rng, size: int, channels: int):
    """(size, size, channels) smooth fields in about [−1, 1]: three random
    sinusoids a channel at integer frequencies 1-4 (so the field tiles, as
    the wrap sampler expects, and its mip levels keep structure)."""
    import numpy as np

    yy, xx = (np.mgrid[0:size, 0:size] + 0.5) / size
    out = np.zeros((size, size, channels))
    for c in range(channels):
        for _ in range(3):
            kx, ky = rng.integers(1, 5, 2)
            out[..., c] += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (kx * xx + ky * yy) + rng.uniform(0, 2 * np.pi))
    return out / 3.0


def seeded_texture_pages(seed: int, size: int, alpha: bool = False) -> dict:
    """Texture pages from a seed, in place of the absent asset files: one
    (size, size, 3) uint8 image (quantised as a decoded JPEG is) for each
    (set, slot) the textured spheres of ``scenes.TEXTURED_SPHERES`` bind, in
    that order. Colour and scalar maps are smooth fields in [0.1, 0.9];
    normal maps decode (2·v − 1) to unit vectors within ~17° of +z. With
    ``alpha``, one more page, ("rusted_iron", "opacity"): bands of opacity 0
    and 1 with smooth edges, for the alpha test."""
    import numpy as np

    from physically_based_renderer_tpu_torch.scenes import TEXTURED_SPHERES

    rng = np.random.default_rng(seed)
    keys = [(set_name, slot) for set_name, slots, _ in TEXTURED_SPHERES.values() for slot in slots]
    return {key: seeded_page(rng, size, key[1]) for key in keys + ([("rusted_iron", "opacity")] if alpha else [])}


def seeded_page(rng, size: int, slot: str):
    """One (size, size, 3) uint8 page of ``seeded_texture_pages`` for
    ``slot``, drawn from ``rng``."""
    import numpy as np

    field = _seeded_field(rng, size, 3)
    if slot == "normal":
        v = np.concatenate([0.3 * field[..., :2], np.ones_like(field[..., :1])], axis=-1)
        img = 0.5 + 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    elif slot == "opacity":
        img = np.repeat(np.clip(0.5 + 4.0 * field[..., :1], 0.0, 1.0), 3, axis=-1)
    else:
        img = 0.5 + 0.4 * field
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def fill_asset_cache(cache, pages: dict):
    """Pre-populate an ``AssetCache`` (the port's or the JAX package's) with
    ``pages`` as its decoded images, as ``obj_scene`` does; returns it."""
    for (set_name, slot), img in pages.items():
        cache._page_index[f"{set_name}/{slot}"] = len(cache.pages)
        cache.pages.append(img)
        cache.srgb.append(slot in ("diffuse", "specular"))
    return cache


def alpha_test_fields(materials, cache, index: int = 0) -> dict:
    """The bank fields (NumPy) that make material ``index`` of ``materials``
    (either package's bank) alpha-tested through the cache's ("rusted_iron",
    "opacity") page: ``has_tex``, ``tex_index`` and ``alpha_test``."""
    import numpy as np

    slot = 11  # SLOT_OPACITY
    has = np.array(materials.has_tex.cpu() if hasattr(materials.has_tex, "cpu") else materials.has_tex)
    tex = np.array(materials.tex_index.cpu() if hasattr(materials.tex_index, "cpu") else materials.tex_index)
    at = np.array(materials.alpha_test.cpu() if hasattr(materials.alpha_test, "cpu") else materials.alpha_test)
    has[index, slot], tex[index, slot], at[index] = 1.0, cache._page_index["rusted_iron/opacity"], 1.0
    return dict(has_tex=has, tex_index=tex, alpha_test=at)


def layer_mix_fields(materials, seed: int) -> dict:
    """The bank fields (NumPy) of the layered frames' layer mix on the 7×7
    sweep (material i is row i // 7 of ``red_sphere_grid_scene``): rows 0-1
    transparent, their opacity drawn from the seed in [0.3, 0.7]; row 2
    alpha-tested at opacity 0.05 (killed, so it peels through); the rest
    opaque."""
    import numpy as np

    rng = np.random.default_rng(seed)
    get = lambda k: getattr(materials, k).detach().cpu().numpy().copy()  # noqa: E731
    transparent, opacity, alpha_test = get("transparent"), get("opacity"), get("alpha_test")
    row = np.arange(opacity.shape[0]) // 7
    transparent[row <= 1] = 1.0
    opacity[row <= 1] = rng.uniform(0.3, 0.7, int((row <= 1).sum()))
    alpha_test[row == 2], opacity[row == 2] = 1.0, 0.05
    return dict(transparent=transparent, opacity=opacity, alpha_test=alpha_test)


def with_fields(scene, fields: dict, device, **static):
    """``scene`` with the material bank fields ``fields`` (NumPy) on ``device``."""
    mats = dataclasses.replace(scene.materials, **static,
                               **{k: torch.as_tensor(v, device=device) for k, v in fields.items()})
    return dataclasses.replace(scene, materials=mats)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device milliseconds of one ``fn()`` on the current stream: CUDA events
    around ``iters`` calls queued back to back, divided by ``iters``. The
    stream first spins (``torch.cuda._sleep``) for longer than the host takes
    to enqueue the calls, so the device never waits for the host inside the
    window: timed one call at a time, a kernel shorter than its wrapper's
    host work reads as that host work plus the kernel. A ``fn`` that
    synchronises inside is timed with its host work, as before."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(SPIN_CYCLES_PER_S * (1.5 * host_s * iters + 1e-3), SPIN_CYCLES_PER_S)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol_frac: float, name: str) -> float:
    """Assert |got − ref| ≤ atol_frac·max|ref| + rtol·|ref|; return the max abs error."""
    ref = ref.to(got.device, got.dtype)
    err = (got - ref).abs()
    bound = atol_frac * float(ref.abs().max()) + rtol * ref.abs()
    worst = float((err - bound).max()) if err.numel() else 0.0
    assert worst <= 0.0, f"{name}: max abs err {float(err.max()):.3e} exceeds its bound by {worst:.3e}"
    return float(err.max()) if err.numel() else 0.0


def bench_loss_grads(pbr, scene, cam, width, height, fields, render=None):
    """Gradients of mean(render[..., :3]²) w.r.t. ``fields`` (names of
    material fields, or "strength", "eye", "worlds"); ``render`` defaults to
    ``pbr.render``."""
    mats = {k: getattr(scene.materials, k).detach().clone().requires_grad_()
            for k in fields if hasattr(scene.materials, k)}
    leaves = dict(mats)
    lights, cam_ = scene.lights, cam
    draws = scene.draws
    if "strength" in fields:
        leaves["strength"] = lights.strength.detach().clone().requires_grad_()
        lights = dataclasses.replace(lights, strength=leaves["strength"])
    if "eye" in fields:
        leaves["eye"] = cam.position.detach().clone().requires_grad_()
        cam_ = dataclasses.replace(cam, position=leaves["eye"])
    if "worlds" in fields:
        leaves["worlds"] = draws[0].worlds.detach().clone().requires_grad_()
        draws = (dataclasses.replace(draws[0], worlds=leaves["worlds"]), *draws[1:])
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **mats),
                            lights=lights, draws=draws)
    loss = torch.mean((render or pbr.render)(s, cam_, width=width, height=height)[..., :3] ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    # fields the render does not read (transmission, sheen, ...) get zeros, as in JAX
    return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                           for (k, t), g in zip(leaves.items(), grads)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The clip transform is written as explicit f32 sums, but no matmul or
    # convolution on this path may run in TF32 either.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import physically_based_renderer_tpu_torch as pbr
    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.renderer import binning_params, compose
    from physically_based_renderer_tpu_torch.utils import cuda_build
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    dev = torch.device(DEVICE)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_libraries(["raster_shade_row", "shade_backward", "shade_forward"])
    raster_row.kernel_library()
    raster_pallas.kernel_library()
    raster_pallas.shade_forward_library()
    print(f"build: raster_shade_row.cu + shade_backward.cu + shade_forward.cu (parallel) "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"ptxas, {name}.cu: " + "; ".join(ptxas_summary(log)))

    scene = pbr.scenes.red_sphere_grid_scene(64, 32, device=dev)
    cam = pbr.Camera.create(position=CAMERA_POS, aspect=WIDTH / HEIGHT, device=dev)
    mats, lights = scene.materials, scene.lights
    num_tris = sum(d.num_instances * d.mesh.num_triangles for d in scene.draws)
    assert num_tris == 194432, num_tris
    mat_stride = raster_row.material_stride(mats.num_materials, num_tris)
    assert mat_stride == 64, mat_stride
    params = binning_params(num_tris, WIDTH, HEIGHT)

    def setup_and_bin():
        geom = pbr.flatten_scene_corners(scene)
        clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
        binned = raster_row.bin_for_shade(
            clip, geom.attrs, geom.face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT,
            y_offset=0, tile_h=8, tile_w=128, cull_backface=True, **params,
        )
        return geom, binned

    geom, binned = setup_and_bin()
    table = mats.props_table().contiguous()
    uni = pack_shading_uniforms(
        lights.strength, lights.direction, lights.position, lights.spot_power,
        scene.ambient, cam.position,
    )
    kw = dict(
        width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=8, tile_w=128, mat_stride=mat_stride,
        num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
        apply_tonemap=True,
    )
    args = (binned.starts, binned.packed, binned.pair_tri, table, uni)

    # 1. Kernel against its plain version on the card, at the main path's shapes.
    assert not bool(binned.overflowed), "binning overflowed its pair cap"
    npairs = int(binned.starts[-1])
    xy = screen_xy(math3d.transform_points_h(geom.pos_w, cam.view_proj()), WIDTH, HEIGHT)
    every = ((binned.starts.shape[0] - 1) * int(binned.starts[0]) + npairs - int(binned.starts[0])) * 8 * 128
    print(f"binning (8x128 tiles): {run_stats(binned.starts)}; (pair, pixel) tests: {every} against every "
          f"pixel of the tile, {raster_tests(binned.starts, binned.pair_tri, xy, **kw)} inside the triangle's "
          f"pixel box, {culled_tests(*args[:3], **kw)} run after the per-warp reject")
    code_k, rgba_k, gbuf_k = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=True, **kw)
    code_p, rgba_p, gbuf_p = raster_row.raster_shade_tiles_plain(*args, want_gbuf=True, **kw)
    code_k2, rgba_k2, _ = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw)
    torch.cuda.synchronize()
    hits = int((code_k >= 0).sum())
    code_mismatch = int((code_k != code_p).sum())
    rgba_err = float((rgba_k - rgba_p).abs().max())
    gbuf_err = float((gbuf_k - gbuf_p).abs().max())
    print(f"kernel vs plain: hit pixels {hits}, pairs {npairs} (jumbo {int(binned.starts[0])}), "
          f"code mismatches {code_mismatch}, rgba max abs err {rgba_err:.3e}, "
          f"gbuf max abs err {gbuf_err:.3e}")
    assert code_mismatch == 0
    assert torch.equal(code_k2, code_k) and torch.equal(rgba_k2, rgba_k)
    assert rgba_err <= RGBA_ATOL, rgba_err
    assert gbuf_err <= GBUF_ATOL, gbuf_err
    assert hits > 0.1 * WIDTH * HEIGHT, hits

    kernel_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw), 20)
    plain_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_plain(*args, want_gbuf=False, **kw), 3, 1)
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    k1_bound = bound(raster_read_bytes(*args[:3], num_ch=7, **kw) + nbytes(table, uni, code_k2, rgba_k2),
                     raster_tests(binned.starts, binned.pair_tri, xy, **kw) * RASTER_TEST_FLOPS
                     + hits * (plane_flops(7, False) + shade_flops(*counts, True, False)))
    print(f"fused raster+shade step at 1080p: kernel {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, "
          f"bound {k1_bound[0]:.4f} ms ({k1_bound[1]}) [{smi}]")

    # 2. Stage times of the frame.
    setup_ms = cuda_ms(setup_and_bin, 10)

    def decode_and_compose():
        tri_id, _ = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
        return compose(rgba_k, tri_id >= 0, scene.clear_color)

    compose_ms = cuda_ms(decode_and_compose, 10)

    # 3. The main path: 5 frames through render(); each launches the kernel once.
    frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)  # warm
    torch.cuda.synchronize()
    raster_row.KERNEL_LAUNCHES = raster_row.SHADE_V1_KERNEL_LAUNCHES = 0
    raster_pallas.SHADE_BWD_LAUNCHES = 0
    frame_times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
        end.record()
        torch.cuda.synchronize()
        frame_times.append(start.elapsed_time(end))
    fwd_launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    # render asks raster_shade for the row kernel (kernel 1), never kernel 7
    assert fwd_launches == (5, 0) and raster_row.SHADE_V1_KERNEL_LAUNCHES == 0, fwd_launches
    frame_ms = statistics.median(frame_times)
    print(f"stage medians at 1080p: setup+bin {setup_ms:.3f} ms, kernel {kernel_ms:.3f} ms, "
          f"compose {compose_ms:.3f} ms, whole frame via render() {frame_ms:.3f} ms "
          f"({WIDTH * HEIGHT / frame_ms / 1e3:.1f} Mpix/s forward) [{smi}]")

    assert frame.shape == (HEIGHT, WIDTH, 4) and frame.dtype == torch.float32
    assert bool(torch.isfinite(frame).all())
    assert float((frame - decode_and_compose()).abs().max()) == 0.0
    img = frame.cpu().numpy()
    os.makedirs("build", exist_ok=True)
    save_png(os.path.join("build", "chip_smoke_grid.png"), img)
    mean_rgb = img[..., :3].reshape(-1, 3).mean(0)
    print(f"build/chip_smoke_grid.png mean RGB {mean_rgb.round(4).tolist()}")
    # A red sweep over the 0.5-grey clear colour: red above the grey level,
    # green and blue below it.
    assert mean_rgb[0] > mean_rgb[1] + 0.02 and abs(mean_rgb[1] - mean_rgb[2]) < 1e-3, mean_rgb
    assert mean_rgb[1] < 0.5, mean_rgb

    # 4. A small frame on the card against the CPU render.
    small = dict(width=128, height=64)
    s_scene = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
    ref = pbr.render(s_scene, s_cam, **small)
    got = pbr.render(s_scene.to(dev), s_cam.to(dev), **small).cpu()
    small_err = float((got - ref).abs().max())
    print(f"128x64 frame, card vs CPU render: max abs err {small_err:.3e}")
    assert small_err <= SMALL_ATOL, small_err

    # 5. Backward kernel against its plain version on the phase-1 frame, with
    #    the cotangent of the bench loss mean(img[..., :3]²).
    hit = code_k >= 0
    _, mat_id = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
    g_chan = torch.zeros_like(rgba_k)
    g_chan[..., :3] = torch.where(hit[..., None], 2.0 * rgba_k[..., :3] / (3 * WIDTH * HEIGHT), 0.0)
    attrs = gbuf_k[..., :6]  # the forward's (rows, W, 7) G-buffer, read with its stride
    bwd_kw = dict(num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
                  apply_tonemap=True)
    bwd_args = (g_chan, attrs, mat_id, hit, table, uni)
    got = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    ref = raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw)
    again = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    # the main path's call (the material step): no per-pixel output
    sums_only = dict(bwd_kw, want_attrs=False, want_props=False)
    lean = raster_pallas.shade_backward_cuda(*bwd_args, **sums_only)
    torch.cuda.synchronize()
    assert lean[0] is None and lean[1] is None
    assert torch.equal(lean[2], got[2]) and torch.equal(lean[3], got[3]), "g_uni or the table depends on the outputs"
    bwd_errs = [close(got[0], ref[0], BWD_RTOL, BWD_ATOL_FRAC, "g_attrs"),
                close(got[1], ref[1], BWD_RTOL, BWD_ATOL_FRAC, "g_props"),
                close(got[2], ref[2], BWD_RTOL, BWD_ATOL_FRAC, "g_uni")]
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3]), \
        "g_uni or the table cotangent differs between two launches"
    assert not got[0][~hit].any() and not got[1][~hit].any()
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    # The table cotangent the kernel sums itself: against float64 sums by
    # material of its own g_props (f32 summation order only), and against the
    # plain version's table within the bound the per-pixel tolerance implies.
    num_mats = table.shape[0]
    by_mat = lambda v: torch.zeros((num_mats, 9), dtype=torch.float64, device=dev).index_add_(
        0, mat_id[hit].long(), v[hit].double())
    own_err = (got[3].double() - by_mat(got[1])).abs()
    assert bool((own_err <= TABLE_SUM_RTOL * by_mat(got[1].abs())).all()), float(own_err.max())
    table_bound = (BWD_RTOL * by_mat(ref[1].abs())
                   + BWD_ATOL_FRAC * float(ref[1].abs().max()) * by_mat(torch.ones_like(ref[1]))
                   + TABLE_SUM_RTOL * by_mat(ref[1].abs()))
    table_err = (got[3].double() - ref[3].double()).abs()
    assert bool((table_err <= table_bound).all()), f"table cotangent: max abs err {float(table_err.max()):.3e}"
    bwd_errs.append(float(table_err.max()))
    bwd_err = max(bwd_errs)
    print(f"backward kernel vs plain: max abs err g_attrs {bwd_errs[0]:.3e}, g_props {bwd_errs[1]:.3e}, "
          f"g_uni {bwd_errs[2]:.3e} (|g_uni| max {float(ref[2].abs().max()):.3e}), table "
          f"{bwd_errs[3]:.3e} (|table| max {float(ref[3].abs().max()):.3e}; vs f64 of its own "
          f"g_props {float(own_err.max()):.3e})")
    bwd_ms = cuda_ms(lambda: raster_pallas.shade_backward_cuda(*bwd_args, **sums_only), 20)
    bwd_full_ms = cuda_ms(lambda: raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw), 20)
    bwd_plain_ms = cuda_ms(lambda: raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw), 5, 1)
    g_props = ref[1]
    scatter_ms = cuda_ms(lambda: raster_pallas._scatter_props_by_id(g_props, mat_id, *table.shape), 20)
    # two forward shades and the adjoint's ~3x per hit pixel (csrc/shade_backward.cu)
    k3_flops = hits * 5 * shade_flops(*counts, True, False)
    k3_bound = bound(adjoint_bytes(*bwd_args, lean), k3_flops)
    k3_full_bound = bound(adjoint_bytes(*bwd_args, got), k3_flops)
    print(f"shade backward at 1080p: kernel (table sum included) {bwd_ms:.3f} ms without per-pixel outputs "
          f"(the material step's call), {bwd_full_ms:.3f} ms with g_attrs and g_props; plain version "
          f"{bwd_plain_ms:.3f} ms, of which the plain material scatter (bincount) {scatter_ms:.3f} ms; bound "
          f"{k3_bound[0]:.4f} ms ({k3_bound[1]}), with the outputs {k3_full_bound[0]:.4f} ms ({k3_full_bound[1]}) "
          f"[{smi}]")

    # 6. The bench step: forward + backward of the bench loss at 1080p,
    #    material gradients only. Each step launches each kernel once.
    mat_fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
    bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)  # warm
    torch.cuda.synchronize()
    raster_row.KERNEL_LAUNCHES = 0
    raster_pallas.SHADE_BWD_LAUNCHES = 0
    geom_before = raster_pallas.GEOMETRY_RECOMPUTES
    step_ms, first = [], None
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert (raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES) == (i + 1, i + 1)
        first = first or grads
        assert all(torch.equal(grads[k], first[k]) for k in grads), "step gradients differ between steps"
    train_launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    assert raster_pallas.GEOMETRY_RECOMPUTES == geom_before, "material-only step ran the geometry VJP"
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["roughness"].abs().sum()) > 0 and float(grads["diffuse"].abs().sum()) > 0
    step_med = statistics.median(step_ms)
    print(f"bench step (fwd+bwd, material grads) at 1080p: median {step_med:.3f} ms over 5 "
          f"({WIDTH * HEIGHT / step_med / 1e3:.1f} Mpix/s), steps {[round(t, 3) for t in step_ms]}, "
          f"loss {float(loss):.6f}, launches fwd/bwd {train_launches} [{smi}]")

    # 7. The trainer: 5 SGD steps from perturbed materials toward the
    #    original's render.
    target = frame[..., :3].detach()
    gen = torch.Generator(device=dev).manual_seed(0)
    start = dataclasses.replace(
        mats,
        roughness=(mats.roughness + 0.3 * torch.rand(mats.roughness.shape, generator=gen, device=dev)
                   - 0.15).clamp(0.1, 1.0),
        diffuse=(mats.diffuse + 0.4 * torch.rand(mats.diffuse.shape, generator=gen, device=dev)
                 - 0.2).clamp(0.05, 1.0),
    )
    s = dataclasses.replace(scene, materials=start)
    step = pbr.make_train_step(width=WIDTH, height=HEIGHT, learning_rate=TRAIN_LR)
    raster_row.KERNEL_LAUNCHES = 0
    raster_pallas.SHADE_BWD_LAUNCHES = 0
    losses = []
    for _ in range(5):
        s, loss = step(s, cam, target)
        losses.append(float(loss))
    trainer_launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    assert trainer_launches == (5, 5), trainer_launches
    print(f"trainer, 5 SGD steps at 1080p (lr {TRAIN_LR}): losses {[f'{x:.4e}' for x in losses]}")
    assert all(math.isfinite(x) for x in losses) and losses[-1] < 0.5 * losses[0], losses
    rough_err0 = float((start.roughness - mats.roughness).abs().mean())
    rough_err = float((s.materials.roughness - mats.roughness).abs().mean())
    print(f"  mean |roughness − original|: {rough_err0:.4f} → {rough_err:.4f}")

    # 8. Gradients on the card against the CPU on the small frame.
    fields = ["diffuse", "roughness", "metallic", "fresnel_r0", "strength", "eye", "worlds"]
    _, g_cpu = bench_loss_grads(pbr, s_scene, s_cam, 128, 64, fields)
    _, g_dev = bench_loss_grads(pbr, s_scene.to(dev), s_cam.to(dev), 128, 64, fields)
    grad_errs = {k: close(g_dev[k], g_cpu[k], GRAD_RTOL, GRAD_ATOL_FRAC, k) for k in fields}
    print("128x64 gradients, card vs CPU, max abs err: "
          + ", ".join(f"{k} {v:.2e}" for k, v in grad_errs.items()))

    ibl_kernels = ibl_phases(pbr, scene, cam, dev, smi)
    ptxas = [line for log in logs.values() for line in ptxas_summary(log)]
    sharded_kernels = sharded_phases(pbr, scene, cam, dev, smi, ptxas)
    textured_kernels, textured = textured_phases(pbr, dev, smi, ptxas)
    mode_kernels = render_mode_phases(pbr, scene, cam, dev, smi, ptxas, textured)
    soft_kernels = soft_phases(pbr, scene, cam, dev, smi, ptxas)
    route_phases(pbr, scene, cam, dev, smi, ptxas, textured)
    reader_phases(pbr, dev, smi)

    print(json.dumps({"kernels": [
        kernel_entry("raster_shade_row", "raster_shade_row.cu", "ops/raster_row.py:59", train_launches[0],
                     rgba_err, kernel_ms, plain_ms, k1_bound),
        kernel_entry("shade_backward", "shade_backward.cu", "ops/raster_pallas.py:1660", train_launches[1],
                     bwd_err, bwd_ms, bwd_plain_ms, k3_bound),
        *ibl_kernels, *sharded_kernels, *textured_kernels, *mode_kernels, *soft_kernels,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def ibl_phases(pbr, grid, cam, dev, smi):
    """Phases a-g: the 1080p grid under IBL. Returns the JSON entries of the
    two kernels' IBL modes."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import ibl, raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.ops.sky import camera_ray_directions, sample_sky
    from physically_based_renderer_tpu_torch.ops.texture import sky_u8
    from physically_based_renderer_tpu_torch.ops.tonemap import tonemap
    from physically_based_renderer_tpu_torch.renderer import background, binning_params, compose_ibl
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    # a. The IBL maps, built on the card from the seeded env, against the CPU build.
    env_np = seeded_env(7, 256, 512)
    env = torch.as_tensor(env_np, device=dev)
    build_ms = cuda_ms(lambda: ibl.IBLMaps.build(env), 3, 1)
    maps = ibl.IBLMaps.build(env)
    t0 = time.perf_counter()
    maps_cpu = ibl.IBLMaps.build(torch.as_tensor(env_np))
    cpu_build_s = time.perf_counter() - t0
    map_errs = {}
    for name in ("irradiance", "specular_stack", "irradiance_sh9", "lut"):
        map_errs[name] = close(getattr(maps, name), getattr(maps_cpu, name), MAPS_RTOL, MAPS_ATOL_FRAC, name)
    for name in ("specular_stack_f16", "irradiance_f16"):  # one f16 ulp, relative
        map_errs[name] = close(getattr(maps, name).float(), getattr(maps_cpu, name).float(), 2.0**-10,
                               1e-6, name)
    assert float(maps.specular_stack.max()) > 5.0, "the sun lobes are missing from the maps"
    print(f"a. IBL maps from a 256x512 env on the card: build {build_ms:.3f} ms (CPU build {cpu_build_s:.2f} s); "
          "card vs CPU max abs err " + ", ".join(f"{k} {v:.2e}" for k, v in map_errs.items()) + f" [{smi}]")

    bg = sky_u8(seeded_background(8, 1536, 3072)).to(dev)
    scene = dataclasses.replace(grid, env_map=env, ibl=maps, sky_map=bg)
    mats, lights = scene.materials, scene.lights

    # b. The forward kernel's IBL mode against its plain version at 1080p.
    geom = pbr.flatten_scene_corners(scene)
    vp = cam.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)
    num_tris = geom.num_triangles
    mat_stride = raster_row.material_stride(mats.num_materials, num_tris)
    binned = raster_row.bin_for_shade(
        clip, geom.attrs, geom.face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0,
        tile_h=8, tile_w=128, cull_backface=True, **binning_params(num_tris, WIDTH, HEIGHT),
    )
    assert not bool(binned.overflowed), "binning overflowed its pair cap"
    table = mats.props_table().contiguous()
    uni = pack_shading_uniforms(lights.strength, lights.direction, lights.position, lights.spot_power,
                                scene.ambient, cam.position, maps.irradiance_sh9)
    kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=8, tile_w=128, mat_stride=mat_stride,
              num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
              apply_tonemap=False, ibl=True)
    args = (binned.starts, binned.packed, binned.pair_tri, table, uni)
    code_k, chan_k, gbuf_k = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=True, **kw)
    code_p, chan_p, gbuf_p = raster_row.raster_shade_tiles_plain(*args, want_gbuf=True, **kw)
    torch.cuda.synchronize()
    hit = code_k >= 0
    assert int((code_k != code_p).sum()) == 0, "IBL kernel codes differ from the plain version's"
    assert chan_k.shape == (HEIGHT, WIDTH, 11)
    assert not chan_k[~hit].any(), "the IBL kernel wrote a nonzero background channel"
    err = (chan_k - chan_p).abs()
    tol = IBL_ATOL + IBL_RTOL * chan_p.abs()
    assert bool((err <= tol).all()), f"IBL channels: max abs err {float(err.max()):.3e}"
    chan_err = float(err.max())
    gbuf_err = float((gbuf_k - gbuf_p).abs().max())
    assert gbuf_err <= GBUF_ATOL, gbuf_err
    per_ch = [f"{float(err[..., c].max()):.1e}" for c in range(11)]
    ibl_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw), 20)
    ibl_plain_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_plain(*args, want_gbuf=False, **kw), 3, 1)
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    hits = int(hit.sum())
    k1b_bound = bound(raster_read_bytes(*args[:3], num_ch=7, **kw) + nbytes(table, uni, code_k, chan_k),
                      raster_tests(binned.starts, binned.pair_tri, screen_xy(clip, WIDTH, HEIGHT), **kw)
                      * RASTER_TEST_FLOPS + hits * (plane_flops(7, False) + shade_flops(*counts, False, True)))
    print(f"b. IBL forward kernel vs plain at 1080p: hit pixels {int(hit.sum())}, codes exact, channel max abs "
          f"err {chan_err:.3e} (per channel {per_ch}; |hdr| max {float(chan_p[..., :3].abs().max()):.2f}), "
          f"gbuf {gbuf_err:.3e}; kernel {ibl_ms:.3f} ms, plain version {ibl_plain_ms:.3f} ms, bound "
          f"{k1b_bound[0]:.4f} ms ({k1b_bound[1]}) [{smi}]")

    # c. The adjoint's IBL mode against its plain version, with the cotangent
    #    of the bench loss (all four image channels) through the epilogue.
    dirs = camera_ray_directions(math3d.inverse(vp), WIDTH, HEIGHT)
    sky_bg = background(scene, vp, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0, apply_tonemap=True)
    assert torch.equal(sky_bg, tonemap(sample_sky(bg, dirs))), "the background is not the sky"
    chan_leaf = chan_k.detach().requires_grad_()
    img = compose_ibl(chan_leaf, code_k, scene, sky_bg, True)
    (g_chan,) = torch.autograd.grad(torch.mean(img**2), chan_leaf)
    g_chan = torch.where(hit[..., None], g_chan, 0.0)
    assert bool(torch.isfinite(g_chan).all())
    nonzero = [bool(g_chan[..., c].any()) for c in range(11)]
    assert all(nonzero), f"cotangent channels all zero: {[c for c in range(11) if not nonzero[c]]}"
    _, mat_id = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
    bwd_kw = dict(num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
                  apply_tonemap=False, ibl=True)
    bwd_args = (g_chan, gbuf_k[..., :6], mat_id, hit, table, uni)
    got = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    ref = raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw)
    again = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    sums_only = dict(bwd_kw, want_attrs=False, want_props=False)  # the IBL material step's call
    lean = raster_pallas.shade_backward_cuda(*bwd_args, **sums_only)
    torch.cuda.synchronize()
    assert lean[0] is None and lean[1] is None
    assert torch.equal(lean[2], got[2]) and torch.equal(lean[3], got[3]), "IBL g_uni or table depends on the outputs"
    errs = [close(got[0], ref[0], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_attrs"),
            close(got[1], ref[1], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_props"),
            close(got[2], ref[2], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_uni")]
    s0 = uni.shape[1] - 27
    sh_err = close(got[2][:, s0:], ref[2][:, s0:], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_uni SH9 slots")
    # the spheres' albedo is pure red: the red slots carry the gradient, the others none
    g_sh9 = got[2][0, s0:].reshape(9, 3)
    assert bool((g_sh9[:, 0].abs() > 0).all()) and not g_sh9[:, 1:].any(), g_sh9
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3]), \
        "IBL g_uni or table cotangent differs between two launches"
    assert not got[0][~hit].any() and not got[1][~hit].any()
    num_mats = table.shape[0]
    by_mat = lambda v: torch.zeros((num_mats, 9), dtype=torch.float64, device=dev).index_add_(
        0, mat_id[hit].long(), v[hit].double())
    own_err = (got[3].double() - by_mat(got[1])).abs()
    assert bool((own_err <= TABLE_SUM_RTOL * by_mat(got[1].abs())).all()), float(own_err.max())
    table_bound = (BWD_RTOL * by_mat(ref[1].abs())
                   + BWD_ATOL_FRAC * float(ref[1].abs().max()) * by_mat(torch.ones_like(ref[1]))
                   + TABLE_SUM_RTOL * by_mat(ref[1].abs()))
    table_err = (got[3].double() - ref[3].double()).abs()
    assert bool((table_err <= table_bound).all()), f"IBL table cotangent: max abs err {float(table_err.max()):.3e}"
    errs.append(float(table_err.max()))
    bwd_ibl_err = max(errs)
    bwd_ibl_ms = cuda_ms(lambda: raster_pallas.shade_backward_cuda(*bwd_args, **sums_only), 20)
    bwd_ibl_full_ms = cuda_ms(lambda: raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw), 20)
    bwd_ibl_plain_ms = cuda_ms(lambda: raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw), 5, 1)
    k3b_flops = hits * 5 * shade_flops(*counts, False, True)
    k3b_bound = bound(adjoint_bytes(*bwd_args, lean), k3b_flops)
    k3b_full_bound = bound(adjoint_bytes(*bwd_args, got), k3b_flops)
    print(f"c. IBL adjoint vs plain at 1080p: max abs err g_attrs {errs[0]:.3e}, g_props {errs[1]:.3e}, g_uni "
          f"{errs[2]:.3e} (SH9 slots {sh_err:.3e}; |g_sh9| max {float(ref[2][:, s0:].abs().max()):.3e}), table "
          f"{errs[3]:.3e}; kernel {bwd_ibl_ms:.3f} ms without per-pixel outputs (the IBL material step's call), "
          f"{bwd_ibl_full_ms:.3f} ms with them; plain version {bwd_ibl_plain_ms:.3f} ms, bound {k3b_bound[0]:.4f} "
          f"ms ({k3b_bound[1]}), with the outputs {k3b_full_bound[0]:.4f} ms ({k3b_full_bound[1]}) [{smi}]")

    # d. Five IBL frames through render(): the IBL forward once each, no adjoint.
    frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
    torch.cuda.synchronize()
    counters = ("KERNEL_LAUNCHES", "IBL_KERNEL_LAUNCHES"), ("SHADE_BWD_LAUNCHES", "SHADE_BWD_IBL_LAUNCHES")

    def reset():
        for name in counters[0]:
            setattr(raster_row, name, 0)
        for name in counters[1]:
            setattr(raster_pallas, name, 0)

    def launches():  # (forward, forward IBL, adjoint, adjoint IBL)
        return (*(getattr(raster_row, n) for n in counters[0]), *(getattr(raster_pallas, n) for n in counters[1]))

    reset()
    frame_times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
        end.record()
        torch.cuda.synchronize()
        frame_times.append(start.elapsed_time(end))
    assert launches() == (0, 5, 0, 0), launches()
    frame_ms = statistics.median(frame_times)
    epilogue = lambda: compose_ibl(chan_k, code_k, scene, background(
        scene, vp, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0, apply_tonemap=True), True)
    epilogue_ms = cuda_ms(epilogue, 10)
    assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
    assert float((frame - epilogue()).abs().max()) == 0.0
    assert torch.equal(frame[~hit][:, :3], sky_bg[~hit]), "the background is not the sky"
    img = frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_grid_ibl.png"), img)
    fg = img[hit.cpu().numpy()][:, :3].mean(0)
    print(f"d. 5 IBL frames via render() at 1080p: median {frame_ms:.3f} ms "
          f"({WIDTH * HEIGHT / frame_ms / 1e3:.1f} Mpix/s forward), epilogue (env gather + sky + compose) "
          f"{epilogue_ms:.3f} ms; build/chip_smoke_grid_ibl.png foreground mean RGB {fg.round(4).tolist()}, "
          f"mean RGB {img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()} [{smi}]")
    assert fg[0] > fg[1] + 0.05 and fg[0] > fg[2] + 0.05, fg  # red spheres under a bluish sky

    # e. Five bench steps on the IBL frame: material gradients.
    mat_fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
    bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)  # warm
    torch.cuda.synchronize()
    reset()
    step_ms, first = [], None
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert launches() == (0, i + 1, 0, i + 1), launches()
        first = first or grads
        assert all(torch.equal(grads[k], first[k]) for k in grads), "IBL step gradients differ between steps"
    ibl_launches = launches()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["roughness"].abs().sum()) > 0 and float(grads["metallic"].abs().sum()) > 0
    step_med = statistics.median(step_ms)
    print(f"e. IBL bench step (fwd+bwd, material grads) at 1080p: median {step_med:.3f} ms over 5 "
          f"({WIDTH * HEIGHT / step_med / 1e3:.1f} Mpix/s), steps {[round(t, 3) for t in step_ms]}, "
          f"loss {float(loss):.6f}, launches (fwd, fwd IBL, bwd, bwd IBL) {ibl_launches} [{smi}]")

    # f. One step with the gradient to the environment map through the map build.
    def env_step():
        env_leaf = env.clone().requires_grad_()
        s = dataclasses.replace(scene, env_map=env_leaf).with_ibl()
        torch.mean(pbr.render(s, cam, width=WIDTH, height=HEIGHT)[..., :3] ** 2).backward()
        return env_leaf.grad

    env_step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g_env = env_step()
    torch.cuda.synchronize()
    env_step_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    g_env2 = env_step()
    assert bool(torch.isfinite(g_env).all()) and float(g_env.abs().sum()) > 0
    print(f"f. env-map gradient step at 1080p (map build + frame + backward): {env_step_ms:.3f} ms, peak "
          f"{peak_mib:.1f} MiB above the scene; |grad| max {float(g_env.abs().max()):.3e}; same bits on a "
          f"second run: {torch.equal(g_env, g_env2)} [{smi}]")

    # g. A 128x64 IBL frame on the card against the CPU: image and gradients.
    s_grid = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
    s_env, s_bg = seeded_env(9, 16, 32), sky_u8(seeded_background(10, 24, 48))

    def small(device):
        e = torch.as_tensor(s_env, device=device).requires_grad_()
        s = dataclasses.replace(s_grid.to(device), env_map=e, sky_map=s_bg.to(device)).with_ibl()
        leaves = {k: getattr(s.materials, k).detach().clone().requires_grad_()
                  for k in ("diffuse", "roughness", "metallic", "fresnel_r0")}
        stack = s.ibl.specular_stack.detach().clone().requires_grad_()
        sh9 = s.ibl.irradiance_sh9.detach().clone().requires_grad_()
        s = dataclasses.replace(s, materials=dataclasses.replace(s.materials, **leaves),
                                ibl=dataclasses.replace(s.ibl, specular_stack=stack, irradiance_sh9=sh9))
        img = pbr.render(s, s_cam.to(device), width=128, height=64)
        torch.mean(img[..., :3] ** 2).backward()
        # the map leaves cut the build out of the frame: the env gradient goes
        # through a second frame that builds its maps
        s2 = dataclasses.replace(s_grid.to(device), env_map=e, sky_map=s_bg.to(device)).with_ibl()
        torch.mean(pbr.render(s2, s_cam.to(device), width=128, height=64)[..., :3] ** 2).backward()
        return img.detach(), {**{k: t.grad for k, t in leaves.items()}, "specular_stack": stack.grad,
                              "irradiance_sh9": sh9.grad, "env_map": e.grad}

    img_cpu, g_cpu = small("cpu")
    img_dev, g_dev = small(dev)
    img_err = float((img_dev.cpu() - img_cpu).abs().max())
    assert img_err <= IBL_IMAGE_ATOL, img_err
    env_like = ("specular_stack", "irradiance_sh9", "env_map")
    small_errs = {k: close(g_dev[k], g_cpu[k], GRAD_RTOL, ENV_GRAD_ATOL_FRAC if k in env_like else GRAD_ATOL_FRAC, k)
                  for k in g_cpu}
    print(f"g. 128x64 IBL frame, card vs CPU: image max abs err {img_err:.3e}; gradients max abs err "
          + ", ".join(f"{k} {v:.2e}" for k, v in small_errs.items()))

    return [
        kernel_entry("raster_shade_row_ibl", "raster_shade_row.cu", "ops/raster_row.py:59", ibl_launches[1],
                     chan_err, ibl_ms, ibl_plain_ms, k1b_bound),
        kernel_entry("shade_backward_ibl", "shade_backward.cu", "ops/raster_pallas.py:1660", ibl_launches[3],
                     bwd_ibl_err, bwd_ibl_ms, bwd_ibl_plain_ms, k3b_bound),
    ]


def world_of_one(dev: torch.device) -> None:
    """A one-process group for the sharded paths: NCCL on the card (gloo for
    CPU tensors), its store a file under build/ (no sockets)."""
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_world1.store")
    if os.path.exists(path):
        os.remove(path)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)


def wall_ms(fns: dict, runs: int = RATIO_RUNS) -> dict:
    """Host-clock ms of 2·``runs`` runs of each function (work ending in a
    synchronize), after two warm-up runs each, interleaved run by run in
    alternating order (a b, b a, a b, ...): a drift of the shared host's
    speed falls on both sides alike."""
    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(2 * runs):
        for k in keys if i % 2 == 0 else keys[::-1]:
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def overhead(times: dict, plain: str, sharded: str) -> tuple[float, float, float]:
    """(median sharded / median plain, the quartiles of the run-by-run
    ratios): the ratio and its spread."""
    q = statistics.quantiles([b / a for a, b in zip(times[plain], times[sharded])], n=4)
    return statistics.median(times[sharded]) / statistics.median(times[plain]), q[0], q[2]


def sharded_phases(pbr, scene, cam, dev, smi, ptxas):
    """Phases h-l: the sharded paths on the 1080p grid. Returns the JSON
    entries of kernels 2 and 6."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.parallel import sharded

    mats, lights = scene.materials, scene.lights
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    geom = pbr.flatten_scene_corners(scene)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    fm = geom.face_material

    # h. Kernel 2 against its plain version.
    def gbuffer_case(name, clip, attrs, fm, rows=HEIGHT, y_offset=0, z_floor=None, cull=True):
        binned = raster_row.bin_for_shade(clip, attrs, fm, width=WIDTH, height=HEIGHT, rows=rows,
                                          y_offset=y_offset, cull_backface=cull, **TRI_BINS)
        assert not bool(binned.overflowed), f"{name}: binning overflowed its pair cap"
        kw = dict(width=WIDTH, rows=rows, y_offset=y_offset, tile_h=8, tile_w=128, z_floor=z_floor,
                  mat_stride=raster_row.material_stride(mats.num_materials, clip.shape[0]),
                  num_ch=attrs.shape[-1] + 1)
        args = (binned.starts, binned.packed, binned.pair_tri)
        code_k, gb_k = raster_row.raster_gbuffer_tiles_cuda(*args, **kw)
        code_p, gb_p = raster_row.raster_gbuffer_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        assert int((code_k != code_p).sum()) == 0, f"{name}: G-buffer codes differ from the plain version's"
        attr_err = float((gb_k[..., :-1] - gb_p[..., :-1]).abs().max())
        depth_err = float((gb_k[..., -1] - gb_p[..., -1]).abs().max())
        assert attr_err <= GBUF_ATOL and depth_err <= DEPTH_ATOL, (name, attr_err, depth_err)
        hits = int((code_k >= 0).sum())
        assert not gb_k[code_k < 0].any(), f"{name}: nonzero background"
        print(f"h. {name}: {rows}x{WIDTH} at y_offset {y_offset}, {clip.shape[0]} triangles, C = "
              f"{attrs.shape[-1]}: hit pixels {hits}, pairs {int(binned.starts[-1])}, codes exact, attrs max abs "
              f"err {attr_err:.3e}, depth {depth_err:.3e}")
        return dict(args=args, kw=kw, code=code_k, gbuf=gb_k, hits=hits, err=max(attr_err, depth_err))

    full = gbuffer_case("full frame", clip, geom.attrs, fm)
    quarter = sharded.triangle_shard(scene, cam, 0, 4)
    pad = -(-quarter.clip.shape[0] // 1024) * 1024 - quarter.clip.shape[0]
    padded = [torch.nn.functional.pad(t, (0,) * (2 * (t.ndim - 1)) + (0, pad))
              for t in (quarter.clip, quarter.attrs, quarter.face_material)]
    band = gbuffer_case(f"band over the first quarter of the triangles + {pad} zero rows", *padded,
                        rows=HEIGHT // 4, y_offset=HEIGHT // 2)
    gen = torch.Generator(device=dev).manual_seed(14)
    extra = torch.randn((geom.num_triangles, 3, 8), generator=gen, device=dev)
    c14 = gbuffer_case("C = 14, seeded attributes", clip, torch.cat([geom.attrs, extra], dim=-1), fm)
    first = gbuffer_case("first layer, no culling", clip, geom.attrs, fm, cull=False)
    z_floor = torch.where(first["code"] >= 0, first["gbuf"][..., -1], -torch.inf).contiguous()
    peel = gbuffer_case("peel behind the first layer", clip, geom.attrs, fm, z_floor=z_floor, cull=False)
    peeled = peel["code"] >= 0
    assert peel["hits"] > 0.5 * first["hits"], "the peel found no back faces"
    assert bool((peel["gbuf"][..., -1][peeled] > z_floor[peeled]).all())
    k2_err = max(c["err"] for c in (full, band, c14, first, peel))
    k2_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_cuda(*full["args"], **full["kw"]), 20)
    k2_plain_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_plain(*full["args"], **full["kw"]), 3, 1)
    k2_c14_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_cuda(*c14["args"], **c14["kw"]), 20)
    k2_bound = bound(raster_read_bytes(*full["args"], **full["kw"]) + nbytes(full["code"], full["gbuf"]),
                     raster_tests(*full["args"][::2], screen_xy(clip, WIDTH, HEIGHT), **full["kw"])
                     * RASTER_TEST_FLOPS
                     + full["hits"] * plane_flops(7, True))
    k2_c14_bound = bound(raster_read_bytes(*c14["args"], **c14["kw"]) + nbytes(c14["code"], c14["gbuf"]),
                         raster_tests(*c14["args"][::2], screen_xy(clip, WIDTH, HEIGHT), **c14["kw"])
                         * RASTER_TEST_FLOPS
                         + c14["hits"] * plane_flops(15, True))
    regs = [line for line in ptxas if line.startswith(("raster_gbuffer_row_kernel<4,7>",
                                                        "raster_gbuffer_row_kernel<4,15>"))]
    print(f"h. G-buffer kernel at 1080p (full frame, C = 6): kernel {k2_ms:.3f} ms, plain version "
          f"{k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); C = 14 kernel {k2_c14_ms:.3f} ms, "
          f"bound {k2_c14_bound[0]:.4f} ms ({k2_c14_bound[1]}); max abs err {k2_err:.3e}; ptxas {regs} [{smi}]")
    print("h. kernel 2's (pair, pixel) tests, full frame (8x128 tiles, 16x8 warp blocks): "
          + reject_share(full["args"], screen_xy(clip, WIDTH, HEIGHT), full["kw"], ppt=4, ctas_per_sm=3))

    # i. Kernel 6 against its plain version on the full frame's G-buffer, both modes.
    hit = full["code"] >= 0
    _, mat_id = raster_row.decode_codes(full["code"], full["kw"]["mat_stride"], fm)
    attrs = full["gbuf"][..., :6]  # the (rows, W, 7) G-buffer, read with its stride
    table = mats.props_table().contiguous()
    sh9 = torch.as_tensor(np.random.default_rng(9).normal(0.0, 0.3, (9, 3)).astype(np.float32), device=dev)
    k6 = {}
    for ibl in (False, True):
        uni = pack_shading_uniforms(lights.strength, lights.direction, lights.position, lights.spot_power,
                                    scene.ambient, cam.position, sh9 if ibl else None)
        args = (attrs, mat_id, hit, table, uni)
        kw = dict(num_dir=counts[0], num_point=counts[1], num_spot=counts[2], ibl=ibl)
        got = raster_pallas.shade_forward_cuda(*args, **kw)
        ref = raster_pallas.shade_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = IBL_ATOL + IBL_RTOL * ref.abs() if ibl else RGBA_ATOL
        assert bool((err <= tol).all()), f"shade_forward (ibl={ibl}): max abs err {float(err.max()):.3e}"
        assert not got[~hit].any() and bool(torch.isfinite(got).all())
        ms = cuda_ms(lambda: raster_pallas.shade_forward_cuda(*args, **kw), 20)
        plain = cuda_ms(lambda: raster_pallas.shade_forward_plain(*args, **kw), 3, 1)
        k6[ibl] = dict(err=float(err.max()), ms=ms, plain_ms=plain, bound=bound(
            nbytes(*args, got), int(hit.sum()) * shade_flops(*counts, not ibl, ibl)))
        print(f"i. G-buffer shading kernel ({'IBL' if ibl else 'shade'} mode) vs plain at 1080p: max abs err "
              f"{k6[ibl]['err']:.3e}; kernel {ms:.3f} ms, plain version {plain:.3f} ms, bound "
              f"{k6[ibl]['bound'][0]:.4f} ms ({k6[ibl]['bound'][1]}) [{smi}]")

    frame = lambda fn: (lambda: fn(scene, cam, width=WIDTH, height=HEIGHT))
    solo = statistics.median(wall_ms({"render": frame(pbr.render)})["render"])  # before the group exists
    world_of_one(dev)
    try:
        # j. The triangle-sharded bench step: material gradients through render_tri_sharded.
        counters = ((raster_row, "GBUF_KERNEL_LAUNCHES"), (raster_pallas, "SHADE_FWD_LAUNCHES"),
                    (raster_pallas, "SHADE_BWD_LAUNCHES"), (raster_row, "KERNEL_LAUNCHES"))
        mat_fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
        step = lambda: bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields, pbr.render_tri_sharded)
        step()  # warm
        torch.cuda.synchronize()
        for mod, name in counters:
            setattr(mod, name, 0)
        step_ms, first_grads = [], None
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = tuple(getattr(mod, name) for mod, name in counters)
            assert launches == (i + 1, i + 1, i + 1, 0), launches
            first_grads = first_grads or grads
            assert all(torch.equal(grads[k], first_grads[k]) for k in grads), "tri-sharded gradients differ"
        tri_launches = launches
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        assert float(grads["roughness"].abs().sum()) > 0 and float(grads["diffuse"].abs().sum()) > 0
        print(f"j. tri-sharded bench step (world of 1, NCCL) at 1080p: median {statistics.median(step_ms):.3f} ms "
              f"over 5, steps {[round(t, 3) for t in step_ms]}, loss {float(loss):.6f}; launches over the 5 "
              f"steps (G-buffer, G-buffer shading, adjoint, fused forward) {tri_launches} [{smi}]")

        # k. bench.py's three overhead ratios, the two sides interleaved run by run.
        fwd = wall_ms({"render": frame(pbr.render), "render_sharded": frame(pbr.render_sharded)})
        tri = wall_ms({"render": frame(pbr.render), "render_tri_sharded": frame(pbr.render_tri_sharded)})
        target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
        sh_step = pbr.make_train_step(width=WIDTH, height=HEIGHT, learning_rate=0.1)  # the world-1 group

        def plain_step():  # bench.py's plain step: the loss, its material gradients, the SGD update
            params = {k: getattr(mats, k).detach().requires_grad_() for k in mat_fields}
            s = dataclasses.replace(scene, materials=dataclasses.replace(mats, **params))
            loss = torch.mean((pbr.render(s, cam, width=WIDTH, height=HEIGHT)[..., :3] - target) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            new = {k: p.detach() if g is None else p.detach() - 0.1 * g for (k, p), g in zip(params.items(), grads)}
            return dataclasses.replace(mats, **new), loss.detach()

        train = wall_ms({"plain step": plain_step, "make_train_step": lambda: sh_step(scene, cam, target)})
        pairs = {"sharded_overhead_1chip": (fwd, "render", "render_sharded"),
                 "sharded_train_overhead_1chip": (train, "plain step", "make_train_step"),
                 "tri_sharded_overhead_1chip": (tri, "render", "render_tri_sharded")}
        ratios = {k: overhead(*p) for k, p in pairs.items()}
        print(f"k. overhead ratios at 1080p (world of 1, NCCL; {2 * RATIO_RUNS} runs a side, interleaved; medians, ms; "
              f"render before the group existed {solo:.3f}): "
              + "; ".join(f"{k} {ratios[k][0]:.4f} = {s} {statistics.median(t[s]):.3f} / {p} "
                          f"{statistics.median(t[p]):.3f} (run-by-run quartiles {ratios[k][1]:.4f}-{ratios[k][2]:.4f})"
                          for k, (t, p, s) in pairs.items()) + f" [{smi}]")
        assert all(math.isfinite(v[0]) and v[0] > 0 for v in ratios.values())

        # l. A 128x64 frame on the card against the CPU through both sharded renders.
        s_grid = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
        s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
        fields = ["diffuse", "roughness", "metallic", "fresnel_r0"]
        errs = {}
        for fn in (pbr.render_sharded, pbr.render_tri_sharded):
            img_cpu = fn(s_grid, s_cam, width=128, height=64)
            img_dev = fn(s_grid.to(dev), s_cam.to(dev), width=128, height=64).cpu()
            img_err = float((img_dev - img_cpu).abs().max())
            assert img_err <= SMALL_ATOL, (fn.__name__, img_err)
            _, g_cpu = bench_loss_grads(pbr, s_grid, s_cam, 128, 64, fields, fn)
            _, g_dev = bench_loss_grads(pbr, s_grid.to(dev), s_cam.to(dev), 128, 64, fields, fn)
            errs[fn.__name__] = [img_err] + [close(g_dev[k], g_cpu[k], GRAD_RTOL, GRAD_ATOL_FRAC, k) for k in fields]
        print("l. 128x64 frame, card vs CPU, max abs err (image, then material gradients): "
              + "; ".join(f"{k} {[f'{e:.2e}' for e in v]}" for k, v in errs.items()))
    finally:
        dist.destroy_process_group()

    return [
        kernel_entry("raster_gbuffer_row", "raster_shade_row.cu", "ops/raster_row.py:59", tri_launches[0],
                     k2_err, k2_ms, k2_plain_ms, k2_bound),
        kernel_entry("shade_forward", "shade_forward.cu", "ops/raster_pallas.py:1469", tri_launches[1],
                     k6[False]["err"], k6[False]["ms"], k6[False]["plain_ms"], k6[False]["bound"]),
    ]


def textured_phases(pbr, dev, smi, ptxas):
    """Phases m-r: the textured deferred path at 1080p (seeded pages in
    place of the absent asset files). Returns the JSON entry of kernel 4, and
    phase m's scene and asset cache."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.texture import sky_u8
    from physically_based_renderer_tpu_torch.renderer import binning_params
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    def v1_binning(scene, cam, z_floor=None):
        """Kernel 4's inputs for ``render``'s textured frame: the v1 binning
        at 1080p (16×128 tiles), as ``render`` bins it."""
        geom = pbr.flatten_scene_corners(scene, textured=True)
        clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
        params = binning_params(geom.num_triangles, WIDTH, HEIGHT, row_layout=False)
        binned = raster_row.bin_for_shade(clip, geom.attrs, geom.face_material, width=WIDTH, height=HEIGHT,
                                          rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, cull_backface=True,
                                          **params)
        assert not bool(binned.overflowed), "binning overflowed its pair cap"
        kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, num_ch=15, z_floor=z_floor,
                  mat_stride=raster_row.material_stride(scene.materials.num_materials, geom.num_triangles))
        return geom, params, binned, kw

    def textured_scene(make_scene, cache, mode, **kw):
        s = make_scene(cache, texture_size=TEXTURE_SIZE, device=dev, **kw)
        return s.with_combined_textures(mode=mode)

    def frame_ms(fn, n=5):
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times, out

    def bench_steps(scene, cam, counters, n=5, texel=None):
        """``n`` bench steps (material gradients, or the gradient to the
        quad pages with ``texel``): their host-clock ms, the peak memory
        above the scene, whether every step gave the same gradient bits,
        and the launches of each counter over the ``n`` steps."""
        fields = [k for k in scene.materials.tensor_fields() if getattr(scene.materials, k).is_floating_point()]

        def step():
            if texel is None:
                return bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, fields)[1]
            pages = scene.combined_atlas.pages.detach().clone().requires_grad_()
            s = dataclasses.replace(scene, combined_atlas=dataclasses.replace(scene.combined_atlas, pages=pages))
            loss = torch.mean(pbr.render(s, cam, width=WIDTH, height=HEIGHT, mip_lod=False)[..., :3] ** 2)
            return {"pages": torch.autograd.grad(loss, pages)[0]}

        step()  # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for mod, name in counters:
            setattr(mod, name, 0)
        times, first, same = [], None, True
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            first = first or grads
            same = same and all(torch.equal(grads[k], first[k]) for k in grads)
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        assert any(float(g.abs().sum()) > 0 for g in grads.values())
        launches = tuple(getattr(mod, name) for mod, name in counters)
        return statistics.median(times), times, (torch.cuda.max_memory_allocated() - base) / 2**20, same, launches

    os.makedirs("build", exist_ok=True)
    k4 = ((raster_row, "GBUF_V1_KERNEL_LAUNCHES"), (raster_row, "GBUF_KERNEL_LAUNCHES"),
          (raster_row, "KERNEL_LAUNCHES"), (raster_row, "IBL_KERNEL_LAUNCHES"))

    # m. pbr_scene from the seeded pages, its quad combined pages, on the card.
    t0 = time.perf_counter()
    pages = seeded_texture_pages(5, TEXTURE_SIZE, alpha=True)
    cache = fill_asset_cache(pbr.scenes.AssetCache(texture_size=TEXTURE_SIZE), pages)
    seed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = textured_scene(pbr.scenes.pbr_scene, cache, "quad")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    cam = pbr.Camera.create(position=CAMERA_POS, aspect=WIDTH / HEIGHT, device=dev)
    comb = scene.combined_atlas
    geom, params, binned, kw = v1_binning(scene, cam)
    assert scene.materials.num_materials == 58 and comb.num_pages == 9
    print(f"m. pbr_scene (58 spheres 64x32, 9 textured, {len(cache.pages)} seeded {TEXTURE_SIZE}² pages in "
          f"{seed_s:.2f} s on the host) + quad combined pages, built on the card in {build_ms:.1f} ms: atlas "
          f"{nbytes(*scene.atlas.mips) / 2**20:.1f} MiB, combined pages {nbytes(comb.taps, comb.pages, comb.mips_taps, comb.mips_stack) / 2**20:.1f} MiB "
          f"({comb.num_levels} levels); T {geom.num_triangles}, max span {params['max_span']}, pairs "
          f"{int(binned.starts[-1])}, jumbo {int(binned.starts[0])} [{smi}]")

    # n. Kernel 4 against its plain version on the frame's binning; 5 frames; mip_lod off and on.
    args = (binned.starts, binned.packed, binned.pair_tri)
    code_k, gb_k = raster_row.raster_gbuffer_tiles_cuda(*args, v1=True, **kw)
    code_p, gb_p = raster_row.raster_gbuffer_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((code_k != code_p).sum()) == 0, "kernel 4 codes differ from the plain version's"
    attr_err = float((gb_k[..., :-1] - gb_p[..., :-1]).abs().max())
    depth_err = float((gb_k[..., -1] - gb_p[..., -1]).abs().max())
    assert attr_err <= GBUF_ATOL and depth_err <= DEPTH_ATOL, (attr_err, depth_err)
    hits = int((code_k >= 0).sum())
    k4_err = max(attr_err, depth_err)
    k4_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_cuda(*args, v1=True, **kw), 20)
    k4_plain_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_plain(*args, **kw), 3, 1)
    xy = screen_xy(math3d.transform_points_h(geom.pos_w, cam.view_proj()), WIDTH, HEIGHT)
    k4_bound = bound(raster_read_bytes(*args, **kw) + nbytes(code_k, gb_k),
                     raster_tests(binned.starts, binned.pair_tri, xy, **kw) * RASTER_TEST_FLOPS
                     + hits * plane_flops(15, True))
    regs = [line for line in ptxas if line.startswith("raster_gbuffer_row_kernel<8,15>")]
    print(f"n. kernel 4 (G-buffer mode, 16x128 tiles, C = 14) vs plain at 1080p: hit pixels {hits}, codes exact, "
          f"attrs max abs err {attr_err:.3e}, depth {depth_err:.3e}; kernel {k4_ms:.3f} ms, plain version "
          f"{k4_plain_ms:.3f} ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]}); ptxas {regs} [{smi}]")
    k4_tests = reject_share(args, xy, kw, ppt=8, ctas_per_sm=2)
    print("n. kernel 4's (pair, pixel) tests (16x16 warp blocks): " + k4_tests)
    # the alpha frame's second launch (phase r): this binning behind the first layer's own depth
    peel_kw = dict(kw, z_floor=torch.where(code_k >= 0, gb_k[..., -1], -torch.inf).contiguous())
    code_pk, gb_pk = raster_row.raster_gbuffer_tiles_cuda(*args, v1=True, **peel_kw)
    peel_hits = int((code_pk >= 0).sum())
    k4_peel_bound = bound(raster_read_bytes(*args, **peel_kw) + nbytes(code_pk, gb_pk),
                          raster_tests(binned.starts, binned.pair_tri, xy, **peel_kw) * RASTER_TEST_FLOPS
                          + peel_hits * plane_flops(15, True))
    print(f"n. kernel 4's peel launch behind the first layer's depth (the alpha frame's second): hit pixels "
          f"{peel_hits}, bound {k4_peel_bound[0]:.4f} ms ({k4_peel_bound[1]}) [{smi}]")
    pbr.render(scene, cam, width=WIDTH, height=HEIGHT)  # warm
    for mod, name in k4:
        setattr(mod, name, 0)
    tex_ms, tex_times, frame = frame_ms(lambda: pbr.render(scene, cam, width=WIDTH, height=HEIGHT))
    launches = tuple(getattr(mod, name) for mod, name in k4)
    assert launches == (5, 0, 0, 0), launches
    assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
    img = frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_textured.png"), img)
    top = img[: HEIGHT // 2, :, :3].reshape(-1, 3)
    print(f"n. 5 textured frames via render() at 1080p (quad pages, mip_lod off by the 2^20-texel rule): median "
          f"{tex_ms:.3f} ms ({WIDTH * HEIGHT / tex_ms / 1e3:.1f} Mpix/s), frames {[round(t, 3) for t in tex_times]}, "
          f"launches of kernels (4, 2, 1, 1b) {launches}; build/chip_smoke_textured.png mean RGB "
          f"{img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()} [{smi}]")
    assert top.std(0).max() > 0.01, "the textured row is flat"
    mips = {False: [], True: []}
    for i in range(6):  # interleaved: off, on, on, off, ...
        for flag in ((False, True) if i % 2 == 0 else (True, False)):
            mips[flag].append(frame_ms(lambda: pbr.render(scene, cam, width=WIDTH, height=HEIGHT,
                                                          mip_lod=flag), 1)[0])
    print(f"n. mip_lod at 1080p, 6 frames each, interleaved: off median {statistics.median(mips[False]):.3f} ms, "
          f"on (trilinear, 2 fetches a sample) {statistics.median(mips[True]):.3f} ms [{smi}]")
    s_cache = fill_asset_cache(pbr.scenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32))
    s_scene = pbr.scenes.pbr_scene(s_cache, texture_size=32, slices=16, stacks=8, device="cpu")
    s_scene = s_scene.with_combined_textures(mode="quad")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
    ref = pbr.render(s_scene, s_cam, width=128, height=64).numpy()
    got = pbr.render(s_scene.to(dev), s_cam.to(dev), width=128, height=64).cpu().numpy()
    d = np.abs(got - ref)
    frac, med, q999 = float((d > 1e-5).mean()), float(np.median(d)), float(np.quantile(d, 0.999))
    print(f"n. 128x64 textured frame, card vs CPU: values off by > 1e-5 {frac:.5f}, median {med:.2e}, "
          f"0.999-quantile {q999:.2e}, max {float(d.max()):.2e}")
    assert frac < 5e-3 and med < 1e-6 and q999 < 1e-2, (frac, med, q999)

    # o. The bench step, material gradients: quad pages, then half.
    o = {}
    for mode in ("quad", "half"):
        s = scene if mode == "quad" else textured_scene(pbr.scenes.pbr_scene, cache, "half")
        o[mode] = bench_steps(s, cam, k4)
        step_med, times, peak, same, launches = o[mode]
        print(f"o. textured bench step ({mode} pages, material grads) at 1080p: median {step_med:.3f} ms over 5 "
              f"({WIDTH * HEIGHT / step_med / 1e3:.1f} Mpix/s), steps {[round(t, 3) for t in times]}, peak "
              f"{peak:.1f} MiB above the scene, the same gradient bits every step: {same}, launches of kernels "
              f"(4, 2, 1, 1b) {launches} [{smi}]")
        assert same and launches == (5, 0, 0, 0), (same, launches)
    k4_launches = o["quad"][4][0]

    # p. The texel-gradient step: the gradient to the quad pages.
    step_med, times, peak, same, launches = bench_steps(scene, cam, k4, texel=True)
    print(f"p. texel-gradient step (quad pages, mip_lod off) at 1080p: median {step_med:.3f} ms, steps "
          f"{[round(t, 3) for t in times]}, peak {peak:.1f} MiB above the scene, the same bits every step: "
          f"{same} [{smi}]")
    assert same and launches[0] == 5, (same, launches)

    # q. rustediron under the seeded HDR env and u8 background, IBL, quad pages.
    env = torch.as_tensor(seeded_env(7, 256, 512), device=dev)
    bg = sky_u8(seeded_background(8, 1536, 3072)).to(dev)
    rust = pbr.scenes.rustediron_sphere_scene(cache, texture_size=TEXTURE_SIZE, device=dev)
    rust = dataclasses.replace(rust, env_map=env, sky_map=bg).with_ibl().with_combined_textures(mode="quad")
    r_cam = pbr.Camera.create(position=(0.0, 0.0, -2.5), aspect=WIDTH / HEIGHT, device=dev)
    _, r_params, r_binned, _ = v1_binning(rust, r_cam)
    pbr.render(rust, r_cam, width=WIDTH, height=HEIGHT)  # warm
    for mod, name in k4:
        setattr(mod, name, 0)
    ibl_ms, ibl_times, r_frame = frame_ms(lambda: pbr.render(rust, r_cam, width=WIDTH, height=HEIGHT))
    launches = tuple(getattr(mod, name) for mod, name in k4)
    assert launches == (5, 0, 0, 0) and bool(torch.isfinite(r_frame).all()), launches
    r_img = r_frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_rustediron_ibl.png"), r_img)
    step_med, times, peak, same, step_launches = bench_steps(rust, r_cam, k4)
    print(f"q. rustediron + IBL (quad pages, mip_lod on by the rule, merged-IBL tail) at 1080p: T "
          f"{rust.draws[0].mesh.num_triangles}, max span {r_params['max_span']}, pairs {int(r_binned.starts[-1])}, "
          f"jumbo {int(r_binned.starts[0])}; 5 frames median {ibl_ms:.3f} ms, launches (4, 2, 1, 1b) {launches}; "
          f"bench step median {step_med:.3f} ms, peak {peak:.1f} MiB, same bits {same}, launches {step_launches}; "
          f"build/chip_smoke_rustediron_ibl.png mean RGB {r_img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()} "
          f"[{smi}]")
    assert same and step_launches[0] == 5, (same, step_launches)

    # r. An alpha-tested 1080p frame: one peel, so kernel 4 launches twice a frame.
    cut = with_fields(scene, alpha_test_fields(scene.materials, cache, 0), dev,
                      any_alpha_test=True).with_combined_textures(mode="quad")
    pbr.render(cut, cam, width=WIDTH, height=HEIGHT)  # warm
    for mod, name in k4:
        setattr(mod, name, 0)
    cut_ms, _, cut_frame = frame_ms(lambda: pbr.render(cut, cam, width=WIDTH, height=HEIGHT))
    launches = tuple(getattr(mod, name) for mod, name in k4)
    assert launches == (10, 0, 0, 0), launches
    killed = int(((cut_frame - frame).abs().amax(-1) > 1e-3).sum())
    assert killed > 100, killed
    s_cache_a = fill_asset_cache(pbr.scenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32, alpha=True))
    s_cut = pbr.scenes.pbr_scene(s_cache_a, texture_size=32, slices=16, stacks=8, device="cpu")
    s_cut = with_fields(s_cut, alpha_test_fields(s_cut.materials, s_cache_a, 0), "cpu",
                        any_alpha_test=True).with_combined_textures(mode="quad")
    a_cam = pbr.Camera.create(position=(0.0, 0.0, -4.0), aspect=128 / 64, device="cpu")
    ref = pbr.render(s_cut, a_cam, width=128, height=64).numpy()
    got = pbr.render(s_cut.to(dev), a_cam.to(dev), width=128, height=64).cpu().numpy()
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() < 5e-3 and np.median(d) < 1e-6 and np.quantile(d, 0.999) < 1e-2
    world_of_one(dev)
    try:
        for mod, name in k4:
            setattr(mod, name, 0)
        tri = pbr.render_tri_sharded(scene, cam, width=WIDTH, height=HEIGHT)
        tri_launches = tuple(getattr(mod, name) for mod, name in k4)
    finally:
        dist.destroy_process_group()
    # the ring's band tail samples mip 0, as the JAX package's does
    tri_err = float((tri - pbr.render(scene, cam, width=WIDTH, height=HEIGHT, mip_lod=False)).abs().max())
    print(f"r. alpha-tested 1080p frame (material 0 through a seeded opacity page): median {cut_ms:.3f} ms, "
          f"launches (4, 2, 1, 1b) {launches} over 5 frames, {killed} pixels show the peeled layer; 128x64 card vs "
          f"CPU max abs err {float(d.max()):.2e}; textured render_tri_sharded (world of 1, NCCL) vs render() max "
          f"abs err {tri_err:.2e}, launches {tri_launches} [{smi}]")
    print("r. each of the alpha frame's two kernel-4 launches (the frame, then the peel behind it: phase n's "
          "binning, a z floor on the second) runs phase n's (pair, pixel) tests: " + k4_tests)
    assert tri_launches == (0, 1, 0, 0) and tri_err <= GBUF_ATOL, (tri_launches, tri_err)

    return [kernel_entry("raster_gbuffer_v1", "raster_shade_row.cu", "ops/raster_pallas.py:225", k4_launches,
                         k4_err, k4_ms, k4_plain_ms, k4_bound)], (scene, cache)


def depth_ties(clip, width, height, pixels, tri_a, tri_b, *, exact, y_offset=0, cull_backface=True) -> bool:
    """Whether triangles ``tri_a`` and ``tri_b`` have the same plane depth at
    each of ``pixels`` (band rows, columns) under the port's fields: bit for
    bit with ``exact`` (kernel 5's key), else after the quantization of
    kernels 1, 4 and 7 (``raster_row.QMASK``). Only at such a tie may two
    binnings, or two processing orders, pick differently."""
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.ops.raster import setup_corners
    from physically_based_renderer_tpu_torch.ops.raster_bin import RASTER_FIELDS, pack_triangle_fields

    fields = pack_triangle_fields(setup_corners(clip, width, height, cull_backface, None))
    ys, xs = (torch.as_tensor(p, device=fields.device) for p in pixels)
    px, py = xs.to(torch.float32) + 0.5, (ys + y_offset).to(torch.float32) + 0.5

    def key(tri):
        f = fields[torch.as_tensor(tri, device=fields.device).long(), :RASTER_FIELDS]
        z = ((px - f[:, 9]) * f[:, 11] + (py - f[:, 10]) * f[:, 12] + f[:, 13]).contiguous()
        return z if exact else z.view(torch.int32) & raster_row.QMASK

    return bool(torch.equal(key(tri_a), key(tri_b)))


def explain_soft_differences(clip, width, height, margin, cull, ids_ref, ids_got, floor_ref=None, floor_got=None,
                             *, depth_tol: float, edge_tol: float) -> dict:
    """Sort the pixels where two dilated id rasters of ``clip`` differ
    (``ids_ref`` the reference's, ``ids_got`` the port's; each behind its own
    floor, None for none) by their cause, under the port's fields and
    binning at this margin. A pixel takes the first that applies:

      * "cascade": the two floors differ there by more than ``depth_tol`` (an
        earlier peel differed);
      * "leading": the reference's winner is in neither the tile's own run
        nor the jumbo run: a TPU leading pair (each run aligned down to 128),
        which the port never tests;
      * "edge": a winner's nearest dilated edge, e_min + margin, lies within
        ``edge_tol`` px of 0 (edge coefficients ulps apart flip coverage);
      * "depth": two of the winners' depths and the floors lie within
        ``depth_tol`` of each other, or a depth within it of the [0, 1] clip
        (depth planes ulps apart order a near-tie either way);
      * "unexplained": none of these.

    Returns the count of each."""
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.ops.raster import setup_corners
    from physically_based_renderer_tpu_torch.ops.raster_bin import pack_triangle_fields

    counts = dict(cascade=0, leading=0, edge=0, depth=0, unexplained=0)
    ys, xs = torch.nonzero(ids_ref != ids_got, as_tuple=True)
    if ys.numel() == 0:
        return counts
    fields = pack_triangle_fields(setup_corners(clip, width, height, cull, None), normalize_edges=True)
    px, py = xs.to(torch.float32) + 0.5, ys.to(torch.float32) + 0.5
    inf = torch.full_like(px, torch.inf)

    def at(tri):  # (e_min + margin, depth) of triangles ``tri`` at the pixels; nan where tri < 0
        f = fields[tri.clamp(min=0).long()]
        dx, dy = px - f[:, 9], py - f[:, 10]
        e = torch.stack([dx * f[:, i] + dy * f[:, 3 + i] + f[:, 6 + i] for i in range(3)], -1).amin(-1)
        z = dx * f[:, 11] + dy * f[:, 12] + f[:, 13]
        nan = torch.full_like(z, torch.nan)
        return torch.where(tri >= 0, e + margin, nan), torch.where(tri >= 0, z, nan)

    a, b = ids_ref[ys, xs], ids_got[ys, xs]
    (ea, za), (eb, zb) = at(a), at(b)
    fa = inf * -1 if floor_ref is None else floor_ref[ys, xs].to(torch.float32)
    fb = inf * -1 if floor_got is None else floor_got[ys, xs].to(torch.float32)
    cascade = ~(((fa - fb).abs() <= depth_tol) | (torch.isinf(fa) & torch.isinf(fb)))

    binned = raster_row.bin_for_shade(clip, None, None, width=width, height=height, rows=height, y_offset=0,
                                      tile_h=16, tile_w=128, max_span=8, pairs_cap=None, big_cap=None,
                                      big2_span=0, big2_cap=None, cull_backface=cull, bbox_margin_px=margin)
    num_t = clip.shape[0]
    st = binned.starts.long()
    g_end = int(st[0])
    tiles_x = -(-width // 128)
    pair_tile = torch.repeat_interleave(torch.arange(st.shape[0] - 1, device=st.device), st[1:] - st[:-1])
    own = pair_tile * num_t + binned.pair_tri[g_end : g_end + pair_tile.shape[0]].long()
    tile = (ys // 16) * tiles_x + xs // 128
    in_run = torch.isin(tile * num_t + a.long(), own) | torch.isin(a.long(), binned.pair_tri[:g_end].long())
    leading = (a >= 0) & ~in_run

    edge = (ea.abs() <= edge_tol) | (eb.abs() <= edge_tol)
    vals = torch.stack([za, zb, fa, fb], -1)
    gaps = (vals[:, :, None] - vals[:, None, :]).abs()
    gaps = torch.where(torch.eye(4, dtype=torch.bool, device=gaps.device), torch.inf, gaps)
    zs = torch.stack([za, zb], -1).nan_to_num(nan=torch.inf)
    near_clip = (zs.abs().amin(-1) <= depth_tol) | ((zs - 1.0).abs().amin(-1) <= depth_tol)
    depth = (gaps.nan_to_num(nan=torch.inf).amin((-1, -2)) <= depth_tol) | near_clip

    left = torch.ones_like(cascade)
    for name, hit in (("cascade", cascade), ("leading", leading), ("edge", edge), ("depth", depth)):
        counts[name] = int((left & hit).sum())
        left &= ~hit
    counts["unexplained"] = int(left.sum())
    return counts


def render_mode_phases(pbr, grid, cam, dev, smi, ptxas, textured):
    """Phases s-w: kernel 5 under the peel-based render modes, and kernel 7
    behind raster_shade's JAX defaults, at 1080p. ``textured`` is phase m's
    (scene, asset cache). Returns the JSON entries of kernels 5, 7 and 7b."""
    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import ibl, raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.renderer import (binning_params, render_layered, render_ssaa,
                                                             render_wireframe)
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    def frames(fn, n):
        """Median CUDA-event ms of ``n`` runs of ``fn``, and the last output."""
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), out

    mix = layer_mix_fields(grid.materials, 11)
    scene = with_fields(grid, mix, dev, any_alpha_test=True)
    mats, lights = scene.materials, scene.lights
    geom = pbr.flatten_scene_corners(scene)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    fm = geom.face_material
    num_tris = geom.num_triangles
    transparent = mats.transparent[fm.long()] > 0.5
    v1_ids = dict(tile_h=16, tile_w=128, max_span=8, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)

    # s. Kernel 5 against its plain version: the first solid peel, a peel of
    #    the transparent faces behind it, and material codes. Phases u and v
    #    hold it again on their own frames' peels.
    ids_checks = []

    def ids_case(tag, name, at, tri_mask, cull, z_floor=None, face_material=None, num_materials=None,
                 want_depth=True):
        """Kernel 5 vs its plain version on one peel of clip coordinates
        ``at``: codes exact; depth +inf at background, ≤ DEPTH_ATOL where hit."""
        binned = raster_row.bin_for_shade(at, None, face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT,
                                          y_offset=0, cull_backface=cull, tri_mask=tri_mask, **v1_ids)
        assert not bool(binned.overflowed), f"{name}: binning overflowed its pair cap"
        stride = 1 if face_material is None else raster_row.material_stride(num_materials, at.shape[0])
        kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, mat_stride=stride,
                  want_depth=want_depth, z_floor=z_floor)
        args = (binned.starts, binned.packed, binned.pair_tri)
        code_k, depth_k = raster_row.raster_ids_tiles_cuda(*args, **kw)
        code_p, depth_p = raster_row.raster_ids_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        assert int((code_k != code_p).sum()) == 0, f"{name}: kernel 5 codes differ from the plain version's"
        hit = code_k >= 0
        depth_err, depth_note = 0.0, "no depth output"
        if want_depth:
            assert bool(torch.isposinf(depth_k[~hit]).all()), f"{name}: background depth is not +inf"
            depth_err = float((depth_k[hit] - depth_p[hit]).abs().max()) if bool(hit.any()) else 0.0
            assert depth_err <= DEPTH_ATOL, (name, depth_err)
            depth_note = f"depth bit-equal {torch.equal(depth_k, depth_p)} (max abs err {depth_err:.3e})"
        print(f"{tag}. kernel 5 vs plain, {name}: hit pixels {int(hit.sum())}, pairs {int(binned.starts[-1])}, "
              f"jumbo {int(binned.starts[0])}, codes exact, {depth_note}")
        ids_checks.append(depth_err)
        return dict(name=name, args=args, kw=kw, code=code_k, depth=depth_k, hits=int(hit.sum()))

    floor0 = torch.full((HEIGHT, WIDTH), -torch.inf, device=dev)

    def behind(peel):
        """The z_floor of the next peel: the peel's depth where it hit."""
        return torch.where(peel["code"] >= 0, peel["depth"], -torch.inf).contiguous()

    solid = ids_case("s", "first solid peel (tri_mask, culled, z_floor -inf)", clip, ~transparent, True, floor0)
    trans = ids_case("s", "transparent faces behind it (no culling)", clip, transparent, False, behind(solid))
    assert bool((trans["depth"][trans["code"] >= 0] > behind(solid)[trans["code"] >= 0]).all())
    coded = ids_case("s", "material codes", clip, ~transparent, True, face_material=fm,
                     num_materials=mats.num_materials)
    assert torch.equal(coded["code"] >= 0, solid["code"] >= 0)
    k5_ms = cuda_ms(lambda: raster_row.raster_ids_tiles_cuda(*solid["args"], **solid["kw"]), 20)
    k5_plain_ms = cuda_ms(lambda: raster_row.raster_ids_tiles_plain(*solid["args"], **solid["kw"]), 3, 1)
    k5_bound = bound(raster_read_bytes(*solid["args"], num_ch=0, exact=True, **solid["kw"])
                     + nbytes(solid["code"], solid["depth"]),
                     raster_tests(*solid["args"][::2], screen_xy(clip, WIDTH, HEIGHT), **solid["kw"])
                     * RASTER_TEST_FLOPS)
    for peel in (solid, trans):
        print(f"s. kernel 5's (pair, pixel) tests, {peel['name']}: "
              + reject_share(peel["args"], screen_xy(clip, WIDTH, HEIGHT), peel["kw"]))
    regs = [line for line in ptxas if line.startswith("raster_ids_kernel")]
    print(f"s. kernel 5 (ids mode, exact depth, 16x128 tiles) at 1080p: kernel {k5_ms:.3f} ms, plain version "
          f"{k5_plain_ms:.3f} ms, bound {k5_bound[0]:.4f} ms ({k5_bound[1]}); ptxas {regs} [{smi}]")

    # t. render_layered 2+2 with the layer mix: 5 frames, four kernel-5 launches each.
    layered = lambda s=scene, **kw: render_layered(s, cam, width=WIDTH, height=HEIGHT, **kw)  # noqa: E731
    layered()  # warm
    torch.cuda.synchronize()
    raster_row.IDS_KERNEL_LAUNCHES = 0
    t_ms, frame = frames(layered, 5)
    ids_launches = raster_row.IDS_KERNEL_LAUNCHES
    assert ids_launches == 20, ids_launches  # 4 a frame
    assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
    img = frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_layered.png"), img)
    blend = int(((frame - layered(transparent_layers=0)).abs().amax(-1) > 1e-3).sum())
    no_at = with_fields(scene, dict(alpha_test=torch.zeros_like(mats.alpha_test).cpu().numpy()), dev)
    peeled = int(((frame - layered(no_at)).abs().amax(-1) > 1e-3).sum())
    assert blend > 1000 and peeled > 1000, (blend, peeled)
    s_grid = with_fields(pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu"), mix, "cpu", any_alpha_test=True)
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
    small = lambda s, c: render_layered(s, c, width=128, height=64)  # noqa: E731
    img_err = float((small(s_grid.to(dev), s_cam.to(dev)).cpu() - small(s_grid, s_cam)).abs().max())
    assert img_err <= SMALL_ATOL, img_err
    fields = ["diffuse", "roughness", "metallic", "fresnel_r0", "opacity"]
    layered_small = lambda s, c, width, height: render_layered(s, c, width=width, height=height)  # noqa: E731
    _, g_cpu = bench_loss_grads(pbr, s_grid, s_cam, 128, 64, fields, layered_small)
    _, g_dev = bench_loss_grads(pbr, s_grid.to(dev), s_cam.to(dev), 128, 64, fields, layered_small)
    grad_errs = {k: close(g_dev[k], g_cpu[k], GRAD_RTOL, GRAD_ATOL_FRAC, k) for k in fields}
    print(f"t. render_layered 2+2 at 1080p (rows 0-1 transparent, row 2 alpha-tested at 0.05): 5 frames median "
          f"{t_ms:.3f} ms, kernel-5 launches {ids_launches}; {blend} pixels show a transparent blend, "
          f"{peeled} the alpha peel-through; build/chip_smoke_layered.png mean RGB "
          f"{img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()}; 128x64 card vs CPU image {img_err:.2e}, "
          f"gradients " + ", ".join(f"{k} {v:.2e}" for k, v in grad_errs.items()) + f" [{smi}]")

    # u. The textured layered frame: pbr_scene's seeded pages, one textured
    #    material alpha-tested, one transparent.
    tex_scene, cache = textured
    f = alpha_test_fields(tex_scene.materials, cache, 0)
    f["transparent"] = tex_scene.materials.transparent.cpu().numpy().copy()
    f["opacity"] = tex_scene.materials.opacity.cpu().numpy().copy()
    f["transparent"][1], f["opacity"][1] = 1.0, 0.5
    tex = with_fields(tex_scene, f, dev, any_alpha_test=True).with_combined_textures(mode="quad")
    t_geom = pbr.flatten_scene_corners(tex, textured=True)
    t_clip = math3d.transform_points_h(t_geom.pos_w, cam.view_proj())
    t_trans = tex.materials.transparent[t_geom.face_material.long()] > 0.5
    t_first = ids_case("u", "textured first solid peel", t_clip, ~t_trans, True, floor0)
    ids_case("u", "textured second solid peel, behind the first", t_clip, ~t_trans, True, behind(t_first))
    # culled, the spheres hide few faces behind others; unculled, their back faces lie behind the first peel
    inner = ids_case("u", "textured solid faces behind the first peel (no culling)", t_clip, ~t_trans, False,
                     behind(t_first))
    assert inner["hits"] > 0 and bool((inner["depth"][inner["code"] >= 0] > behind(t_first)[inner["code"] >= 0]).all())
    ids_case("u", "textured transparent peel (no culling)", t_clip, t_trans, False, floor0)
    render_layered(tex, cam, width=WIDTH, height=HEIGHT)  # warm
    torch.cuda.synchronize()
    raster_row.IDS_KERNEL_LAUNCHES = 0
    u_ms, u_frame = frames(lambda: render_layered(tex, cam, width=WIDTH, height=HEIGHT), 3)
    u_launches = raster_row.IDS_KERNEL_LAUNCHES
    assert u_launches == 12 and bool(torch.isfinite(u_frame).all()), u_launches
    print(f"u. textured render_layered 2+2 at 1080p (pbr_scene, quad pages; material 0 alpha-tested, 1 "
          f"transparent): 3 frames median {u_ms:.3f} ms, kernel-5 launches {u_launches} [{smi}]")

    # v. render_wireframe (one kernel-5 launch) and render_ssaa(factor=2) (a
    #    3840x2160 render), each after its kernel against the plain version
    #    on that frame's own binning.
    g0 = pbr.flatten_scene_corners(grid)
    g0_clip = math3d.transform_points_h(g0.pos_w, cam.view_proj())
    ids_case("v", "wireframe raster (no tri_mask, no z_floor, no depth)", g0_clip, None, True, want_depth=False)
    wireframe = lambda: render_wireframe(grid, cam, width=WIDTH, height=HEIGHT)  # noqa: E731
    wireframe()  # warm
    torch.cuda.synchronize()
    raster_row.IDS_KERNEL_LAUNCHES = 0
    v_ms, wire = frames(wireframe, 3)
    assert raster_row.IDS_KERNEL_LAUNCHES == 3, raster_row.IDS_KERNEL_LAUNCHES
    wire_share = float((wire[..., :3] < 0.1).all(-1).float().mean())
    save_png(os.path.join("build", "chip_smoke_wireframe.png"), wire.cpu().numpy())
    assert 0.005 < wire_share < 0.5, wire_share
    table = grid.materials.props_table().contiguous()
    light_args = (lights.strength, lights.direction, lights.position, lights.spot_power, grid.ambient, cam.position)
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    mat_stride = raster_row.material_stride(grid.materials.num_materials, num_tris)
    uni0 = pack_shading_uniforms(*light_args, None)
    shade_kw = dict(y_offset=0, tile_w=128, mat_stride=mat_stride, num_dir=counts[0], num_point=counts[1],
                    num_spot=counts[2], want_gbuf=False)
    big_w, big_h = 2 * WIDTH, 2 * HEIGHT
    big_params = binning_params(num_tris, big_w, big_h)
    big = raster_row.bin_for_shade(g0_clip, g0.attrs, g0.face_material,
                                   width=big_w, height=big_h, rows=big_h, y_offset=0, tile_h=8, tile_w=128,
                                   cull_backface=True, **big_params)
    assert not bool(big.overflowed), "the 4K binning overflowed its pair cap"
    big_args = (big.starts, big.packed, big.pair_tri, table, uni0)
    big_kw = dict(width=big_w, rows=big_h, tile_h=8, apply_tonemap=True, **shade_kw)
    code_k, out_k, _ = raster_row.raster_shade_tiles_cuda(*big_args, **big_kw)
    code_p, out_p, _ = raster_row.raster_shade_tiles_plain(*big_args, **big_kw)
    torch.cuda.synchronize()
    assert int((code_k != code_p).sum()) == 0, "kernel 1 codes at 3840x2160 differ from the plain version's"
    big_err = float((out_k - out_p).abs().max())
    assert big_err <= RGBA_ATOL, big_err
    big_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*big_args, **big_kw), 20)
    print(f"v. kernel 1 vs plain at 3840x2160 (render's binning at res_scale 3): hit pixels "
          f"{int((code_k >= 0).sum())}, codes exact, RGBA max abs err {big_err:.3e}; kernel {big_ms:.3f} ms [{smi}]")
    ssaa = lambda: render_ssaa(grid, cam, width=WIDTH, height=HEIGHT, factor=2)  # noqa: E731
    ssaa()  # warm
    torch.cuda.synchronize()
    raster_row.KERNEL_LAUNCHES = 0
    ssaa_ms, aa = frames(ssaa, 3)
    assert raster_row.KERNEL_LAUNCHES == 3 and aa.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(aa).all())
    print(f"v. render_wireframe at 1080p: 3 frames median {v_ms:.3f} ms, one kernel-5 launch a frame, wire pixels "
          f"{wire_share:.4f} (build/chip_smoke_wireframe.png); render_ssaa(factor=2): a 3840x2160 render "
          f"(max span {big_params['max_span']}, pair cap {big_params['pairs_cap']}, pairs {int(big.starts[-1])}, "
          f"jumbo {int(big.starts[0])}, no overflow), 3 frames median {ssaa_ms:.3f} ms [{smi}]")

    # w. Kernel 7: the shade mode at raster_shade's JAX defaults (the v1
    #    binning at 4x128 tiles) against its plain version, then its bench step.
    sh9 = ibl.IBLMaps.build(torch.as_tensor(seeded_env(7, 256, 512), device=dev)).irradiance_sh9
    v1 = raster_row.bin_for_shade(g0_clip, g0.attrs, g0.face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT,
                                  y_offset=0, tile_h=4, tile_w=128, max_span=16, pairs_cap=None, big_cap=None,
                                  big2_span=0, big2_cap=None, cull_backface=True)
    assert not bool(v1.overflowed), "the v1 binning overflowed its pair cap"
    k7 = {}
    for mode in (False, True):
        uni = pack_shading_uniforms(*light_args, sh9 if mode else None)
        kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=4, tile_w=128, mat_stride=mat_stride,
                  num_dir=counts[0], num_point=counts[1], num_spot=counts[2], apply_tonemap=not mode, ibl=mode)
        args = (v1.starts, v1.packed, v1.pair_tri, table, uni)
        code_k, out_k, gbuf_k = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=True, v1=True, **kw)
        code_p, out_p, gbuf_p = raster_row.raster_shade_tiles_plain(*args, want_gbuf=True, **kw)
        torch.cuda.synchronize()
        assert int((code_k != code_p).sum()) == 0, f"kernel 7 (ibl={mode}) codes differ from the plain version's"
        err = (out_k - out_p).abs()
        tol = IBL_ATOL + IBL_RTOL * out_p.abs() if mode else RGBA_ATOL
        assert bool((err <= tol).all()), f"kernel 7 (ibl={mode}): max abs err {float(err.max()):.3e}"
        assert float((gbuf_k - gbuf_p).abs().max()) <= GBUF_ATOL
        hits = int((code_k >= 0).sum())
        ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, v1=True, **kw), 20)
        plain = cuda_ms(lambda: raster_row.raster_shade_tiles_plain(*args, want_gbuf=False, **kw), 3, 1)
        bnd = bound(raster_read_bytes(*args[:3], num_ch=7, **kw) + nbytes(table, uni, code_k, out_k),
                    raster_tests(v1.starts, v1.pair_tri, screen_xy(g0_clip, WIDTH, HEIGHT), **kw)
                    * RASTER_TEST_FLOPS
                    + hits * (plane_flops(7, False) + shade_flops(*counts, not mode, mode)))
        k7[mode] = dict(err=float(err.max()), ms=ms, plain_ms=plain, bound=bnd, code=code_k)
        print(f"w. kernel 7{'b (IBL)' if mode else ''} (shade mode, v1 binning, 4x128 tiles) vs plain at 1080p: "
              f"hit pixels {hits}, pairs {int(v1.starts[-1])}, jumbo {int(v1.starts[0])}, codes exact, max abs err "
              f"{float(err.max()):.3e}; kernel {ms:.3f} ms, plain version {plain:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) [{smi}]")
    row = raster_row.bin_for_shade(g0_clip, g0.attrs, g0.face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT,
                                   y_offset=0, tile_h=8, tile_w=128, cull_backface=True,
                                   **binning_params(num_tris, WIDTH, HEIGHT))
    code1, _, _ = raster_row.raster_shade_tiles_cuda(row.starts, row.packed, row.pair_tri, table, uni0, width=WIDTH,
                                                     rows=HEIGHT, tile_h=8, apply_tonemap=True, **shade_kw)
    diff = k7[False]["code"] != code1
    ys, xs = torch.nonzero(diff, as_tuple=True)
    n_diff = int(ys.numel())
    if n_diff:
        c7, c1 = k7[False]["code"][diff], code1[diff]
        assert bool(((c7 >= 0) & (c1 >= 0)).all()), "kernels 7 and 1 differ in coverage"
        assert depth_ties(g0_clip, WIDTH, HEIGHT, (ys, xs), c7 // mat_stride, c1 // mat_stride, exact=False)
    print(f"w. ids of kernel 7 (4x128 tiles) against kernel 1 (8x128, render's binning): {n_diff} pixels differ, "
          f"each a quantized-depth tie")

    def step(sh=None):
        """The bench loss through raster_shade[_ibl] with JAX's defaults →
        the material-table gradient."""
        leaf = table.detach().clone().requires_grad_()
        kw = dict(width=WIDTH, height=HEIGHT, num_materials=grid.materials.num_materials, num_dir=counts[0],
                  num_point=counts[1], num_spot=counts[2])
        base = (g0_clip, g0.attrs, g0.face_material, leaf, *light_args)
        out = raster_pallas.raster_shade_ibl(*base, sh, **kw) if sh is not None else raster_pallas.raster_shade(
            *base, **kw)
        (g,) = torch.autograd.grad(torch.mean(out.rgba[..., :3] ** 2), leaf)
        return g

    w = {}
    for mode, n, names in ((False, 5, ("SHADE_V1_KERNEL_LAUNCHES", "SHADE_BWD_LAUNCHES")),
                           (True, 3, ("SHADE_V1_IBL_KERNEL_LAUNCHES", "SHADE_BWD_IBL_LAUNCHES"))):
        sh = sh9 if mode else None
        step(sh)  # warm
        torch.cuda.synchronize()
        raster_row.KERNEL_LAUNCHES = raster_row.IBL_KERNEL_LAUNCHES = 0
        setattr(raster_row, names[0], 0)
        setattr(raster_pallas, names[1], 0)
        times, first = [], None
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = step(sh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches = (getattr(raster_row, names[0]), getattr(raster_pallas, names[1]))
            assert launches == (i + 1, i + 1), launches
            first = g if first is None else first
            assert torch.equal(g, first), "kernel-7 step gradients differ between steps"
        assert (raster_row.KERNEL_LAUNCHES, raster_row.IBL_KERNEL_LAUNCHES) == (0, 0), "a step ran kernel 1"
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        w[mode] = launches
        print(f"w. {n} bench steps through raster_shade{'_ibl' if mode else ''}(row_layout=False) (material table "
              f"gradient): median {statistics.median(times):.3f} ms, steps {[round(t, 3) for t in times]}, launches "
              f"(kernel 7{'b' if mode else ''}, kernel 3{'b' if mode else ''}) {launches}, the same bits every step "
              f"[{smi}]")

    return [
        kernel_entry("raster_ids", "raster_shade_row.cu", "ops/raster_pallas.py:70", ids_launches, max(ids_checks),
                     k5_ms, k5_plain_ms, k5_bound),
        kernel_entry("raster_shade_v1", "raster_shade_row.cu", "ops/raster_pallas.py:873", w[False][0],
                     k7[False]["err"], k7[False]["ms"], k7[False]["plain_ms"], k7[False]["bound"]),
        kernel_entry("raster_shade_v1_ibl", "raster_shade_row.cu", "ops/raster_pallas.py:873", w[True][0],
                     k7[True]["err"], k7[True]["ms"], k7[True]["plain_ms"], k7[True]["bound"]),
    ]


def soft_kernel_phase(pbr, grid, cam, dev, smi, ptxas) -> dict:
    """Phase x: kernel 5b, the dilated ids mode, against its plain version
    on ``render_soft``'s three peels of the 1080p grid. Returns its numbers
    on the first peel."""
    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_row

    margin = 3.0 * SOFT_SIGMA
    geom = pbr.flatten_scene_corners(grid)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    xy = screen_xy(clip, WIDTH, HEIGHT)
    v1_ids = dict(tile_h=16, tile_w=128, max_span=8, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)

    # x. Kernel 5b against its plain version on render_soft's three peels
    #    (culled, each behind the last; the first behind -inf): codes exact,
    #    depth bit-equal (+inf at background).
    floor = torch.full((HEIGHT, WIDTH), -torch.inf, device=dev)
    peels = []
    for k in range(SOFT_LAYERS):
        binned = raster_row.bin_for_shade(clip, None, None, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0,
                                          cull_backface=True, bbox_margin_px=margin, **v1_ids)
        hard = raster_row.bin_for_shade(clip, None, None, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0,
                                        cull_backface=True, **v1_ids)
        assert not bool(binned.overflowed), f"peel {k}: the dilated binning overflowed its pair cap"
        kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, mat_stride=1, want_depth=True,
                  z_floor=floor, margin=margin)
        args = (binned.starts, binned.packed, binned.pair_tri)
        code_k, depth_k = raster_row.raster_ids_tiles_cuda(*args, **kw)
        code_p, depth_p = raster_row.raster_ids_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        assert int((code_k != code_p).sum()) == 0, f"peel {k}: kernel 5b codes differ from the plain version's"
        assert torch.equal(depth_k, depth_p), f"peel {k}: kernel 5b depth is not bit-equal to the plain version's"
        hit = code_k >= 0
        assert bool(torch.isposinf(depth_k[~hit]).all()) and bool((depth_k[hit] > floor[hit]).all())
        ms = cuda_ms(lambda: raster_row.raster_ids_tiles_cuda(*args, **kw), 20)
        bnd = bound(raster_read_bytes(*args, num_ch=0, exact=True, **kw) + nbytes(code_k, depth_k),
                    raster_tests(*args[::2], xy, **kw) * RASTER_TEST_FLOPS)
        peels.append(dict(args=args, kw=kw, ms=ms, bound=bnd, hits=int(hit.sum())))
        print(f"x. kernel 5b vs plain, peel {k} (margin {margin} px, culled, 16x128 tiles): hit pixels "
              f"{int(hit.sum())}, pairs {int(binned.starts[-1])} with the margin / {int(hard.starts[-1])} without, "
              f"jumbo {int(binned.starts[0])}, codes exact, depth bit-equal; kernel {ms:.3f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); (pair, pixel) tests " + reject_share(args, xy, kw) + f" [{smi}]")
        floor = torch.where(torch.isfinite(depth_k), depth_k, floor).contiguous()
    p0 = peels[0]
    x_plain_ms = cuda_ms(lambda: raster_row.raster_ids_tiles_plain(*p0["args"], **p0["kw"]), 3, 1)
    regs = [line for line in ptxas if line.startswith("raster_ids_kernel")]
    print(f"x. kernel 5b at 1080p, peel 0: kernel {p0['ms']:.3f} ms, plain version {x_plain_ms:.3f} ms; ptxas "
          f"{regs} [{smi}]")
    return dict(ms=p0["ms"], plain_ms=x_plain_ms, bound=p0["bound"])


def soft_phases(pbr, grid, cam, dev, smi, ptxas):
    """Phases x-aa: the soft rasterizer (kernel 5b, the dilated ids mode,
    under ``render_soft``) and the app loop on the 1080p grid. Returns the
    JSON entry of kernel 5b."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.app import RenderLoop, turntable_inputs
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row, raster_soft
    from physically_based_renderer_tpu_torch.renderer import check_raster_capacity, render_checked, render_soft
    from physically_based_renderer_tpu_torch.utils.config import RenderConfig
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    x = soft_kernel_phase(pbr, grid, cam, dev, smi, ptxas)
    margin, layers = 3.0 * SOFT_SIGMA, SOFT_LAYERS

    # y. Five render_soft frames: per frame 3 kernel-5b and 3 kernel-6
    #    launches, kernel 1 and margin-0 kernel 5 never.
    soft = lambda s=grid, c=cam: render_soft(s, c, width=WIDTH, height=HEIGHT, sigma=SOFT_SIGMA)  # noqa: E731
    soft()  # warm
    torch.cuda.synchronize()
    counters = ("IDS_MARGIN_KERNEL_LAUNCHES", "IDS_KERNEL_LAUNCHES", "KERNEL_LAUNCHES")
    for name in counters:
        setattr(raster_row, name, 0)
    raster_pallas.SHADE_FWD_LAUNCHES = raster_pallas.SHADE_BWD_LAUNCHES = 0
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        frame = soft()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    y_launches = tuple(getattr(raster_row, n) for n in counters)
    assert y_launches == (5 * layers, 0, 0), y_launches
    y_fwd = raster_pallas.SHADE_FWD_LAUNCHES
    assert (y_fwd, raster_pallas.SHADE_BWD_LAUNCHES) == (5 * layers, 0)
    assert frame.shape == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(frame).all())
    img = frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_soft.png"), img)
    hard_img = pbr.render(grid, cam, width=WIDTH, height=HEIGHT)[..., :3]
    soft_share = float(((frame - hard_img).abs().amax(-1) > 1e-2).float().mean())
    s_grid = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
    s_clip = math3d.transform_points_h(pbr.flatten_scene_corners(s_grid).pos_w, s_cam.view_proj())
    peel_kw = dict(width=128, height=64, num_layers=layers, edge_margin_px=margin)
    ids_cpu, _ = raster_soft.peel_layers(s_clip, None, **peel_kw)
    ids_dev, _ = raster_soft.peel_layers(s_clip.to(dev), None, **peel_kw)
    assert torch.equal(ids_dev.cpu(), ids_cpu), "128x64 soft peels differ between the card and the CPU"
    small_err = float((render_soft(s_grid.to(dev), s_cam.to(dev), width=128, height=64).cpu()
                       - render_soft(s_grid, s_cam, width=128, height=64)).abs().max())
    assert small_err <= SMALL_ATOL, small_err
    print(f"y. render_soft at 1080p (K {layers}, sigma {SOFT_SIGMA}, gamma 1e-2, culled): 5 frames median "
          f"{statistics.median(times):.3f} ms, frames {[round(t, 3) for t in times]}; launches (kernel 5b, kernel 5, "
          f"kernel 1) {y_launches}, kernel 6 {y_fwd}; build/chip_smoke_soft.png mean RGB "
          f"{img.reshape(-1, 3).mean(0).round(4).tolist()}, {soft_share:.4f} of pixels > 1e-2 from render's; "
          f"128x64: peels equal card vs CPU, image max abs err {small_err:.2e} [{smi}]")

    # z. Five geometry steps: mean(img²) back to the draws' world matrices and
    #    the material bank; each step 3 launches of kernels 5b, 6 and 3.
    fields = ["diffuse", "roughness", "metallic", "fresnel_r0", "worlds"]
    soft_small = lambda s, c, width, height: render_soft(s, c, width=width, height=height)  # noqa: E731
    step = lambda: bench_loss_grads(pbr, grid, cam, WIDTH, HEIGHT, fields, soft_small)  # noqa: E731
    step()  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    raster_row.IDS_MARGIN_KERNEL_LAUNCHES = 0
    raster_pallas.SHADE_FWD_LAUNCHES = raster_pallas.SHADE_BWD_LAUNCHES = 0
    step_ms, first, same = [], None, True
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = (raster_row.IDS_MARGIN_KERNEL_LAUNCHES, raster_pallas.SHADE_FWD_LAUNCHES,
                    raster_pallas.SHADE_BWD_LAUNCHES)
        assert launches == (layers * (i + 1),) * 3, launches
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        first = first or grads
        same = same and all(torch.equal(grads[k], first[k]) for k in grads)
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    assert float(grads["worlds"].abs().sum()) > 0 and float(grads["diffuse"].abs().sum()) > 0
    _, g_cpu = bench_loss_grads(pbr, s_grid, s_cam, 128, 64, fields, soft_small)
    _, g_dev = bench_loss_grads(pbr, s_grid.to(dev), s_cam.to(dev), 128, 64, fields, soft_small)
    grad_errs = {k: close(g_dev[k], g_cpu[k], GRAD_RTOL, GRAD_ATOL_FRAC, k) for k in fields}
    print(f"z. render_soft geometry step at 1080p (fwd+bwd of mean(img^2) to the worlds and materials): median "
          f"{statistics.median(step_ms):.3f} ms, steps {[round(t, 3) for t in step_ms]}, peak {peak_mib:.1f} MiB "
          f"above the scene, launches (5b, 6, 3) {launches}, loss {float(loss):.6f}; the same gradient bits every "
          f"step: {same}; 128x64 gradients card vs CPU " + ", ".join(f"{k} {v:.2e}" for k, v in grad_errs.items())
          + f" [{smi}]")

    # aa. The app: render_checked refuses a 128-pair cap and renders with
    #     check_raster_capacity's suggestion; RenderLoop heals the same cap on
    #     its first frame, then runs 10 turntable frames.
    try:
        render_checked(grid, cam, width=WIDTH, height=HEIGHT, raster_pairs_cap=128)
        raise AssertionError("render_checked rendered with a 128-pair cap")
    except RuntimeError as e:
        refused = str(e)
    stats = check_raster_capacity(grid, cam, width=WIDTH, height=HEIGHT, pairs_cap=128)
    assert stats["overflowed"] and stats["suggested_pairs_cap"] >= stats["num_pairs"], stats
    # tile_h=8: render_checked validates JAX's 4-row binning unless told the
    # tile, which needs more pairs than render's 8-row one that the
    # suggestion counts
    checked = render_checked(grid, cam, width=WIDTH, height=HEIGHT, tile_h=8,
                             raster_pairs_cap=stats["suggested_pairs_cap"])
    assert bool(torch.isfinite(checked).all())
    loop = RenderLoop(grid, cam, RenderConfig(width=WIDTH, height=HEIGHT, raster_pairs_cap=128))
    t0 = time.perf_counter()
    first_frame = loop.step()
    heal_ms = (time.perf_counter() - t0) * 1e3
    healed = loop.config.raster_pairs_cap
    assert healed == stats["suggested_pairs_cap"] and first_frame.shape == (HEIGHT, WIDTH, 4)
    raster_row.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    frames = loop.run_sequence(turntable_inputs(10))
    loop_ms = (time.perf_counter() - t0) * 1e3 / 10
    assert raster_row.KERNEL_LAUNCHES == 10 and all(np.isfinite(f).all() for f in frames)
    yaw = float(loop.camera.yaw)
    assert abs(yaw - math.radians(20.0)) < 1e-4, yaw
    st = loop.stats
    print(f"aa. render_checked with cap 128 raised ({refused[:60]}...); check_raster_capacity: {stats}; "
          f"render_checked at the suggestion renders; RenderLoop(1920x1080, cap 128) healed its cap to {healed} "
          f"on the first frame ({heal_ms:.1f} ms with the check), then 10 turntable frames at {loop_ms:.3f} ms "
          f"each (host clock, frame back as NumPy), yaw {math.degrees(yaw):.2f} deg; FrameStats(frames="
          f"{st.frames}, fps={st.fps:.2f}, mspf={st.mspf:.3f}) [{smi}]")

    return [kernel_entry("raster_ids_margin", "raster_shade_row.cu", "ops/raster_pallas.py:70", y_launches[0], 0.0,
                         x["ms"], x["plain_ms"], x["bound"])]


ROUTE_COUNTERS = {  # render's kernel routes → the launch counter of their kernel (ops/raster_row.py)
    "pallas_shade_row": "KERNEL_LAUNCHES",  # kernel 1
    "pallas_shade_ibl_row": "IBL_KERNEL_LAUNCHES",  # kernel 1b
    "pallas_shade": "SHADE_V1_KERNEL_LAUNCHES",  # kernel 7
    "pallas_shade_ibl": "SHADE_V1_IBL_KERNEL_LAUNCHES",  # kernel 7b
    "pallas_gbuf": "GBUF_V1_KERNEL_LAUNCHES",  # kernel 4
    "pallas_gbuf_row": "GBUF_KERNEL_LAUNCHES",  # kernel 2
    "pallas": "IDS_KERNEL_LAUNCHES",  # kernel 5
}
ROUTE_TIE_SHARE = 2e-3  # pixels a route's frame may differ from kernel 1's by > RGBA_ATOL: depth ties (the CPU test's)
TILE_KERNELS = ("raster_shade_tiles_cuda", "raster_gbuffer_tiles_cuda", "raster_ids_tiles_cuda")  # ops/raster_row.py
ROUTE_RASTERS = ("raster_shade", "raster_shade_ibl", "raster_gbuffer", "rasterize_binned")  # renderer.py's names


def recording(targets):
    """Wrap each ``(module, name)`` of ``targets`` so that every call appends
    ``(name, args, kwargs, result)`` to the returned list; the returned
    ``restore()`` puts the originals back."""
    calls, saved = [], [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(name, fn):
        def recorded(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return recorded

    for m, n, fn in saved:
        setattr(m, n, wrap(n, fn))

    def restore():
        for m, n, fn in saved:
            setattr(m, n, fn)
    return calls, restore


def launch_vs_plain(name, args, kw, out) -> str:
    """Hold one recorded tile-kernel launch (``TILE_KERNELS``) against its
    plain version on the same inputs: codes exact; the shade mode's RGBA
    within RGBA_ATOL (its IBL channels IBL_ATOL + IBL_RTOL·|ref|), the
    G-buffer's attributes within GBUF_ATOL and its depth DEPTH_ATOL, the ids
    mode's depth bit-equal. Returns a summary."""
    from physically_based_renderer_tpu_torch.ops import raster_row

    kw = {k: v for k, v in kw.items() if k != "v1"}  # the launch counter's key; the plain versions have none
    plain = getattr(raster_row, name.replace("_cuda", "_plain"))(*args, **kw)
    code_k, code_p = out[0], plain[0]
    assert torch.equal(code_k, code_p), f"{name}: {int((code_k != code_p).sum())} codes differ from the plain version's"
    if name == "raster_shade_tiles_cuda":
        err = (out[1] - plain[1]).abs()
        tol = IBL_ATOL + IBL_RTOL * plain[1].abs() if kw["ibl"] else RGBA_ATOL
        assert bool((err <= tol).all()), f"{name}: max abs err {float(err.max()):.3e}"
        return f"codes exact, {'IBL channels' if kw['ibl'] else 'RGBA'} max abs err {float(err.max()):.3e}"
    if name == "raster_gbuffer_tiles_cuda":
        attr_err = float((out[1][..., :-1] - plain[1][..., :-1]).abs().max())
        depth_err = float((out[1][..., -1] - plain[1][..., -1]).abs().max())
        assert attr_err <= GBUF_ATOL and depth_err <= DEPTH_ATOL, (name, attr_err, depth_err)
        return f"codes exact, attrs max abs err {attr_err:.3e}, depth {depth_err:.3e}"
    assert (out[1] is None) == (plain[1] is None) and (out[1] is None or torch.equal(out[1], plain[1])), name
    return "codes exact" + ("" if out[1] is None else ", depth bit-equal")


def frame_device_ms(fn, frames: int = 5) -> list[float]:
    """The device busy time of each of ``frames`` calls of ``fn``, each
    followed by a synchronize: the summed duration of the CUDA kernels, copies
    and fills that ``torch.profiler`` records in its window (a frame's host
    gaps are not device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(frames):
            with torch.profiler.record_function(f"chip_smoke_frame_{i}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the frame markers' host ranges (record_function also leaves a device-side annotation of the same name)
    starts = sorted(e.time_range.start for e in events
                    if e.name.startswith("chip_smoke_frame_") and e.device_type != cuda)
    assert len(starts) == frames, len(starts)
    busy = [0.0] * frames
    for e in events:
        if e.device_type == cuda and not e.name.startswith("chip_smoke_frame_"):
            i = max(0, sum(1 for t in starts if t <= e.time_range.start) - 1)
            busy[i] += e.time_range.elapsed_us() / 1e3
    assert sum(busy) > 0, "the profiler recorded no device time"
    return busy


def route_phases(pbr, grid, cam, dev, smi, ptxas, textured):
    """Phases ab-ad: render's raster routes at 1080p, the indexed input of
    kernels 5, 5b and 4, the CPU oracles and the scene graph on the card.
    ``textured`` is phase m's (pbr_scene, asset cache). Returns the routes'
    frame device times (ms, median of 5)."""
    from physically_based_renderer_tpu_torch import math3d, renderer
    from physically_based_renderer_tpu_torch.models import mesh as pmesh
    from physically_based_renderer_tpu_torch.models import scene_graph
    from physically_based_renderer_tpu_torch.models.scene import flatten_scene, translation_world
    from physically_based_renderer_tpu_torch.ops import ibl, raster, raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.renderer import binning_params
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    # ab. Every kernel route of render(raster_backend=) at 1080p: 5 frames each,
    #     each frame's device time, exactly the route's kernel once a frame; the
    #     ids of the route's own raster in its render call against kernel 1's
    #     (depth ties only), that call's launch against its plain version on the
    #     inputs the route gave it, and its frame against kernel 1's.
    env = torch.as_tensor(seeded_env(7, 256, 512), device=dev)
    ibl_grid = dataclasses.replace(grid, env_map=env, ibl=ibl.IBLMaps.build(env))
    clip = math3d.transform_points_h(pbr.flatten_scene_corners(grid).pos_w, cam.view_proj())
    mats = grid.materials
    auto = {False: pbr.render(grid, cam, width=WIDTH, height=HEIGHT),
            True: pbr.render(ibl_grid, cam, width=WIDTH, height=HEIGHT)}
    targets = [(raster_row, n) for n in TILE_KERNELS] + [(renderer, n) for n in ROUTE_RASTERS]
    route_ms, ids1 = {}, None
    for route, counter in ROUTE_COUNTERS.items():  # kernel 1's route first: the others' ids are held against its
        is_ibl = "ibl" in route
        scene = ibl_grid if is_ibl else grid
        draw = lambda: pbr.render(scene, cam, width=WIDTH, height=HEIGHT, raster_backend=route)  # noqa: E731
        calls, restore = recording(targets)
        try:
            frame = draw()  # warm; its raster's outputs and its kernel launch are recorded
        finally:
            restore()
        rasters = [c[3] for c in calls if c[0] in ROUTE_RASTERS]
        launches_rec = [c for c in calls if c[0] in TILE_KERNELS]
        assert len(rasters) == 1 and len(launches_rec) == 1, (route, [c[0] for c in calls])
        held = launch_vs_plain(*launches_rec[0])
        torch.cuda.synchronize()
        for name in ROUTE_COUNTERS.values():
            setattr(raster_row, name, 0)
        raster_pallas.SHADE_BWD_LAUNCHES = raster_pallas.SHADE_BWD_IBL_LAUNCHES = 0
        busy = frame_device_ms(draw)
        launches = {name: getattr(raster_row, name) for name in ROUTE_COUNTERS.values()}
        want = {name: 5 * (name == counter) for name in ROUTE_COUNTERS.values()}
        assert launches == want and raster_pallas.SHADE_BWD_LAUNCHES == 0, (route, launches)
        assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all()), route
        ref = auto[is_ibl]
        ids = rasters[0].tri_id
        if ids1 is None:
            ids1 = ids
        diff = ids != ids1
        n_diff = int(diff.sum())
        if n_diff:
            ys, xs = torch.nonzero(diff, as_tuple=True)
            assert bool(((ids[diff] >= 0) & (ids1[diff] >= 0)).all()), f"{route}: coverage differs from kernel 1's"
            # kernel 1 keeps the first drawn of a quantized tie, kernel 5 the nearer exact depth
            assert depth_ties(clip, WIDTH, HEIGHT, (ys, xs), ids[diff], ids1[diff], exact=False), route
        tol = IBL_IMAGE_ATOL if is_ibl else RGBA_ATOL
        off = float(((frame - ref).abs().amax(-1) > tol).float().mean())
        if route.endswith("_row") and "gbuf" not in route:
            assert torch.equal(frame, ref), f"{route} is not bit-equal to render's 'auto' frame"
        assert off <= ROUTE_TIE_SHARE, f"{route}: {off:.4%} of pixels differ from kernel 1's frame by > {tol}"
        route_ms[route] = statistics.median(busy)
        if route in ("pallas", "pallas_gbuf"):
            save_png(os.path.join("build", f"chip_smoke_route_{route}.png"), frame.cpu().numpy())
        lkw = launches_rec[0][2]
        regs = ""
        if route == "pallas_gbuf_row":
            ppt = raster_row.pixels_per_thread(lkw["tile_h"] * lkw["tile_w"])
            inst = f"raster_gbuffer_row_kernel<{ppt},{lkw['num_ch']}>"
            regs = f"; ptxas {[line for line in ptxas if line.startswith(inst)]}"
        print(f"ab. render(raster_backend={route!r}) at 1080p{' (IBL)' if is_ibl else ''}: device time a frame "
              f"{[round(t, 3) for t in busy]} ms (median {route_ms[route]:.3f}); launches {launches} over 5 frames; "
              f"the launch ({launches_rec[0][0]}, {lkw['tile_h']}x{lkw['tile_w']} tiles) vs its plain version on "
              f"the route's inputs: {held}{regs}; the route's ids vs kernel 1's: {n_diff} pixels differ, each a "
              f"quantized-depth tie; {off:.5f} of pixels > {tol} from the 'auto' frame [{smi}]")

    # ac. Indexed input: flatten_scene's (V, 4) clip with tris against the
    #     corner-major clip[tris], kernel by kernel, bit for bit; each launch
    #     against its plain version.
    flat = flatten_scene(grid)
    flat_cpu = flatten_scene(grid.to("cpu"))
    pos_err = float((flat.pos_w.cpu() - flat_cpu.pos_w).abs().max())
    assert pos_err <= 1e-6 * float(flat_cpu.pos_w.abs().max()), pos_err
    assert torch.equal(flat.tris.cpu(), flat_cpu.tris)
    vclip = math3d.transform_points_h(flat.pos_w, cam.view_proj())
    tris = flat.tris
    cclip = vclip[tris]
    vattrs = torch.cat([flat.pos_w, flat.normal_w], -1)
    ids_kw = dict(width=WIDTH, height=HEIGHT, return_depth=True, face_material=flat.face_material,
                  num_materials=mats.num_materials)

    def check_ids(label, margin=0.0, z_floor=None, cull=True):
        kw = dict(ids_kw, edge_margin_px=margin, z_floor=z_floor, cull_backface=cull)
        counter = "IDS_MARGIN_KERNEL_LAUNCHES" if margin else "IDS_KERNEL_LAUNCHES"
        before = getattr(raster_row, counter)
        a = raster_pallas.rasterize_binned(vclip, tris, **kw)
        b = raster_pallas.rasterize_binned(cclip, None, **kw)
        assert getattr(raster_row, counter) == before + 2, label
        assert torch.equal(a.tri_id, b.tri_id) and torch.equal(a.mat_id, b.mat_id) and torch.equal(a.depth, b.depth), \
            f"{label}: indexed input differs from corner-major"
        binned = raster_row.bin_for_shade(vclip, None, None, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0,
                                          tile_h=16, tile_w=128, max_span=8, pairs_cap=None, big_cap=None,
                                          big2_span=0, big2_cap=None, cull_backface=cull, bbox_margin_px=margin,
                                          tris=tris)
        tkw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, mat_stride=1, want_depth=True,
                   z_floor=z_floor, margin=margin)
        args = (binned.starts, binned.packed, binned.pair_tri)
        code_k, depth_k = raster_row.raster_ids_tiles_cuda(*args, **tkw)
        code_p, depth_p = raster_row.raster_ids_tiles_plain(*args, **tkw)
        assert torch.equal(code_k, code_p) and torch.equal(depth_k, depth_p), f"{label}: kernel vs plain"
        assert torch.equal(code_k, a.tri_id), label
        print(f"ac. kernel {label} on indexed input (V {vclip.shape[0]}, T {tris.shape[0]}): ids, material codes "
              f"and depth bit-equal to the corner-major input; the launch vs its plain version: codes exact, depth "
              f"bit-equal; hit pixels {int((code_k >= 0).sum())}")
        return a

    first = check_ids("5 (solid peel)")
    check_ids("5 (z_floor peel behind it, no culling)", z_floor=torch.where(first.tri_id >= 0, first.depth,
                                                                            -torch.inf), cull=False)
    check_ids("5b (margin 3 px)", margin=3.0)

    def check_gbuf(label, scene_, vclip_, t_, vattrs_, fm):
        kw = dict(width=WIDTH, height=HEIGHT, num_materials=scene_.materials.num_materials,
                  **binning_params(t_.shape[0], WIDTH, HEIGHT, row_layout=False))
        before = raster_row.GBUF_V1_KERNEL_LAUNCHES
        a = raster_pallas.rasterize_binned_gbuffer(vclip_, vattrs_, fm, tris=t_, **kw)
        b = raster_pallas.rasterize_binned_gbuffer(vclip_[t_], vattrs_[t_], fm, **kw)
        assert raster_row.GBUF_V1_KERNEL_LAUNCHES == before + 2, label
        assert (torch.equal(a.tri_id, b.tri_id) and torch.equal(a.attrs, b.attrs) and torch.equal(a.depth, b.depth)
                and not bool(a.overflowed)), f"{label}: indexed input differs from corner-major"
        binned = raster_row.bin_for_shade(vclip_, vattrs_, fm, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0,
                                          tile_h=16, tile_w=128, cull_backface=True, tris=t_,
                                          **{k: v for k, v in kw.items() if k not in ("width", "height",
                                                                                    "num_materials")})
        num_ch = vattrs_.shape[-1] + 1
        tkw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, num_ch=num_ch, z_floor=None,
                   mat_stride=raster_row.material_stride(scene_.materials.num_materials, t_.shape[0]))
        args = (binned.starts, binned.packed, binned.pair_tri)
        code_k, gb_k = raster_row.raster_gbuffer_tiles_cuda(*args, v1=True, **tkw)
        code_p, gb_p = raster_row.raster_gbuffer_tiles_plain(*args, **tkw)
        err = float((gb_k - gb_p).abs().max())
        assert torch.equal(code_k, code_p) and err <= GBUF_ATOL, (label, err)
        print(f"ac. kernel 4 ({label}) on indexed input: ids, material ids, attributes and depth bit-equal to the "
              f"corner-major input; the launch vs its plain version: codes exact, G-buffer max abs err {err:.2e}; "
              f"hit pixels {int((code_k >= 0).sum())}")

    check_gbuf("C = 6, the grid", grid, vclip, tris, vattrs, flat.face_material)
    pbr_scene_ = textured[0]
    pflat = flatten_scene(pbr_scene_)
    pclip = math3d.transform_points_h(pflat.pos_w, cam.view_proj())
    pattrs = torch.cat([pflat.pos_w, pflat.normal_w, pflat.tangent_w, pflat.bitangent_w, pflat.uv], -1)
    check_gbuf("C = 14, pbr_scene with seeded pages", pbr_scene_, pclip, pflat.tris, pattrs, pflat.face_material)
    print(f"ac. flatten_scene on the card vs the CPU: positions max abs err {pos_err:.2e} (bound 1e-6·max)")

    # ad. The oracles on the card at 320x180 against kernel 5, render's oracle
    #     routes, and a scene lowered from a graph of every mesh builder.
    sw, sh = 320, 180
    small = pbr.scenes.red_sphere_grid_scene(16, 8, device=dev)
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=sw / sh, device=dev)
    s_clip = math3d.transform_points_h(pbr.flatten_scene_corners(small).pos_w, s_cam.view_proj())
    k5 = raster_pallas.rasterize_binned(s_clip, None, width=sw, height=sh).tri_id
    t0 = time.perf_counter()
    tiled = raster.rasterize(s_clip, None, width=sw, height=sh, tri_block=128)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    brute = raster.rasterize_brute(s_clip, None, width=sw, height=sh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ties = {}
    for name, ids in (("rasterize", tiled), ("rasterize_brute", brute)):
        diff = ids != k5
        ties[name] = int(diff.sum())
        if ties[name]:
            ys, xs = torch.nonzero(diff, as_tuple=True)
            assert bool(((ids[diff] >= 0) & (k5[diff] >= 0)).all()), f"{name}: coverage differs from kernel 5's"
            assert depth_ties(s_clip, sw, sh, (ys, xs), ids[diff], k5[diff], exact=True), name
    assert torch.equal(tiled, brute), "the tiled oracle differs from the brute one"
    oracle_frames = {r: pbr.render(small, s_cam, width=sw, height=sh, raster_backend=r) for r in ("pallas", "jnp",
                                                                                                  "brute")}
    for r in ("jnp", "brute"):
        off = float(((oracle_frames[r] - oracle_frames["pallas"]).abs().amax(-1) > RGBA_ATOL).float().mean())
        assert off <= ROUTE_TIE_SHARE, (r, off)
    print(f"ad. oracles on the card at {sw}x{sh} ({s_clip.shape[0]} triangles): rasterize (tri_block 128) "
          f"{(t1 - t0) * 1e3:.1f} ms, rasterize_brute {(t2 - t1) * 1e3:.1f} ms (host clock); ids vs kernel 5: "
          f"{ties} pixels differ (each an exact-depth tie); render(raster_backend='jnp' / 'brute') frames within "
          f"{RGBA_ATOL} of 'pallas' [{smi}]")

    sphere = pmesh.sphere_mesh(0.5, 12, 6, device=dev)
    merged, sub = pmesh.merge_meshes([pmesh.box_mesh(0.6, 0.6, 0.6, device=dev), sphere])
    builders = [pmesh.box_mesh(1.0, 1.0, 1.0, device=dev), pmesh.geosphere_mesh(0.7, 3, device=dev),
                pmesh.cylinder_mesh(0.5, 0.3, 1.4, 32, 4, device=dev), pmesh.capsule_mesh(0.4, 0.8, 24, 12, device=dev),
                pmesh.grid_mesh(2.0, 2.0, 9, 9, device=dev), pmesh.quad_mesh(1.5, 1.5, device=dev),
                pmesh.subdivide(sphere)]
    root = scene_graph.Node("root", transform=translation_world(0.0, 0.0, 2.0))
    tilt = math3d.rotation_x(-1.2, device="cpu").numpy()  # the grid and the quad face the camera
    for i, m in enumerate(builders):
        place = translation_world(-7.0 + 2.0 * i, 0.5 * (i % 2), 0.0)
        node = root.add(scene_graph.Node(f"n{i}", transform=tilt @ place if i in (4, 5) else place))
        node.components.append(scene_graph.MeshComponent(mesh=m, material=(7 * i + 3) % mats.num_materials))
    root.add(scene_graph.Node("merged", transform=translation_world(7.0, 0.0, 0.0))).components.append(
        scene_graph.MeshComponent(mesh=merged, face_materials=(sub * 7) % mats.num_materials))
    root.add(scene_graph.Node("off", active=False)).components.append(scene_graph.MeshComponent(mesh=sphere))
    root.add(scene_graph.Node("point", transform=translation_world(0.0, 3.0, -3.0))).components.append(
        scene_graph.LightComponent(kind="point", strength=(6.0, 6.0, 6.0)))
    spot = root.add(scene_graph.Node("spot", transform=translation_world(0.0, 0.0, -6.0)))
    spot.components.append(scene_graph.LightComponent(kind="spot", strength=(3.0, 3.0, 3.0), spot_power=4.0))
    root.components.append(scene_graph.LightComponent(kind="directional", strength=(0.4, 0.4, 0.4)))
    lowered = scene_graph.lower(root, mats)
    assert len(lowered.draws) == len(builders) + 1 and lowered.lights.num_point == 1 and lowered.lights.num_spot == 1
    g_tris = sum(d.num_instances * d.mesh.num_triangles for d in lowered.draws)
    g_cam = pbr.Camera.create(position=(0.0, 1.0, -8.0), aspect=WIDTH / HEIGHT, device=dev)
    draw = lambda: pbr.render(lowered, g_cam, width=WIDTH, height=HEIGHT)  # noqa: E731
    img = draw()
    raster_row.KERNEL_LAUNCHES = 0
    busy = frame_device_ms(draw)
    assert raster_row.KERNEL_LAUNCHES == 5 and bool(torch.isfinite(img).all())
    fg = float(((img[..., :3] - 0.5).abs().amax(-1) > 1e-6).float().mean())
    assert fg > 0.05, fg
    save_png(os.path.join("build", "chip_smoke_scene_graph.png"), img.cpu().numpy())
    print(f"ad. scene_graph.lower of box, geosphere, cylinder, capsule, grid, quad, subdivided and merged meshes, a "
          f"point, a spot and a directional light: {len(lowered.draws)} draws, {g_tris} triangles; render at 1080p "
          f"device time a frame {[round(t, 3) for t in busy]} ms, kernel 1 once a frame, {fg:.4f} of pixels "
          f"foreground; build/chip_smoke_scene_graph.png [{smi}]")
    return route_ms



OBJ_GROUPS = 5  # usemtl groups of the grid OBJ (mori_knob has 5 materials)
FIXTURE_DIR = os.path.join("tests", "data")  # the committed JPEG fixtures and their manifest
AE_FIXTURES = ("page_color_1024.jpg", "page_gray_1024.jpg", "background_3k.jpg")  # baseline; phase ah the rest
PROGRESSIVE_TWINS = {"page_color_1024_progressive.jpg": "page_color_1024.jpg",
                     "page_gray_1024_progressive.jpg": "page_gray_1024.jpg"}
PACKED_P995, PACKED_MEAN, PACKED_FAR, PACKED_FAR_SHARE = 0.02, 1e-3, 0.05, 2e-3  # JAX's packed-vs-f32 bounds


def fixture_manifest() -> dict:
    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        return json.load(f)


def write_grid_obj(directory: str, pbr) -> str:
    """The bench grid (``red_sphere_grid_scene(64, 32)``: 49 spheres, 194,432
    triangles) merged into one OBJ with v/vt/vn (a sphere's vertices moved by
    its world matrix, uv written with v flipped back), its inner bands as
    4-corner faces (``f c a b d`` fans into the mesh's own (a, b, c) and
    (c, b, d)), the caps as triangles, in OBJ_GROUPS ``usemtl`` groups of
    consecutive spheres, and its MTL with maps (``write_grid_mtl``)."""
    import numpy as np

    from physically_based_renderer_tpu_torch.models.mesh import _sphere_arrays

    os.makedirs(directory, exist_ok=True)
    pos, nrm, _, _, uv, tris = _sphere_arrays(1.0, 64, 32)
    nv = pos.shape[0]
    grid = pbr.scenes.red_sphere_grid_scene(64, 32, device="cpu")
    shifts = grid.draws[0].worlds[:, 3, :3].numpy()
    n_sph = shifts.shape[0]
    inner = tris[64:-64].reshape(-1, 2, 3)  # (a, b, c), (c, b, d) pairs
    assert (inner[:, 0, 2] == inner[:, 1, 0]).all() and (inner[:, 0, 1] == inner[:, 1, 1]).all()
    quads = np.stack([inner[:, 0, 2], inner[:, 0, 0], inner[:, 0, 1], inner[:, 1, 2]], -1)
    lines = ["# the bench grid as one OBJ (chip_smoke.write_grid_obj)", "mtllib grid.mtl"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in (pos[None] + shifts[:, None]).reshape(-1, 3)]
    lines += [f"vt {u:.9g} {1.0 - v:.9g}" for u, v in np.tile(uv, (n_sph, 1))]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in np.tile(nrm, (n_sph, 1))]
    group = -1
    for s in range(n_sph):
        if s * OBJ_GROUPS // n_sph != group:
            group = s * OBJ_GROUPS // n_sph
            lines.append(f"usemtl grid_{group}")
        for rows in (tris[:64], quads, tris[-64:]):
            lines += ["f " + " ".join(f"{i}/{i}/{i}" for i in r) for r in (rows + s * nv + 1).tolist()]
    path = os.path.join(directory, "grid.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    write_grid_mtl(directory, maps=True)
    return path


def write_grid_mtl(directory: str, maps: bool) -> None:
    """The grid OBJ's MTL: Kd/Ks/Ns/d/Ke/Pr/Pm on every material; with
    ``maps``, material 0's map_Kd the colour JPEG fixture and its map_Pr,
    map_Pm and map_bump 1024² PNGs written by ``save_png`` from
    ``seeded_page``, material 1's map_Kd the gray JPEG fixture."""
    import shutil

    import numpy as np

    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    mtl = []
    for g in range(OBJ_GROUPS):
        mtl += [f"newmtl grid_{g}", f"Kd {0.9 - 0.15 * g:.2f} {0.3 + 0.1 * g:.2f} 0.2", "Ks 0.04 0.04 0.04",
                f"Ns {32 * (g + 1)}", f"Pr {0.2 + 0.15 * g:.2f}", f"Pm {0.25 * (g % 4):.2f}", "d 1",
                f"Ke {0.02 * g:.2f} 0 0"]
        if maps and g == 0:
            mtl += ["map_Kd maps/page_color_1024.jpg", "map_Pr maps/roughness.png", "map_Pm maps/metallic.png",
                    "map_bump maps/normal.png"]
        if maps and g == 1:
            mtl += ["map_Kd maps/page_gray_1024.jpg"]
    with open(os.path.join(directory, "grid.mtl"), "w") as f:
        f.write("\n".join(mtl) + "\n")
    if maps:
        os.makedirs(os.path.join(directory, "maps"), exist_ok=True)
        for name in ("page_color_1024.jpg", "page_gray_1024.jpg"):
            shutil.copyfile(os.path.join(FIXTURE_DIR, name), os.path.join(directory, "maps", name))
        rng = np.random.default_rng(31)
        for slot in ("roughness", "metallic", "normal"):
            save_png(os.path.join(directory, "maps", f"{slot}.png"), seeded_page(rng, 1024, slot))


def write_asset_tree(root: str, pbr) -> str:
    """A temporary tree laid out like the reference's Assets: every texture
    set of ``scenes.TEXTURED_SPHERES`` as 128² PNG pages
    (``seeded_texture_pages``), the rustediron set's diffuse and metallic
    maps the colour and gray JPEG fixtures and its roughness and normal maps
    512² PNGs; the Chelsea_Stairs sIBL set: a descriptor, the ``_3k`` JPEG
    fixture as its background and ``seeded_env(7, 256, 512)`` as its
    Radiance environment."""
    import shutil

    import numpy as np

    from physically_based_renderer_tpu_torch.utils.image_io import save_hdr, save_png

    tokens = {"diffuse": "Albedo", "specular": "Specular", "metallic": "Metalness", "roughness": "Roughness",
              "normal": "Normal"}
    for (set_name, slot), img in seeded_texture_pages(41, 128).items():
        dirname, stem, _ = pbr.scenes.TEXTURE_SETS[set_name]
        os.makedirs(os.path.join(root, dirname), exist_ok=True)
        path = os.path.join(root, dirname, stem.format(tokens[slot]))
        if set_name != "rusted_iron":
            save_png(path + ".png", img)
    rust = os.path.join(root, "rustediron")
    shutil.copyfile(os.path.join(FIXTURE_DIR, "page_color_1024.jpg"), os.path.join(rust, "rustediron2_Albedo.jpg"))
    shutil.copyfile(os.path.join(FIXTURE_DIR, "page_gray_1024.jpg"), os.path.join(rust, "rustediron2_Metalness.jpg"))
    rng = np.random.default_rng(42)
    for slot in ("roughness", "normal"):
        save_png(os.path.join(rust, f"rustediron2_{tokens[slot]}.png"), seeded_page(rng, 512, slot))
    env_dir = os.path.join(root, "Chelsea_Stairs")
    os.makedirs(env_dir)
    shutil.copyfile(os.path.join(FIXTURE_DIR, "background_3k.jpg"), os.path.join(env_dir, "Chelsea_Stairs_3k.jpg"))
    save_hdr(os.path.join(env_dir, "Chelsea_Stairs_Env.hdr"), seeded_env(7, 256, 512))
    with open(os.path.join(env_dir, "Chelsea_Stairs.ibl"), "w") as f:
        f.write('[Header]\nName = "Seeded Stairs"\n[Background]\nBGfile = "Chelsea_Stairs_3k.jpg"\n'
                '[Enviroment]\nEVfile = "Chelsea_Stairs_Env.hdr"\nEVmulti = 1.0\n')
    return root


def reader_phases(pbr, dev, smi, width: int = WIDTH, height: int = HEIGHT) -> dict:
    """Phases ae-ah: the asset readers at full size, an OBJ scene on the card
    at 1080p through every route it takes, card vs CPU with an asset tree of
    PNG and JPEG files, and the progressive, CMYK, TGA and BMP readers
    (``format_phase``). Returns the routes' frame device times (ms, median
    of 5; "formats" the phase-ah frame)."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np

    from physically_based_renderer_tpu_torch.models import obj_loader
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.ops.texture import sky_u8
    from physically_based_renderer_tpu_torch.utils import native
    from physically_based_renderer_tpu_torch.utils.image_io import load_image

    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_assets_", dir="build")
    try:
        # ae. The readers at full size: the grid OBJ parsed by both parsers
        #     (bit-equal), and the JPEG fixtures decoded to PIL's digests.
        t0 = time.perf_counter()
        obj_path = write_grid_obj(os.path.join(tmp, "textured"), pbr)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.load_objparse()  # g++ builds native/objparse.cpp into build/native/ unless a build is there
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat = obj_loader.parse_obj_native(obj_path)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = obj_loader.parse_obj_python(obj_path)
        py_s = time.perf_counter() - t0
        for f in ("positions", "normals", "uvs", "tris", "face_material"):
            a, b = getattr(nat, f), getattr(py, f)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f"ae. {f}: parsers differ"
        assert (nat.material_names, nat.mtllibs, nat.has_normals, nat.has_uvs) == \
            (py.material_names, py.mtllibs, py.has_normals, py.has_uvs)
        nv, nt = nat.positions.shape[0], nat.tris.shape[0]
        assert nt == 194432 and nv == 98833 and len(nat.material_names) == OBJ_GROUPS, (nv, nt)
        print(f"ae. grid OBJ ({os.path.getsize(obj_path) / 2**20:.1f} MiB, written in {write_s:.2f} s): native "
              f"parser {nat_s * 1e3:.1f} ms (its library built and loaded in {build_s:.2f} s first), Python parser "
              f"{py_s * 1e3:.1f} ms (host clock), bit-equal; "
              f"{nv} vertices after the (v, vt, vn) dedup, {nt} triangles, {len(nat.material_names)} materials "
              f"[{smi}]")
        decoded, decode_ms = {}, {}
        for name in AE_FIXTURES:
            entry = fixture_manifest()[name]
            t0 = time.perf_counter()
            img = load_image(os.path.join(FIXTURE_DIR, name))
            dt = time.perf_counter() - t0
            digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
            assert list(img.shape) == entry["shape"] and digest == entry["decoded_sha256"], f"ae. {name}: {digest}"
            decoded[name], decode_ms[name] = img, dt * 1e3
            print(f"ae. decode {name} ({entry['bytes']} bytes, {img.shape[1]}x{img.shape[0]}x{img.shape[2]}): "
                  f"{dt * 1e3:.1f} ms (host clock); SHA-256 of the samples {digest} = PIL's (tests/data/"
                  f"manifest.json)")

        # af. The OBJ scene at 1080p through each route it takes; each route's
        #     own launch in its render call held against its plain version.
        cam = pbr.Camera.create(position=CAMERA_POS, aspect=width / height, device=dev)
        t0 = time.perf_counter()
        scene = pbr.scenes.obj_scene(obj_path, texture_size=TEXTURE_SIZE, device=dev)
        load_s = time.perf_counter() - t0
        plain_dir = os.path.join(tmp, "plain")
        os.makedirs(plain_dir)
        os.symlink(obj_path, os.path.join(plain_dir, "grid.obj"))  # the same geometry, a map-less MTL beside it
        write_grid_mtl(plain_dir, maps=False)
        plain = pbr.scenes.obj_scene(os.path.join(plain_dir, "grid.obj"), texture_size=TEXTURE_SIZE, device=dev)
        assert plain.atlas is None and scene.atlas is not None and scene.materials.num_materials == OBJ_GROUPS
        print(f"af. obj_scene at a {TEXTURE_SIZE} atlas: loaded in {load_s:.2f} s (parse, normals and tangents, "
              f"{len(scene.atlas.mips[0])} pages decoded from 2 JPEGs and 3 PNGs of 1024²), "
              f"{sum(d.mesh.num_triangles for d in scene.draws)} triangles [{smi}]")
        routes = {
            "atlas": (scene, "GBUF_V1_KERNEL_LAUNCHES"),
            "quad": (scene.with_combined_textures(mode="quad"), "GBUF_V1_KERNEL_LAUNCHES"),
            "packed": (scene.with_combined_textures(mode="packed"), "GBUF_V1_KERNEL_LAUNCHES"),
            "no maps": (plain, "KERNEL_LAUNCHES"),
        }
        counters = ("GBUF_V1_KERNEL_LAUNCHES", "KERNEL_LAUNCHES", "GBUF_KERNEL_LAUNCHES", "IDS_KERNEL_LAUNCHES")
        route_ms, frames = {}, {}
        for label, (s, counter) in routes.items():
            draw = lambda: pbr.render(s, cam, width=width, height=height)  # noqa: E731
            calls, restore = recording([(raster_row, n) for n in TILE_KERNELS])
            try:
                frames[label] = draw()  # warm; its kernel launch is recorded
            finally:
                restore()
            assert len(calls) == 1, (label, [c[0] for c in calls])
            name, args, kw, _ = calls[0]
            assert name == ("raster_gbuffer_tiles_cuda" if counter.startswith("GBUF") else "raster_shade_tiles_cuda")
            assert name != "raster_gbuffer_tiles_cuda" or kw["num_ch"] == 15, kw.get("num_ch")  # C = 14
            held = launch_vs_plain(*calls[0])
            for c in counters:
                setattr(raster_row, c, 0)
            busy = frame_device_ms(draw)
            launches = {c: getattr(raster_row, c) for c in counters}
            assert launches == {c: 5 * (c == counter) for c in counters}, (label, launches)
            f = frames[label]
            assert f.shape == (height, width, 4) and bool(torch.isfinite(f).all()), label
            route_ms[label] = statistics.median(busy)
            print(f"af. OBJ scene ({label}) at {width}x{height}: device time a frame "
                  f"{[round(t, 3) for t in busy]} ms (median {route_ms[label]:.3f}), {counter} 1 a frame "
                  f"({launches[counter]} in 5 frames, no other raster kernel); the launch ({name}, "
                  f"{kw['tile_h']}x{kw['tile_w']} tiles) vs its plain version on the route's inputs: {held} [{smi}]")
        f32 = pbr.render(scene.with_combined_textures(mode="f32"), cam, width=width, height=height)
        d = (frames["packed"] - f32).abs().amax(-1).cpu().numpy()
        p995, mean, far = float(np.percentile(d, 99.5)), float(d.mean()), float((d > PACKED_FAR).mean())
        assert p995 < PACKED_P995 and mean < PACKED_MEAN and far < PACKED_FAR_SHARE, (p995, mean, far)
        q_vs_f32 = float((frames["quad"] - f32).abs().max())
        fg = float(((frames["atlas"][..., :3] - 0.5).abs().amax(-1) > 1e-6).float().mean())
        assert fg > 0.05 and q_vs_f32 <= RGBA_ATOL, (fg, q_vs_f32)
        print(f"af. packed frame vs the f32 combined frame: 99.5th percentile of the per-pixel max |Δ| {p995:.3e} "
              f"(< {PACKED_P995}), mean {mean:.3e} (< {PACKED_MEAN}), share past {PACKED_FAR} {far:.2e} "
              f"(< {PACKED_FAR_SHARE}); quad vs f32 max |Δ| {q_vs_f32:.2e}; {fg:.4f} of pixels foreground")
        quad = routes["quad"][0]
        fields = [k for k in quad.materials.tensor_fields() if getattr(quad.materials, k).is_floating_point()]
        raster_row.GBUF_V1_KERNEL_LAUNCHES = 0
        steps = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = bench_loss_grads(pbr, quad, cam, width, height, fields)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3, loss, grads))
        same = all(torch.equal(steps[0][2][k], steps[1][2][k]) for k in fields) and torch.equal(steps[0][1], steps[1][1])
        assert same and raster_row.GBUF_V1_KERNEL_LAUNCHES == 2, (same, raster_row.GBUF_V1_KERNEL_LAUNCHES)
        assert all(bool(torch.isfinite(g).all()) for g in steps[0][2].values())
        assert float(steps[0][2]["diffuse"].abs().sum()) > 0
        print(f"af. bench-loss material-gradient step on the OBJ scene (quad pages) at {width}x{height}: "
              f"{[round(t[0], 3) for t in steps]} ms (host clock), kernel 4 once a step, the same loss and gradient "
              f"bits on both runs [{smi}]")

        # ag. Card vs CPU: the OBJ scene at 128x64; an asset tree of PNG and
        #     JPEG files driving pbr_scene and rustediron under its sIBL set.
        s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
        ref = pbr.render(scene.to("cpu"), s_cam, width=128, height=64).numpy()
        got = pbr.render(scene, s_cam.to(dev), width=128, height=64).cpu().numpy()
        d = np.abs(got - ref)
        frac, med, q999 = float((d > 1e-5).mean()), float(np.median(d)), float(np.quantile(d, 0.999))
        assert frac < 5e-3 and med < 1e-6 and q999 < 1e-2, (frac, med, q999)
        print(f"ag. 128x64 OBJ frame, card vs CPU: values off by > 1e-5 {frac:.5f}, median {med:.2e}, "
              f"0.999-quantile {q999:.2e}, max {float(d.max()):.2e}")
        root = write_asset_tree(os.path.join(tmp, "Assets"), pbr)
        cache = pbr.scenes.AssetCache(root, texture_size=TEXTURE_SIZE)
        t0 = time.perf_counter()
        pscene = pbr.scenes.pbr_scene(cache, texture_size=TEXTURE_SIZE, device=dev)
        pbr_s = time.perf_counter() - t0
        assert cache.pages[cache.page("rusted_iron", "diffuse")].shape == (1024, 1024, 3)
        assert np.array_equal(cache.pages[cache.page("rusted_iron", "diffuse")], decoded["page_color_1024.jpg"])
        t0 = time.perf_counter()
        rust = pbr.scenes.rustediron_sphere_scene(cache, texture_size=TEXTURE_SIZE, environment="chelsea_stairs",
                                                  device=dev)
        rust_s = time.perf_counter() - t0
        sky_digest = hashlib.sha256(rust.sky_map.cpu().numpy().tobytes()).hexdigest()
        assert sky_digest == fixture_manifest()["background_3k.jpg"]["decoded_sha256"], sky_digest
        assert torch.equal(rust.sky_map.cpu(), sky_u8(decoded["background_3k.jpg"] / np.float32(255.0)))
        rust = rust.with_ibl().with_combined_textures(mode="quad")
        r_cam = pbr.Camera.create(position=(0.0, 0.0, -2.5), aspect=width / height, device=dev)
        out = {}
        for label, s, c in (("pbr_scene (quad pages)", pscene.with_combined_textures(mode="quad"), cam),
                            ("rustediron + chelsea_stairs IBL (quad pages)", rust, r_cam)):
            raster_row.GBUF_V1_KERNEL_LAUNCHES = 0
            out[label] = pbr.render(s, c, width=width, height=height)
            assert raster_row.GBUF_V1_KERNEL_LAUNCHES == 1 and bool(torch.isfinite(out[label]).all()), label
        textured = int((pscene.materials.has_tex.sum(-1) > 0).sum())  # materials that bind a page
        assert textured == 9, textured
        print(f"ag. asset tree (PNG pages, rustediron's maps the JPEG fixtures, Chelsea_Stairs' _3k JPEG and "
              f"Radiance env): pbr_scene from {len(cache.pages)} decoded pages in {pbr_s:.2f} s ({textured} "
              f"textured spheres), rustediron_sphere_scene(environment='chelsea_stairs') in {rust_s:.2f} s, its "
              f"u8 sky's SHA-256 = the fixture's; one {width}x{height} frame each through render (kernel 4 once), "
              f"mean RGB "
              + "; ".join(f"{k} {v[..., :3].reshape(-1, 3).mean(0).cpu().numpy().round(4).tolist()}"
                          for k, v in out.items()) + f" [{smi}]")
        route_ms["formats"] = format_phase(pbr, dev, smi, tmp, obj_path, routes["quad"][0], frames["quad"], decoded,
                                           decode_ms, width, height)
        return route_ms
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_tga(path: str, img, rle: bool = False, top_down: bool = False) -> None:
    """A TGA file of (H, W, 1) gray or (H, W, 3) RGB uint8 ``img``: image
    type 3 / 2 (11 / 10 with ``rle``: runs of 2-128 equal pixels, literal
    packets of up to 128, none crossing a row, as PIL writes them), its rows
    bottom-up (the TGA default) or top-down."""
    import struct

    import numpy as np

    h, w, c = img.shape
    rows = (img[..., ::-1] if c == 3 else img)[slice(None) if top_down else slice(None, None, -1)]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, (3 if c == 1 else 2) + 8 * rle, 0, 0, 0, 0, 0, w, h, 8 * c,
                       0x20 if top_down else 0)
    if not rle:
        body = np.ascontiguousarray(rows).tobytes()
    else:
        out = bytearray()
        for row in rows:
            edges = (np.flatnonzero((row[1:] != row[:-1]).any(-1)) + 1).tolist()
            lit = None  # start of the pending literal pixels
            for a, b in zip([0] + edges, edges + [w]):
                if b - a == 1:
                    lit = a if lit is None else lit
                    if b - lit == 128:
                        out += bytes([127]) + row[lit:b].tobytes()
                        lit = None
                    continue
                if lit is not None:
                    out += bytes([a - lit - 1]) + row[lit:a].tobytes()
                    lit = None
                for k in range(a, b, 128):
                    out += bytes([0x80 | (min(128, b - k) - 1)]) + row[a].tobytes()
            if lit is not None:
                out += bytes([w - lit - 1]) + row[lit:w].tobytes()
        body = bytes(out)
    with open(path, "wb") as f:
        f.write(head + body)


def write_bmp(path: str, img, bits: int = 24, top_down: bool = False) -> None:
    """A BMP file of (H, W, 3) RGB uint8 ``img``: 24-bit BI_RGB under a
    BITMAPINFOHEADER, or 32-bit BI_BITFIELDS (B, G, R, unused byte) under a
    BITMAPV4HEADER; rows padded to 4 bytes, bottom-up or (negative height)
    top-down."""
    import struct

    import numpy as np

    h, w, _ = img.shape
    px = img[..., ::-1]
    if bits == 32:
        px = np.concatenate([px, np.zeros_like(px[..., :1])], axis=-1)
    rows = px.reshape(h, -1)[slice(None) if top_down else slice(None, None, -1)]
    stride = (w * bits // 8 + 3) & ~3
    body = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    header = 40 if bits == 24 else 108
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, 0 if bits == 24 else 3, len(body),
                       2835, 2835, 0, 0)
    if bits == 32:
        info += struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0) + bytes(header - 56)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 14 + header + len(body), 0, 0, 14 + header) + info + body)


def format_phase(pbr, dev, smi, tmp: str, obj_path: str, quad, quad_frame, decoded: dict, decode_ms: dict,
                 width: int, height: int) -> float:
    """Phase ah: the image kinds past PNG and baseline JPEG — the progressive
    twins and the CMYK fixture against their manifest digests, TGA and BMP
    round trips of the decoded colour page, then phase ae's OBJ with its maps
    read from a progressive JPEG, a TGA and a BMP of the same pixels, rendered
    through kernel 4 on phase af's quad pages: pages, the launch and the
    frame bit-equal to af's. Returns the median device time of its frames."""
    import hashlib
    import shutil

    import numpy as np

    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.utils.image_io import load_image

    # ah. The progressive twins and the CMYK fixture, against the manifest.
    manifest = fixture_manifest()
    for name in list(PROGRESSIVE_TWINS) + ["cmyk_512.jpg"]:
        t0 = time.perf_counter()
        img = load_image(os.path.join(FIXTURE_DIR, name))
        dt = time.perf_counter() - t0
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        twin = PROGRESSIVE_TWINS.get(name)
        assert list(img.shape) == manifest[name]["shape"] and digest == manifest[name]["decoded_sha256"], (name, digest)
        if twin:
            assert digest == manifest[twin]["decoded_sha256"] and np.array_equal(img, decoded[twin]), name
            decoded[name] = img
        print(f"ah. decode {name} ({manifest[name]['bytes']} bytes, {img.shape[1]}x{img.shape[0]}x{img.shape[2]}): "
              f"{dt * 1e3:.1f} ms (host clock)"
              + (f", its baseline twin {twin} {decode_ms[twin]:.1f} ms (ae), ratio {dt * 1e3 / decode_ms[twin]:.2f}; "
                 f"SHA-256 = the twin's" if twin else "; SHA-256 = PIL's convert('RGB') (tests/data/manifest.json)")
              + f" [{smi}]")

    # ah. TGA and BMP round trips of the decoded colour page.
    page = decoded["page_color_1024.jpg"]
    fmt_dir = os.path.join(tmp, "formats")
    os.makedirs(fmt_dir)
    variants = {"tga raw bottom-up": (write_tga, dict()), "tga raw top-down": (write_tga, dict(top_down=True)),
                "tga rle bottom-up": (write_tga, dict(rle=True)),
                "tga rle top-down": (write_tga, dict(rle=True, top_down=True)),
                "bmp 24-bit bottom-up": (write_bmp, dict()),
                "bmp 32-bit bitfields top-down": (write_bmp, dict(bits=32, top_down=True))}
    for i, (label, (writer, kw)) in enumerate(variants.items()):
        path = os.path.join(fmt_dir, f"page_{i}.{label[:3]}")
        writer(path, page, **kw)
        t0 = time.perf_counter()
        back = load_image(path)
        dt = time.perf_counter() - t0
        assert back.shape == page.shape and np.array_equal(back, page), label
        print(f"ah. {label} ({os.path.getsize(path)} bytes) of the decoded {page.shape[1]}x{page.shape[0]} colour "
              f"page: decoded in {dt * 1e3:.1f} ms (host clock), bit-equal [{smi}]")

    # ah. The OBJ frame: ae's OBJ, material 0's map_Kd the progressive twin,
    #     map_Pr a TGA and map_Pm a BMP of ae's PNG pages; material 1's map_Kd
    #     the gray progressive twin.
    src = os.path.dirname(obj_path)
    obj_dir = os.path.join(tmp, "formats_obj")
    os.makedirs(os.path.join(obj_dir, "maps"))
    os.symlink(obj_path, os.path.join(obj_dir, "grid.obj"))
    for name in PROGRESSIVE_TWINS:
        shutil.copyfile(os.path.join(FIXTURE_DIR, name), os.path.join(obj_dir, "maps", name))
    shutil.copyfile(os.path.join(src, "maps", "normal.png"), os.path.join(obj_dir, "maps", "normal.png"))
    write_tga(os.path.join(obj_dir, "maps", "roughness.tga"), load_image(os.path.join(src, "maps", "roughness.png")),
              rle=True, top_down=True)
    write_bmp(os.path.join(obj_dir, "maps", "metallic.bmp"), load_image(os.path.join(src, "maps", "metallic.png")))
    with open(os.path.join(src, "grid.mtl")) as f:
        mtl = f.read()
    swaps = {"page_color_1024.jpg": "page_color_1024_progressive.jpg",
             "page_gray_1024.jpg": "page_gray_1024_progressive.jpg",
             "roughness.png": "roughness.tga", "metallic.png": "metallic.bmp"}
    for a, b in swaps.items():
        assert mtl.count(f"maps/{a}") == 1, a
        mtl = mtl.replace(f"maps/{a}", f"maps/{b}")
    with open(os.path.join(obj_dir, "grid.mtl"), "w") as f:
        f.write(mtl)
    t0 = time.perf_counter()
    scene = pbr.scenes.obj_scene(os.path.join(obj_dir, "grid.obj"), texture_size=TEXTURE_SIZE, device=dev)
    load_s = time.perf_counter() - t0
    scene = scene.with_combined_textures(mode="quad")
    assert all(torch.equal(a, b) for a, b in zip(scene.atlas.mips, quad.atlas.mips))
    qa, qb = scene.combined_atlas, quad.combined_atlas
    for f in ("taps", "pages", "material_page", "mips_taps", "mips_stack"):
        a, b = getattr(qa, f), getattr(qb, f)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), f"ah. quad {f} differs from af's"
    cam = pbr.Camera.create(position=CAMERA_POS, aspect=width / height, device=dev)
    draw = lambda: pbr.render(scene, cam, width=width, height=height)  # noqa: E731
    calls, restore = recording([(raster_row, n) for n in TILE_KERNELS])
    try:
        frame = draw()
    finally:
        restore()
    assert [c[0] for c in calls] == ["raster_gbuffer_tiles_cuda"] and calls[0][2]["num_ch"] == 15, \
        [c[0] for c in calls]
    held = launch_vs_plain(*calls[0])
    assert torch.equal(frame, quad_frame), "ah. the frame differs from af's quad frame"
    counters = ("GBUF_V1_KERNEL_LAUNCHES", "KERNEL_LAUNCHES", "GBUF_KERNEL_LAUNCHES", "IDS_KERNEL_LAUNCHES")
    for c in counters:
        setattr(raster_row, c, 0)
    busy = frame_device_ms(draw)
    launches = {c: getattr(raster_row, c) for c in counters}
    assert launches == {c: 5 * (c == "GBUF_V1_KERNEL_LAUNCHES") for c in counters}, launches
    print(f"ah. OBJ scene with maps from a progressive JPEG, a TGA and a BMP: obj_scene at a {TEXTURE_SIZE} atlas in "
          f"{load_s:.2f} s (host clock), atlas and quad pages bit-equal to af's; {width}x{height} through render: "
          f"device time a frame {[round(t, 3) for t in busy]} ms (median {statistics.median(busy):.3f}), kernel 4 "
          f"once a frame ({launches['GBUF_V1_KERNEL_LAUNCHES']} in 5 frames, no other raster kernel); its launch vs "
          f"its plain version: {held}; the frame bit-equal to af's quad frame [{smi}]")
    return statistics.median(busy)


if __name__ == "__main__":
    sys.exit(main())
