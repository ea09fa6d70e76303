"""The culled resolve of the raster kernels (the per-warp reject of kernel
1's shade mode, of kernels 2 / 4's G-buffer mode and of kernels 5 / 5b's
ids mode) and the adjoint's optional outputs, on the CPU.

* ``chip_smoke.raster_tests`` — the (pair, pixel) tests a binning needs,
  the pixels of each pair's tile inside its triangle's screen box (the
  dilated triangle's box at a margin) — equals a brute-force count on small
  binnings (the render binning, a forced jumbo run, a band at ``y_offset``
  > 0, a dilated binning, dilated slivers whose wedge reaches past the box
  grown by the margin); ``chip_smoke.culled_tests`` equals a brute-force
  count of the pixels of each (pair, warp) the reject keeps, in the shade
  and G-buffer modes' map and in the ids mode's and kernel 4's (PPT 8),
  also on a textured binning whose records carry C = 14 planes.
* On a seeded textured binning (a jumbo run, a peel behind a z floor), no
  (pair, warp) the G-buffer mode's reject drops holds a pixel the plain
  G-buffer resolve's test passes with that pair.
* ``raster_row.warp_pixels`` puts every pixel of a tile in exactly one
  (warp, slot), compact where it fits (a 16×16 block a warp in the ids
  mode at 16×128 tiles).
* ``raster_row.footprint_rejects``, the float32 model of the kernel's
  per-warp reject (the same arithmetic and slack as
  ``csrc/raster_shade_row.cu::warp_mask``), never drops a footprint that
  holds a pixel the exact test covers — over seeded triangles, slivers
  whose edges run through or ulps beside the footprint's border pixel
  centres, and far corners of the screen — and drops most far triangles;
  at a margin m (unit-gradient edges, 16×16 footprints) it never drops one
  that holds a pixel the dilated test ``e ≥ −m`` covers, over slivers
  whose edge lies at −m or ulps from it at border centres, with corner 0
  near or ~10³ px away.
* ``shade_backward(want_attrs=False, want_props=False)`` returns None in
  those places and the same ``g_uni`` and table; ``shade_fused``'s table
  gradient does not depend on whether the attributes ask for one.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import culled_tests, fill_asset_cache, raster_tests, screen_xy, seeded_texture_pages, warp_boxes
from physically_based_renderer_tpu_torch import Camera, flatten_scene_corners, math3d, scenes
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops.raster import _setup_from_corner_data
from physically_based_renderer_tpu_torch.ops.raster_bin import pack_triangle_fields
from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
from physically_based_renderer_tpu_torch.renderer import binning_params
from torch_parity import random_gbuffer

W, H = 128, 64


@functools.lru_cache(maxsize=2)
def _textured_geometry(position):
    """``pbr_scene`` with seeded 32² pages (``chip_smoke.seeded_texture_pages``)
    at 16×8 spheres: its textured corner geometry (C = 14) and clip
    coordinates from a camera at ``position``."""
    cache = fill_asset_cache(scenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32))
    scene = scenes.pbr_scene(cache, texture_size=32, slices=16, stacks=8, device="cpu")
    cam = Camera.create(position=position, aspect=W / H, device="cpu")
    g = flatten_scene_corners(scene, textured=True)
    return g, math3d.transform_points_h(g.pos_w, cam.view_proj())


def _textured_binning(tile_h, max_span, position=(0.0, -3.0, -18.0), cull=True):
    """The seeded textured scene binned as kernel 4 bins it (no big2 class),
    at ``tile_h``×128 tiles and ``max_span``: the packed records carry the
    C = 14 planes."""
    g, clip = _textured_geometry(position)
    kw = dict(width=W, height=H, rows=H, y_offset=0, tile_h=tile_h, tile_w=128, cull_backface=cull,
              max_span=max_span, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)
    binned = raster_row.bin_for_shade(clip, g.attrs, g.face_material, **kw)
    assert g.attrs.shape[-1] == 14 and binned.packed.shape[1] >= 16 + 3 * 15
    return binned, clip, kw


def _grid_binning(case, tile_h=8):
    if case == "textured":  # kernel 4's v1 binning of the textured scene; the records hold 61 fields
        g, _ = _textured_geometry((0.0, -3.0, -18.0))
        binned, clip, kw = _textured_binning(tile_h, binning_params(g.num_triangles, W, H, row_layout=False)["max_span"])
        return binned, screen_xy(clip, W, H), kw, 0.0
    scene = scenes.red_sphere_grid_scene(8, 4, device="cpu")
    cam = Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device="cpu")
    g = flatten_scene_corners(scene)
    clip = math3d.transform_points_h(g.pos_w, cam.view_proj())
    kw = dict(width=W, height=H, rows=H, y_offset=0, tile_h=tile_h, tile_w=128, cull_backface=True)
    kw.update(binning_params(g.num_triangles, W, H))
    margin = 0.0
    if case == "jumbo":
        kw.update(tile_h=2, max_span=2, big_cap=None, pairs_cap=None)
    if case == "band":
        kw.update(rows=20, y_offset=37)
    if case == "dilated":
        margin = 3.0
    if case == "slivers":  # seeded slivers (w = 1), dilated by 2.1 px: their wedges pass their boxes + margin
        rng = np.random.default_rng(9)
        n = 300
        base = rng.uniform((0, 0), (W, H), (n, 1, 2))
        tip = base + rng.uniform(-12, 12, (n, 1, 2))
        apex = (base + tip) / 2 + rng.uniform(-0.3, 0.3, (n, 1, 2))
        xy = np.concatenate([base, tip, apex], 1)
        z = np.full(xy.shape[:2], 0.5)
        clip = torch.as_tensor(np.stack([xy[..., 0] / W * 2 - 1, 1 - xy[..., 1] / H * 2, z, np.ones_like(z)], -1),
                               dtype=torch.float32)
        kw.update(cull_backface=False, max_span=8, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)
        margin = 2.1
    binned = raster_row.bin_for_shade(clip, None, None, bbox_margin_px=margin, **kw)
    return binned, screen_xy(clip, W, H), kw, margin


def _dilated_boxes(xy, margin):
    """(T, 2) lo and hi of the dilated triangles' boxes, each corner the
    meeting point of two edge lines moved out by ``margin`` (solved in
    float64); the triangle's own box at margin 0."""
    p = xy.double()
    if margin == 0:
        return p.amin(1), p.amax(1)
    normals, offsets = [], []
    for i in range(3):
        a, b, opp = p[:, i], p[:, (i + 1) % 3], p[:, (i + 2) % 3]
        d = b - a
        n = torch.stack([-d[:, 1], d[:, 0]], -1) / d.norm(dim=-1, keepdim=True)
        n = torch.where(((opp - a) * n).sum(-1, keepdim=True) > 0, -n, n)  # outward
        normals.append(n)
        offsets.append((n * a).sum(-1) + margin)  # n·X = n·a + margin on the moved line
    corners = []
    for i in range(3):
        j = (i + 1) % 3
        mat = torch.stack([normals[i], normals[j]], 1)
        corners.append(torch.linalg.solve(mat, torch.stack([offsets[i], offsets[j]], -1)))
    c = torch.stack(corners, 1)
    return c.amin(1), c.amax(1)


def _brute_force_tests(binned, xy, kw, margin):
    """Count, pair by pair and pixel by pixel, the pixels of each pair's tile
    (every tile for the jumbo run) inside its (dilated) triangle's box."""
    width, rows, y_off, th, tw = kw["width"], kw["rows"], kw["y_offset"], kw["tile_h"], kw["tile_w"]
    tiles_x = -(-width // tw)
    ntiles = binned.starts.shape[0] - 1
    lo, hi = _dilated_boxes(xy, margin)
    starts = binned.starts.tolist()
    total = 0
    for tile in range(ntiles):
        r = torch.arange(th) + tile // tiles_x * th
        c = torch.arange(tw) + tile % tiles_x * tw
        rr, cc = torch.meshgrid(r, c, indexing="ij")
        ok = (rr < rows) & (cc < width)
        px, py = cc.double() + 0.5, rr.double() + y_off + 0.5
        for q in [*range(starts[0]), *range(starts[tile], starts[tile + 1])]:
            t = int(binned.pair_tri[q])
            inside = ok & (px >= lo[t, 0]) & (px <= hi[t, 0]) & (py >= lo[t, 1]) & (py <= hi[t, 1])
            total += int(inside.sum())
    return total


@pytest.mark.parametrize("case", ["render", "jumbo", "band", "dilated", "slivers"])
def test_raster_tests_counts_the_pixels_in_each_pairs_box(case):
    binned, xy, kw, margin = _grid_binning(case)
    assert case != "jumbo" or int(binned.starts[0]) > 0
    got = raster_tests(binned.starts, binned.pair_tri, xy, margin=margin, **kw)
    assert got == _brute_force_tests(binned, xy, kw, margin)
    full = (binned.starts.shape[0] - 1) * int(binned.starts[0]) + int(binned.starts[-1] - binned.starts[0])
    assert 0 < got < full * kw["tile_h"] * kw["tile_w"]
    if case == "slivers":  # the wedges reach past the boxes grown by the margin: those count too
        lo, hi = xy.double().amin(1) - margin, xy.double().amax(1) + margin
        d_lo, d_hi = _dilated_boxes(xy, margin)
        assert bool(((d_lo < lo - 1) | (d_hi > hi + 1)).any(1).float().mean() > 0.5)
        grown = _brute_force_tests(binned, torch.stack([lo, hi, hi], 1), kw, 0.0)
        assert got > grown


def _brute_force_culled(binned, kw, margin, ppt):
    """Count, tile by tile and warp by warp, the in-image pixels of each
    (pair, warp) that ``footprint_rejects`` keeps, each warp's box formed
    from its own pixel list."""
    width, rows, y_off, th, tw = kw["width"], kw["rows"], kw["y_offset"], kw["tile_h"], kw["tile_w"]
    tiles_x = -(-width // tw)
    wp = raster_row.warp_pixels(th, tw, ppt)
    starts = binned.starts.tolist()
    total = 0
    for tile in range(binned.starts.shape[0] - 1):
        pairs = [*range(starts[0]), *range(starts[tile], starts[tile + 1])]
        if not pairs:
            continue
        fields = binned.packed[pairs, :11]
        for w in range(wp.shape[0]):
            pix = [(int(r) + tile // tiles_x * th, int(c) + tile % tiles_x * tw) for r, c in wp[w].tolist()
                   if r >= 0]
            pix = [(r, c) for r, c in pix if r < rows and c < width]
            if not pix:
                continue
            xs = [c + 0.5 for _, c in pix]
            ys = [r + y_off + 0.5 for r, _ in pix]
            drop = raster_row.footprint_rejects(fields, min(xs), max(xs), min(ys), max(ys), margin=margin)
            total += int((~drop).sum()) * len(pix)
    return total


@pytest.mark.parametrize("ppt", [None, 8])
@pytest.mark.parametrize("case", ["render", "jumbo", "band", "dilated", "textured"])
def test_culled_tests_counts_the_kept_warp_pixels(case, ppt):
    """The shade and G-buffer modes' map (PPT from the tile: kernel 2's at
    8×128) and the ids mode's and kernel 4's (PPT 8, 16×128 tiles where the
    case does not force its own); "textured" bins C = 14 records, of which
    the reject reads only fields 0–10."""
    binned, _, kw, margin = _grid_binning(case, tile_h=8 if ppt is None else 16)
    got = culled_tests(binned.starts, binned.packed, binned.pair_tri, margin=margin, ppt=ppt, **kw)
    assert got == _brute_force_culled(binned, kw, margin, ppt)
    every = ((binned.starts.shape[0] - 1) * int(binned.starts[0]) + int(binned.starts[-1] - binned.starts[0]))
    assert 0 < got < every * kw["tile_h"] * kw["tile_w"]


@pytest.mark.parametrize("tile", [(8, 128), (4, 128), (2, 128), (16, 128), (8, 64), (3, 128), (2, 256)])
def test_warp_pixels_cover_each_tile_pixel_once(tile):
    th, tw = tile
    wp = raster_row.warp_pixels(th, tw).reshape(-1, 2)
    wp = wp[wp[:, 0] >= 0]
    assert wp.shape[0] == th * tw
    assert torch.unique(wp[:, 0] * tw + wp[:, 1]).numel() == th * tw
    if tile == (8, 128):  # compact: warp w holds columns 16w..16w+15, all 8 rows
        w3 = raster_row.warp_pixels(th, tw)[3]
        assert set(w3[:, 1].tolist()) == set(range(48, 64)) and set(w3[:, 0].tolist()) == set(range(8))
    if tile == (4, 128):
        assert set(raster_row.warp_pixels(th, tw)[5][:, 0].tolist()) == set(range(4))
    if tile == (16, 128):  # the ids mode (PPT 8): warp w holds the 16×16 block of columns 16w..16w+15
        ids = raster_row.warp_pixels(th, tw, 8)
        assert ids.shape == (8, 256, 2) and not bool((ids < 0).any())
        for w in range(8):
            assert set(map(tuple, ids[w].tolist())) == {(r, c) for r in range(16) for c in range(16 * w, 16 * w + 16)}


def _seeded_triangles(case, rng, n, box):
    """(n, 3, 2) float32 pixel coordinates of triangles about a footprint
    whose pixel centres span ``box`` = (x_lo, x_hi, y_lo, y_hi)."""
    x_lo, x_hi, y_lo, y_hi = box
    if case == "near":  # a few pixels across, over and around the footprint
        c = rng.uniform([x_lo - 6, y_lo - 6], [x_hi + 6, y_hi + 6], (n, 1, 2))
        return (c + rng.normal(0, rng.uniform(0.3, 4.0, (n, 1, 1)), (n, 3, 2))).astype(np.float32)
    if case == "sliver":  # one edge through, or ulps beside, a row or column of border centres
        out = np.empty((n, 3, 2), np.float32)
        for i in range(n):
            horizontal = rng.random() < 0.5
            lo, hi = (x_lo, x_hi) if horizontal else (y_lo, y_hi)
            edge = rng.choice([y_lo, y_hi, y_lo - 1, y_hi + 1] if horizontal else [x_lo, x_hi, x_lo - 1, x_hi + 1])
            edge = np.float32(edge)
            nudge = rng.integers(-3, 4)
            edge = np.nextafter(edge, np.float32(np.inf if nudge > 0 else -np.inf)) if nudge else edge
            for _ in range(abs(nudge) - 1):
                edge = np.nextafter(edge, np.float32(np.inf if nudge > 0 else -np.inf))
            a, b = rng.uniform(lo - 8, hi + 8, 2)
            tilt = rng.choice([0.0, 1.0]) * rng.uniform(-1e-4, 1e-4, 2)  # a nearly-parallel edge, or an exact one
            apex = edge + rng.choice([-1, 1]) * rng.uniform(1e-3, 3.0)
            pts = [(a, edge + tilt[0]), (b, edge + tilt[1]), (rng.uniform(lo - 8, hi + 8), apex)]
            out[i] = [(p, q) if horizontal else (q, p) for p, q in pts]
        return out
    # far: anywhere on a 1080p screen
    return rng.uniform(0, [1920, 1080], (n, 3, 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["near", "sliver", "far"])
def test_footprint_reject_never_drops_a_covered_pixel(case):
    rng = np.random.default_rng({"near": 1, "sliver": 2, "far": 3}[case])
    kept_far = []
    for trial in range(24):
        # a 16x8 footprint (8x128 tiles) or 16x4 (4x128) at a seeded place in a 1080p frame
        fh = (8, 4)[trial % 2]
        x0, y0 = 16 * rng.integers(0, 119), fh * rng.integers(0, 1080 // fh - 1)
        cols, rows = np.arange(16, dtype=np.float32) + x0 + 0.5, np.arange(fh, dtype=np.float32) + y0 + 0.5
        box = (cols[0], cols[-1], rows[0], rows[-1])
        xy = torch.as_tensor(_seeded_triangles(case, rng, 400, box))
        n = xy.shape[0]
        ones = torch.ones((n, 3))
        st = _setup_from_corner_data(xy, ones * 0.5, ones, ones, False, None)
        f = pack_triangle_fields(st)[st.valid]
        # the plain version's per-pixel test (raster_row._resolve_plain), float32
        px = torch.as_tensor(np.tile(cols, fh))[None, :]
        py = torch.as_tensor(np.repeat(rows, 16))[None, :]
        dx, dy = px - f[:, 9:10], py - f[:, 10:11]
        covered = torch.ones_like(dx, dtype=torch.bool)
        for i in range(3):
            covered &= (dx * f[:, i : i + 1] + dy * f[:, 3 + i : 4 + i] + f[:, 6 + i : 7 + i]) >= 0
        rejected = raster_row.footprint_rejects(f, *box)
        assert not bool((rejected & covered.any(1)).any()), f"trial {trial}: a covered footprint was dropped"
        assert bool(covered.any()) or case == "far"
        if case == "far":
            kept_far.append(float((~rejected).float().mean()))
        if case == "sliver":  # some slivers cover border centres exactly, and none of them is dropped
            assert bool(covered.any(1).sum() > 10)
    if case == "far":
        assert np.mean(kept_far) < 0.25, np.mean(kept_far)


def _dilated_slivers(rng, n, box, margin):
    """(n, 3, 2) float32 slivers about a 16×16 footprint whose pixel
    centres span ``box``: one edge on a row or column line ``margin`` px
    outside the border centres (or on them, or a pixel further out), nudged
    by 0–3 ulps, the apex 1e-3–3 px off it on either side; in half of them
    corner 0 lies ~10³ px away along that edge, so the footprint's offsets
    from corner 0 and the opposite edge's constant are ~10³."""
    x_lo, x_hi, y_lo, y_hi = box
    out = np.empty((n, 3, 2), np.float32)
    for i in range(n):
        horizontal = rng.random() < 0.5
        lo, hi = (x_lo, x_hi) if horizontal else (y_lo, y_hi)
        b_lo, b_hi = (y_lo, y_hi) if horizontal else (x_lo, x_hi)
        edge = np.float32(rng.choice([b_lo - margin, b_hi + margin, b_lo, b_hi, b_lo - 1 - margin,
                                      b_hi + 1 + margin]))
        nudge = rng.integers(-3, 4)
        for _ in range(abs(nudge)):
            edge = np.nextafter(edge, np.float32(np.inf if nudge > 0 else -np.inf))
        a, b = rng.uniform(lo - 8, hi + 8, 2)
        if rng.random() < 0.5:  # corner 0 far along the edge
            a = a + rng.choice([-1, 1]) * rng.uniform(800, 1200)
        apex = edge + rng.choice([-1, 1]) * rng.uniform(1e-3, 3.0)
        pts = [(a, edge), (b, edge), (rng.uniform(lo - 8, hi + 8), apex)]
        out[i] = [(p, q) if horizontal else (q, p) for p, q in pts]
    return out


@pytest.mark.parametrize("margin", [3.0, 2.1, 0.75])
@pytest.mark.parametrize("case", ["near", "sliver", "far"])
def test_dilated_footprint_reject_never_drops_a_covered_pixel(case, margin):
    """Kernel 5b's reject: unit-gradient edges, the ids mode's 16×16
    footprints, coverage ``e ≥ −margin`` in float32 as the plain version
    tests it."""
    rng = np.random.default_rng({"near": 11, "sliver": 12, "far": 13}[case] + int(10 * margin))
    kept_far, boundary = [], 0
    for trial in range(24):
        x0, y0 = 16 * rng.integers(0, 119), 16 * rng.integers(0, 1080 // 16 - 1)
        cols, rows = np.arange(16, dtype=np.float32) + x0 + 0.5, np.arange(16, dtype=np.float32) + y0 + 0.5
        box = (cols[0], cols[-1], rows[0], rows[-1])
        xy = _dilated_slivers(rng, 400, box, margin) if case == "sliver" else _seeded_triangles(case, rng, 400, box)
        xy = torch.as_tensor(xy)
        ones = torch.ones((xy.shape[0], 3))
        st = _setup_from_corner_data(xy, ones * 0.5, ones, ones, False, None)
        f = pack_triangle_fields(st, normalize_edges=True)[st.valid]
        px = torch.as_tensor(np.tile(cols, 16))[None, :]
        py = torch.as_tensor(np.repeat(rows, 16))[None, :]
        dx, dy = px - f[:, 9:10], py - f[:, 10:11]
        e_min = torch.stack([dx * f[:, i : i + 1] + dy * f[:, 3 + i : 4 + i] + f[:, 6 + i : 7 + i]
                             for i in range(3)]).amin(0)
        covered = e_min >= -margin
        rejected = raster_row.footprint_rejects(f, *box, margin=margin)
        assert not bool((rejected & covered.any(1)).any()), f"trial {trial}: a covered footprint was dropped"
        boundary += int(((e_min + margin).abs() < 1e-4).sum())
        if case == "far":
            kept_far.append(float((~rejected).float().mean()))
        if case == "sliver":
            assert bool(covered.any(1).sum() > 10)
    if case == "sliver":  # pixel centres on the dilated boundary, within float32 rounding of -margin
        assert boundary > 100, boundary
    if case == "far":  # the margin grows each footprint, and most far triangles still go
        assert np.mean(kept_far) < 0.3, np.mean(kept_far)


@pytest.mark.parametrize("tile_h", [8, 16])
def test_gbuffer_reject_never_drops_a_pair_the_plain_resolve_covers(tile_h):
    """Kernels 2 / 4's culled resolve on a seeded textured binning (C = 14,
    128×64, a near camera: a jumbo run; 8×128 tiles at PPT 4, 16×128 at PPT
    8; no back-face culling), in a peel behind the first layer's depth: every (pair, pixel) that the plain
    G-buffer resolve's test passes -- edges ≥ 0, depth in [0, 1] and behind
    the z floor, in float32 as ``raster_row._resolve_plain`` forms them --
    lies in a warp (``raster_row.warp_pixels``) for which
    ``footprint_rejects`` keeps the pair; and the reject drops most (pair,
    warp)s."""
    # a near camera (a jumbo run), no culling: the peel behind the front faces finds the back faces
    binned, _, kw = _textured_binning(tile_h, max_span=1, position=(0.0, 0.0, -2.5), cull=False)
    assert int(binned.starts[0]) > 0, "no jumbo run"
    rkw = dict(width=W, rows=H, y_offset=0, tile_h=tile_h, tile_w=128, mat_stride=1, num_ch=15)
    args = (binned.starts, binned.packed, binned.pair_tri)
    code0, gb0 = raster_row.raster_gbuffer_tiles_plain(*args, **rkw)
    floor = torch.where(code0 >= 0, gb0[..., -1], -torch.inf)
    ppt = raster_row.pixels_per_thread(tile_h * 128)
    box, row, col, ok = warp_boxes(ppt=ppt, **rkw)  # (tiles, 8) each; (tiles, 8, S) each
    st = binned.starts.tolist()
    covered = dropped = kept = 0
    for tile in range(len(st) - 1):
        pairs = torch.tensor([*range(st[0]), *range(st[tile], st[tile + 1])], dtype=torch.long)
        f = binned.packed[pairs, :14]
        px, py = col[tile].float() + 0.5, row[tile].float() + 0.5  # (8, S), y_offset 0
        dx, dy = px - f[:, 9, None, None], py - f[:, 10, None, None]  # (P, 8, S)
        e = [dx * f[:, i, None, None] + dy * f[:, 3 + i, None, None] + f[:, 6 + i, None, None] for i in range(3)]
        z = dx * f[:, 11, None, None] + dy * f[:, 12, None, None] + f[:, 13, None, None]
        zf = floor[row[tile].clamp(max=H - 1), col[tile].clamp(max=W - 1)]
        cov = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (z >= 0) & (z <= 1) & (z > zf) & ok[tile]
        drop = raster_row.footprint_rejects(f[:, None, :11], *(b[tile] for b in box))  # (P, 8)
        assert not bool((drop[..., None] & cov).any()), f"tile {tile}: a dropped (pair, warp) covers a pixel"
        covered += int(cov.sum())
        has_pixels = ok[tile].any(-1)
        dropped += int((drop & has_pixels).sum())
        kept += int((~drop & has_pixels).sum())
    code1, _ = raster_row.raster_gbuffer_tiles_plain(*args, z_floor=floor, **rkw)
    assert covered > 0 and bool((code1 >= 0).any())
    assert dropped > 2 * kept, (dropped, kept)


def test_footprint_reject_is_nan_safe_and_drops_the_far_side():
    xy = torch.tensor([[[100.0, 100.0], [104.0, 100.0], [100.0, 104.0]]])
    ones = torch.ones((1, 3))
    f = pack_triangle_fields(_setup_from_corner_data(xy, ones * 0.5, ones, ones, False, None))
    assert bool(raster_row.footprint_rejects(f, 200.5, 215.5, 300.5, 307.5).all())
    assert not bool(raster_row.footprint_rejects(f, 96.5, 111.5, 96.5, 103.5).any())
    assert not bool(raster_row.footprint_rejects(torch.full_like(f, float("nan")), 200.5, 215.5, 300.5, 307.5).any())


def test_shade_backward_skips_outputs_not_asked_for():
    gb = random_gbuffer(7)
    t = torch.as_tensor
    uni = pack_shading_uniforms(**{k: t(v) for k, v in gb["lights"].items()})
    args = (t(gb["g_chan"]), t(gb["attrs"]), t(gb["mat_id"]), t(gb["hit"]), t(gb["mat_props"]), uni)
    kw = dict(gb["counts"], apply_tonemap=True)
    full = raster_pallas.shade_backward(*args, **kw)
    for want_attrs, want_props in ((False, False), (True, False), (False, True)):
        got = raster_pallas.shade_backward(*args, want_attrs=want_attrs, want_props=want_props, **kw)
        assert (got[0] is None) != want_attrs and (got[1] is None) != want_props
        for a, b in zip(full, got):
            assert b is None or torch.equal(a, b)


def test_shade_fused_table_gradient_without_attribute_gradient():
    gb = random_gbuffer(8)
    t = torch.as_tensor
    lights = {k: t(v) for k, v in gb["lights"].items()}
    order = ("light_strength", "light_direction", "light_position", "light_spot_power", "ambient", "eye")
    grads = []
    for attrs_grad in (True, False):
        attrs = t(gb["attrs"]).clone().requires_grad_(attrs_grad)
        table = t(gb["mat_props"]).clone().requires_grad_()
        out = raster_pallas.shade_fused(attrs, t(gb["mat_id"]), t(gb["hit"]), table,
                                        *(lights[k] for k in order), **gb["counts"])
        (g,) = torch.autograd.grad(torch.mean(out[..., :3] ** 2), table)
        grads.append(g)
    assert torch.equal(grads[0], grads[1]) and bool(grads[0].abs().sum() > 0)
