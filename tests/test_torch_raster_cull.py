"""The redesigned shade-mode raster (kernel 1's per-warp reject) and the
adjoint's optional outputs, on the CPU.

* ``chip_smoke.raster_tests`` — the (pair, pixel) tests a binning needs,
  the pixels of each pair's tile inside its triangle's screen box — equals
  a brute-force count on small binnings (the render binning, a forced jumbo
  run, a band at ``y_offset`` > 0, a dilated binning).
* ``raster_row.warp_pixels`` puts every pixel of a tile in exactly one
  (warp, slot), compact where it fits.
* ``raster_row.footprint_rejects``, the float32 model of the kernel's
  per-warp reject (the same arithmetic and slack as
  ``csrc/raster_shade_row.cu::warp_mask``), never drops a footprint that
  holds a pixel the exact test covers — over seeded triangles, slivers
  whose edges run through or ulps beside the footprint's border pixel
  centres, and far corners of the screen — and drops most far triangles.
* ``shade_backward(want_attrs=False, want_props=False)`` returns None in
  those places and the same ``g_uni`` and table; ``shade_fused``'s table
  gradient does not depend on whether the attributes ask for one.
"""

import numpy as np
import pytest
import torch

from chip_smoke import raster_tests, screen_xy
from physically_based_renderer_tpu_torch import Camera, flatten_scene_corners, math3d, scenes
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops.raster import _setup_from_corner_data
from physically_based_renderer_tpu_torch.ops.raster_bin import pack_triangle_fields
from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
from physically_based_renderer_tpu_torch.renderer import binning_params
from torch_parity import random_gbuffer

W, H = 128, 64


def _grid_binning(case):
    scene = scenes.red_sphere_grid_scene(8, 4, device="cpu")
    cam = Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device="cpu")
    g = flatten_scene_corners(scene)
    clip = math3d.transform_points_h(g.pos_w, cam.view_proj())
    kw = dict(width=W, height=H, rows=H, y_offset=0, tile_h=8, tile_w=128, cull_backface=True)
    kw.update(binning_params(g.num_triangles, W, H))
    margin = 0.0
    if case == "jumbo":
        kw.update(tile_h=2, max_span=2, big_cap=None, pairs_cap=None)
    if case == "band":
        kw.update(rows=20, y_offset=37)
    if case == "dilated":
        margin = 3.0
    binned = raster_row.bin_for_shade(clip, None, None, bbox_margin_px=margin, **kw)
    return binned, screen_xy(clip, W, H), kw, margin


def _brute_force_tests(binned, xy, kw, margin):
    """Count, pair by pair and pixel by pixel, the pixels of each pair's tile
    (every tile for the jumbo run) inside its triangle's box."""
    width, rows, y_off, th, tw = kw["width"], kw["rows"], kw["y_offset"], kw["tile_h"], kw["tile_w"]
    tiles_x = -(-width // tw)
    ntiles = binned.starts.shape[0] - 1
    lo = xy.double().amin(1) - margin
    hi = xy.double().amax(1) + margin
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


@pytest.mark.parametrize("case", ["render", "jumbo", "band", "dilated"])
def test_raster_tests_counts_the_pixels_in_each_pairs_box(case):
    binned, xy, kw, margin = _grid_binning(case)
    assert case != "jumbo" or int(binned.starts[0]) > 0
    got = raster_tests(binned.starts, binned.pair_tri, xy, margin=margin, **kw)
    assert got == _brute_force_tests(binned, xy, kw, margin)
    full = (binned.starts.shape[0] - 1) * int(binned.starts[0]) + int(binned.starts[-1] - binned.starts[0])
    assert 0 < got < full * kw["tile_h"] * kw["tile_w"]


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
