"""PyTorch port vs the JAX package: triangle binning. From identical
screen-space setups the per-tile ``starts`` and the sorted pair triangle ids
are identical, in every emission class (small2, big, big2, jumbo, ranked
spill to jumbo) and for a band with ``y_offset``; the packed per-pair fields
agree to float32 rounding (XLA contracts some of their products into FMAs;
atol 1e-4 on fields of magnitude ≲ 2000, rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops.raster import setup_corners as jsetup
from physically_based_renderer_tpu.ops.raster_bin import bin_triangles as jbin
from physically_based_renderer_tpu_torch.ops.raster import ScreenTris
from physically_based_renderer_tpu_torch.ops.raster_bin import bin_triangles, check_binning_invariants
from physically_based_renderer_tpu_torch.renderer import binning_params

# (width, height, rows, y_offset, tile_h, binning overrides)
CASES = {
    # the row-kernel settings render() uses for a small scene
    "frame_128x64": (128, 64, None, 0, 8, binning_params(1000, 128, 64)),
    # a 256x128 band of a taller viewport
    "band_256x128_y48": (256, 320, 128, 48, 8, binning_params(1000, 256, 320)),
    # big-scene settings: max_span 16, no big2, a tiny ranked big block that spills
    "ranked_spill": (256, 128, None, 0, 4, dict(max_span=16, big_cap=8)),
    # a narrow span limit sends the larger triangles to the jumbo run
    "jumbo": (256, 128, None, 0, 4, dict(max_span=2)),
    # big2 block with a cap small enough to spill into jumbo
    "big2_spill": (256, 128, None, 16, 4, dict(max_span=4, big2_span=64, big2_cap=3)),
}


def _setups(width, height, position):
    scene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    cam = JCamera.create(position=position, aspect=width / height)
    g = jflatten(scene, textured=False)
    clip = jmath3d.transform_points_h(g.pos_w, cam.view_proj())
    a = jsetup(clip, width, height, True, None)
    # Identical setup inputs for both binnings (setup parity is tested apart).
    b = ScreenTris(**{k: torch.as_tensor(np.array(getattr(a, k))) for k in ("xy", "z", "inv_w", "area", "valid")})
    fm = np.array(g.face_material)
    return a, b, fm, g


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("position", [(0.0, -3.0, -18.0), (2.0, -6.0, -9.0)])
def test_bin_triangles_matches(case, position):
    width, height, rows, y_offset, tile_h, kw = CASES[case]
    a, b, fm, g = _setups(width, height, position)
    cc = np.concatenate(
        [np.asarray(g.attrs) * np.asarray(a.inv_w)[..., None], np.asarray(a.inv_w)[..., None]], -1
    )
    ja = jbin(a, width=width, height=height, rows=rows, y_offset=y_offset, tile_h=tile_h,
              tile_w=128, face_material=jnp.asarray(fm), corner_channels=jnp.asarray(cc),
              pair_major=True, **kw)
    tb = bin_triangles(b, width=width, height=height, rows=rows, y_offset=y_offset,
                       tile_h=tile_h, tile_w=128, face_material=torch.as_tensor(fm),
                       corner_channels=torch.as_tensor(cc), **kw)
    np.testing.assert_array_equal(tb.starts.numpy(), np.asarray(ja.starts))
    np.testing.assert_array_equal(tb.pair_tri.numpy(), np.asarray(ja.pair_tri))
    assert int(tb.num_pairs) == int(ja.num_pairs)
    assert bool(tb.overflowed) == bool(ja.overflowed) is False
    np.testing.assert_allclose(tb.packed.numpy(), np.asarray(ja.packed), atol=1e-4, rtol=1e-5)
    assert int(tb.starts[-1]) > 0
    check_binning_invariants(tb, b.xy.shape[0])


def test_emission_classes_are_exercised():
    """The cases above really reach the jumbo run and the ranked spill."""
    width, height, rows, y_offset, tile_h, kw = CASES["jumbo"]
    _, b, _, _ = _setups(width, height, (0.0, -3.0, -18.0))
    jumbo = bin_triangles(b, width=width, height=height, tile_h=tile_h, tile_w=128, **kw)
    assert int(jumbo.starts[0]) > 0
    _, _, _, _, tile_h, kw = CASES["ranked_spill"]
    spill = bin_triangles(b, width=width, height=height, tile_h=tile_h, tile_w=128, **kw)
    assert int(spill.starts[0]) > 0  # spilled big triangles form a jumbo run


def test_overflow_is_reported_and_raises():
    width, height = 128, 64
    a, b, _, _ = _setups(width, height, (0.0, -3.0, -18.0))
    ja = jbin(a, width=width, height=height, tile_h=8, tile_w=128, pairs_cap=16, pair_major=True)
    tb = bin_triangles(b, width=width, height=height, tile_h=8, tile_w=128, pairs_cap=16)
    assert bool(tb.overflowed) and bool(ja.overflowed)
    np.testing.assert_array_equal(tb.starts.numpy(), np.asarray(ja.starts))
    np.testing.assert_array_equal(tb.pair_tri.numpy(), np.asarray(ja.pair_tri))
    with pytest.raises(RuntimeError, match="overflow"):
        check_binning_invariants(tb, b.xy.shape[0])
