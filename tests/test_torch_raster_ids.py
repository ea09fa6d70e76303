"""PyTorch port vs the JAX package: kernel 5, the exact-depth id raster.

The port's ``rasterize_binned`` on CPU tensors runs the plain version of the
ids mode (``raster_row.raster_ids_tiles_plain``); it is held against JAX
``rasterize_binned(..., interpret=True)`` on the same clip coordinates, for
every feature the render modes use: back-face culling on and off,
``tri_mask``, a ``z_floor`` peel (each side behind its own first layer:
XLA contracts FMAs in its binning, so the two sides' depths differ by
ulps), ``return_depth`` (+inf at background), material codes, a forced
jumbo run and a band. Ids are equal except at exact depth ties, where the
TPU kernel's leading pairs (each run aligned down to 128) may pick the other
triangle: each differing pixel is checked to be one. Depth within 1e-6
where both hit (the ulps of XLA's contracted binning).

Then the depth-test contract of ``tests/test_depth_quantization.py`` on the
port: the ids mode resolves a 60-ulp separation to the nearer quad in both
draw orders; the quantized kernels (1, 4 and 7) give it to the first drawn.
The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (phase s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import depth_ties
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.mesh import sphere_mesh as jsphere_mesh
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster_pallas as jpallas
from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row

W, H = 128, 64
DEPTH_ATOL = 1e-6
CASES = ["plain", "no_cull", "tri_mask", "z_floor", "depth", "material", "jumbo", "band"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _scene(case):
    """(clip, face_material, num_materials, width, height) of a case: the
    small sphere grid, or for the forced jumbo run one sphere close up in a
    two-tile-wide frame."""
    if case == "jumbo":
        mesh = jsphere_mesh(1.0, 12, 6)
        clip = jmath3d.transform_points_h(mesh.positions[mesh.tris], JCamera.create(
            position=(0.0, 0.0, -2.2), aspect=4.0).view_proj())
        return clip, jnp.asarray(np.arange(mesh.num_triangles) % 3), 3, 2 * W, H
    scene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    g = jflatten(scene, textured=False)
    clip = jmath3d.transform_points_h(g.pos_w, JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H).view_proj())
    return clip, g.face_material, scene.materials.num_materials, W, H


def _both(clip, kw, floors=(None, None)):
    """JAX's kernel 5 in interpret mode and the port's plain version → (JAX
    outputs as NumPy, port result, differing pixels)."""
    ref = jpallas.rasterize_binned(clip, None, interpret=True,
                                   z_floor=None if floors[0] is None else jnp.asarray(floors[0]), **kw)
    port_kw = dict(kw)
    for k in ("face_material", "tri_mask"):
        if port_kw.get(k) is not None:
            port_kw[k] = _t(port_kw[k])
    before = raster_row.IDS_KERNEL_LAUNCHES
    out = raster_pallas.rasterize_binned(_t(clip), None, z_floor=floors[1], **port_kw)
    assert raster_row.IDS_KERNEL_LAUNCHES == before  # CPU tensors take the plain version
    assert not bool(out.overflowed)
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    diff = out.tri_id.numpy() != ref[0]
    if diff.any():  # exact depth ties only, and only between two hits
        assert (out.tri_id.numpy()[diff] >= 0).all() and (ref[0][diff] >= 0).all()
        assert depth_ties(_t(clip), kw["width"], kw["height"], np.nonzero(diff), out.tri_id.numpy()[diff],
                          ref[0][diff], exact=True, y_offset=kw.get("y_offset", 0),
                          cull_backface=kw.get("cull_backface", True))
    return ref, out, diff


@pytest.mark.parametrize("case", CASES)
def test_kernel5_plain_version_matches_jax(case):
    clip, fm, num_materials, width, height = _scene(case)
    kw = dict(width=width, height=height)
    if case == "no_cull":
        kw["cull_backface"] = False
    if case == "tri_mask":
        kw["tri_mask"] = jnp.asarray(np.random.default_rng(5).uniform(size=clip.shape[0]) < 0.5)
    if case in ("depth", "z_floor", "jumbo"):
        kw["return_depth"] = True
    if case in ("material", "jumbo"):
        kw.update(face_material=fm, num_materials=num_materials)
    if case == "jumbo":
        kw["max_span"] = 1
    if case == "band":
        kw.update(rows=24, y_offset=20)  # ends in a partial tile
    if case == "z_floor":
        kw["cull_backface"] = False
        ref1, out1, _ = _both(clip, kw)
        floors = (np.where(ref1[0] >= 0, ref1[1], -np.inf).astype(np.float32),
                  torch.where(out1.tri_id >= 0, out1.depth, -torch.inf))
        ref, out, diff = _both(clip, kw, floors)
        hit1, hit2 = ref1[0] >= 0, ref[0] >= 0
        assert hit2[hit1].mean() > 0.9 and (ref[1][hit2] > ref1[1][hit2]).all()  # the back faces
    else:
        ref, out, diff = _both(clip, kw)
    if case == "jumbo":
        binned = raster_row.bin_for_shade(_t(clip), None, None, width=width, height=height, rows=height, y_offset=0,
                                          tile_h=16, tile_w=128, max_span=1, pairs_cap=None, big_cap=None,
                                          big2_span=0, big2_cap=None, cull_backface=True)
        assert int(binned.starts[0]) > 0  # the jumbo run is there
    hit = ref[0] >= 0
    assert 0.05 < hit.mean() < 0.95 and diff.sum() <= 4
    if case == "tri_mask":  # only masked-in triangles are drawn
        assert np.asarray(kw["tri_mask"])[out.tri_id.numpy()[out.tri_id.numpy() >= 0]].all()
    if "face_material" in kw:
        assert out.mat_id is not None
        np.testing.assert_array_equal(out.mat_id.numpy()[~diff], ref[1][~diff])
    else:
        assert out.mat_id is None
    if kw.get("return_depth"):
        depth_ref = ref[-1]
        same = hit & ~diff
        np.testing.assert_allclose(out.depth.numpy()[same], depth_ref[same], atol=DEPTH_ATOL, rtol=0)
        assert np.isposinf(out.depth.numpy()[~hit]).all() and np.isposinf(depth_ref[~hit]).all()
    else:
        assert out.depth is None


def test_negative_zero_depth_keys_as_zero():
    """A candidate at z = −0.0 ties one at +0.0 (the TPU kernel compares
    floats): the first drawn wins. Read as an int, −0.0 would win."""
    rec = torch.zeros((2, 16))
    rec[:, 6:9] = 1.0  # every pixel inside
    rec[1, 11:14] = -0.0  # z = (dx·−0 + dy·−0) + −0 = −0.0 at every pixel centre
    code, depth = raster_row.raster_ids_tiles_plain(
        torch.tensor([0, 2], dtype=torch.int32), rec, torch.tensor([0, 1], dtype=torch.int32), width=8, rows=4,
        y_offset=0, tile_h=4, tile_w=8, mat_stride=1, want_depth=True)
    assert (code == 0).all() and (depth == 0).all()


def test_rasterize_binned_refuses_later_features():
    clip = torch.zeros((2, 3, 4))
    # the indexed input runs (it raised until the geometry layer was ported): a
    # degenerate input covers nothing, indexed or corner-major
    out = raster_pallas.rasterize_binned(torch.zeros((3, 4)), torch.zeros((2, 3), dtype=torch.int64), width=8,
                                         height=8, return_depth=True)
    assert (out.tri_id == -1).all() and torch.isposinf(out.depth).all() and not bool(out.overflowed)
    # the dilated mode (kernel 5b, the soft raster's peels) runs: a degenerate
    # input covers nothing, margin or not
    out = raster_pallas.rasterize_binned(clip, None, width=8, height=8, edge_margin_px=0.5, return_depth=True)
    assert (out.tri_id == -1).all() and torch.isposinf(out.depth).all() and not bool(out.overflowed)
    with pytest.raises(ValueError, match="CUDA"):
        raster_row.raster_ids_tiles_cuda(torch.zeros(2, dtype=torch.int32), torch.zeros((1, 16)),
                                         torch.zeros(1, dtype=torch.int32), width=8, rows=8, y_offset=0,
                                         tile_h=8, tile_w=8, mat_stride=1)


# --- the depth-test contract (tests/test_depth_quantization.py) --------------

ULP = np.float32(2.0**-24)  # ulp of f32 values in [0.5, 1)
Z_NEAR_SUBQ = np.float32(0.5) + 30 * ULP
Z_FAR_SUBQ = np.float32(0.5) + 90 * ULP  # 60 ulp behind: inside one quantum of the packed key
Z_FAR_SUPER = np.float32(0.5 + 1e-3)  # ~2000 ulp behind


def _two_quads(z_first, z_second):
    """Two full-viewport quads, corner-major; the first is triangles {0, 1}."""

    def quad(z):
        return [[-3.0, -3.0, z, 1.0], [3.0, -3.0, z, 1.0], [3.0, 3.0, z, 1.0], [-3.0, 3.0, z, 1.0]]

    verts = np.asarray(quad(z_first) + quad(z_second), np.float32)
    return torch.as_tensor(verts[np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]])])


def _ids(kernel, z_first, z_second):
    vc = _two_quads(z_first, z_second)
    if kernel == "ids_exact":
        return raster_pallas.rasterize_binned(vc, None, width=W, height=H, cull_backface=False).tri_id.numpy()
    if kernel == "gbuffer_v1":
        return raster_pallas.rasterize_binned_gbuffer(vc, torch.ones((4, 3, 6)), width=W, height=H,
                                                      cull_backface=False).tri_id.numpy()
    l3 = torch.zeros((1, 3))
    out = raster_pallas.raster_shade(vc, torch.ones((4, 3, 6)), torch.zeros(4, dtype=torch.int64),
                                     torch.full((1, 9), 0.5), l3, l3, l3, torch.zeros(1), torch.zeros(3),
                                     torch.zeros(3), width=W, height=H, cull_backface=False, num_materials=1,
                                     row_layout=kernel == "shade_row")
    return out.tri_id.numpy()


@pytest.mark.parametrize("kernel", ["ids_exact", "shade_row", "gbuffer_v1", "shade_v1"])
def test_depth_test_contract(kernel):
    """Kernel 5 (the ids mode) keeps the exact f32 depth test: a 60-ulp
    separation goes to the nearer quad in either draw order. Kernels 1, 4
    and 7 quantize it away: the first-drawn quad wins. A separation well
    past the quantum goes to the nearer quad in every kernel."""
    near_first, near_second = _ids(kernel, Z_NEAR_SUBQ, Z_FAR_SUBQ), _ids(kernel, Z_FAR_SUBQ, Z_NEAR_SUBQ)
    assert set(np.unique(near_first)) <= {0, 1}
    assert set(np.unique(near_second)) <= ({2, 3} if kernel == "ids_exact" else {0, 1})
    assert set(np.unique(_ids(kernel, Z_NEAR_SUBQ, Z_FAR_SUPER))) <= {0, 1}
    assert set(np.unique(_ids(kernel, Z_FAR_SUPER, Z_NEAR_SUBQ))) == {2, 3}
