"""PyTorch port vs the JAX package: the soft rasterizer's raster layer —
kernel 5's dilated mode (kernel 5b), the dilated binning,
``interpolate_corners(clamp=True)`` and ``peel_layers`` — and
``tests/test_soft.py``'s depth-peeling behaviour on the port.
``render_soft``'s frames and gradients are in ``tests/test_torch_soft.py``,
which shares this file's scene and helpers.

The port always peels with the kernel, as the JAX package does on an
accelerator; its own CPU branch peels with its jnp rasterizer, which clips a
dilated triangle to its bbox + margin, so the two JAX paths disagree on most
dilated pixels. Every parity test here therefore holds the port against
JAX's kernel 5 in interpret mode (``peel_layers(backend="pallas_interpret")``).

Tolerances:
  * binning: pair sets and starts equal; edge fields within EDGE_ULPS ulps
    (a, b: of the column's largest value; c0: of the edge function's size
    over the pair's bbox + margin) — XLA's ``rsqrt`` and contracted FMAs
    against torch's; the depth plane's error over the pair's bbox + margin,
    |Δza|·dx + |Δzb|·dy + |Δzc|, within DEPTH_FIELD_ATOL (za and zb are sums
    that cancel, and XLA contracts them);
  * ids: every differing pixel is attributed by
    ``chip_smoke.explain_soft_differences`` to a cause — a TPU leading pair
    (each run aligned down to 128: with dilated wedges a foreign pair before
    the run can cover, and win, a pixel), a depth near-tie within
    2·DEPTH_FIELD_ATOL, a coverage flip within EDGE_TOL px of the dilated
    edge, or an earlier peel's difference; none is left unexplained, and
    the leading-pair and total shares are bounded; depth within
    DEPTH_FIELD_ATOL where the ids agree;
  * ``interpolate_corners``: values atol 1e-5, gradients
    ``torch_parity.grad_tolerance`` (rtol 2e-3 + 5e-5·max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import explain_soft_differences
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster as jraster
from physically_based_renderer_tpu.ops import raster_bin as jbin
from physically_based_renderer_tpu.ops import raster_pallas as jpallas
from physically_based_renderer_tpu.ops import raster_soft as jsoft
from physically_based_renderer_tpu_torch import Camera, math3d, sphere_mesh
from physically_based_renderer_tpu_torch.ops import raster, raster_bin, raster_pallas, raster_row, raster_soft
from torch_parity import grad_tolerance

W, H = 96, 96
MARGIN = 3.0  # render_soft's edge margin at sigma 1
EDGE_ULPS = 4
DEPTH_FIELD_ATOL = 1.5e-5  # measured up to 1.2e-5 on the 96×96 sphere
EDGE_TOL = 1e-3
LEADING_MAX = 0.15  # share of hit pixels a TPU leading pair may win (11% measured, culled layer 0)
DIFF_MAX = 0.35  # share of hit pixels whose id may differ (30% measured, culled layer 1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _sphere(slices=24, stacks=12, **kw):
    """The parity scene: ``analytic_sphere_scene(slices=24, stacks=12)`` at
    the default camera → (JAX scene, JAX camera, JAX clip)."""
    jscene = jscenes.analytic_sphere_scene(slices=slices, stacks=stacks, **kw)
    jcam = JCamera.create(aspect=1.0)
    g = jflatten(jscene, textured=False)
    return jscene, jcam, jmath3d.transform_points_h(g.pos_w, jcam.view_proj())


def _explain(clip, cull, ids_ref, ids_got, floor_ref=None, floor_got=None):
    counts = explain_soft_differences(clip, W, H, MARGIN, cull, ids_ref, ids_got, floor_ref, floor_got,
                                      depth_tol=2 * DEPTH_FIELD_ATOL, edge_tol=EDGE_TOL)
    assert counts["unexplained"] == 0, counts
    hits = max(int((ids_ref >= 0).sum()), 1)
    assert counts["leading"] <= LEADING_MAX * hits, counts
    assert sum(counts.values()) <= DIFF_MAX * hits, (counts, hits)
    return counts


# --- the dilated binning -------------------------------------------------------


@pytest.mark.parametrize("margin", [0.0, MARGIN])
@pytest.mark.parametrize("cull", [True, False])
def test_bin_triangles_with_margin_matches_jax(margin, cull):
    """Pairs and starts equal JAX's (the bbox and band cull grown by the
    margin); fields within the stated ulps; margin 0 packs raw edges."""
    _, _, clip = _sphere()
    kw = dict(width=W, height=H, tile_h=16, tile_w=128, max_span=8, chunk=128)
    jb = jbin.bin_triangles(jraster.setup_corners(clip, W, H, cull, None), bbox_margin_px=margin,
                            pair_major=True, **kw)
    st = raster.setup_corners(_t(clip), W, H, cull, None)
    pb = raster_bin.bin_triangles(st, bbox_margin_px=margin, **kw)
    np.testing.assert_array_equal(pb.starts.numpy(), np.asarray(jb.starts))
    np.testing.assert_array_equal(pb.pair_tri.numpy(), np.asarray(jb.pair_tri))
    assert int(pb.num_pairs) == int(jb.num_pairs) and bool(pb.overflowed) == bool(jb.overflowed)
    n = int(pb.starts[-1])
    got, ref = pb.packed.numpy()[:n], np.asarray(jb.packed)[:n]
    np.testing.assert_array_equal(got[:, 9:11], ref[:, 9:11])
    xy = st.xy[pb.pair_tri[:n].long()].numpy()
    ext = np.abs(xy - xy[:, :1]).max(1) + margin  # each pair's offsets from corner 0 over its bbox + margin
    # a, b: ulps of the column's largest; c0 (a cancelling sum, 0 for the two
    # edges through corner 0): ulps of the edge function's size over the bbox
    ab_scale = np.abs(ref[:, :6]).max(0)
    assert (np.abs(got[:, :6] - ref[:, :6]) <= EDGE_ULPS * np.spacing(ab_scale)).all()
    c_scale = (np.abs(ref[:, 0:3]) * ext[:, :1] + np.abs(ref[:, 3:6]) * ext[:, 1:]).astype(np.float32)
    assert (np.abs(got[:, 6:9] - ref[:, 6:9]) <= EDGE_ULPS * np.spacing(c_scale)).all()
    d = np.abs(got[:, 11:14] - ref[:, 11:14]).astype(np.float64)
    assert (d[:, 0] * ext[:, 0] + d[:, 1] * ext[:, 1] + d[:, 2]).max() <= DEPTH_FIELD_ATOL
    if margin > 0:  # unit-gradient edges
        np.testing.assert_allclose(np.hypot(got[:, 0:3], got[:, 3:6]), 1.0, atol=1e-6)
    else:  # the raw edges: the hard path is unchanged
        torch.testing.assert_close(pb.packed, raster_bin.bin_triangles(st, **kw).packed, rtol=0, atol=0)
    if margin > 0:  # the dilated bins hold more pairs
        assert n > int(raster_bin.bin_triangles(st, **kw).starts[-1])


# --- kernel 5b's plain version ---------------------------------------------------


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("floor", [False, True])
def test_kernel5b_plain_version_matches_jax(cull, floor):
    """The port's ``rasterize_binned(edge_margin_px=3)`` on CPU tensors (the
    plain version of the dilated ids mode) against JAX's kernel 5 in
    interpret mode, alone or behind each side's own first layer."""
    _, _, clip = _sphere()
    pclip = _t(clip)
    kw = dict(width=W, height=H, return_depth=True, edge_margin_px=MARGIN, cull_backface=cull)
    jf = pf = None
    if floor:
        j0 = jpallas.rasterize_binned(clip, None, interpret=True, **kw)
        p0 = raster_pallas.rasterize_binned(pclip, None, **kw)
        jf = jnp.where(j0[0] >= 0, j0[1], -jnp.inf)
        pf = torch.where(p0.tri_id >= 0, p0.depth, -torch.inf)
    ref_id, ref_z = (np.asarray(r) for r in jpallas.rasterize_binned(clip, None, interpret=True, z_floor=jf, **kw))
    before = (raster_row.IDS_KERNEL_LAUNCHES, raster_row.IDS_MARGIN_KERNEL_LAUNCHES)
    out = raster_pallas.rasterize_binned(pclip, None, z_floor=pf, **kw)
    assert (raster_row.IDS_KERNEL_LAUNCHES, raster_row.IDS_MARGIN_KERNEL_LAUNCHES) == before  # the plain version
    assert not bool(out.overflowed)
    hit = ref_id >= 0
    assert 0.2 < hit.mean() < 0.8
    counts = _explain(pclip, cull, _t(ref_id), out.tri_id, None if jf is None else _t(jf), pf)
    same = hit & (ref_id == out.tri_id.numpy())
    np.testing.assert_allclose(out.depth.numpy()[same], ref_z[same], atol=DEPTH_FIELD_ATOL, rtol=0)
    assert np.isposinf(out.depth.numpy()[out.tri_id.numpy() < 0]).all()
    if floor:
        assert (out.depth.numpy()[out.tri_id.numpy() >= 0] > pf.numpy()[out.tri_id.numpy() >= 0]).all()
    if cull and not floor:
        assert counts["leading"] > 0  # the sphere's slivers: wedges cover pixels past their own tiles' runs


def test_kernel5b_dilates_coverage():
    """Margin 3 covers every pixel margin 0 covers, with the same winner's
    depth or nearer, and more; a ``rasterize_binned`` with a margin runs."""
    _, _, clip = _sphere()
    pclip = _t(clip)
    hard = raster_pallas.rasterize_binned(pclip, None, width=W, height=H, return_depth=True)
    soft = raster_pallas.rasterize_binned(pclip, None, width=W, height=H, return_depth=True, edge_margin_px=MARGIN)
    h, s = hard.tri_id >= 0, soft.tri_id >= 0
    assert bool(s[h].all()) and int(s.sum()) > int(h.sum())
    assert bool((soft.depth[h] <= hard.depth[h] + DEPTH_FIELD_ATOL).all())
    no_depth = raster_pallas.rasterize_binned(pclip, None, width=W, height=H, edge_margin_px=MARGIN)
    assert no_depth.depth is None and torch.equal(no_depth.tri_id, soft.tri_id)


# --- interpolate_corners(clamp=True) ---------------------------------------------


def test_interpolate_corners_clamp_matches_jax():
    """Values and gradients (to the attributes and the clip coordinates) on
    the first dilated peel's ids, whose fringe pixels lie outside their
    triangles: there the clamp projects the barycentrics onto the face."""
    _, _, clip = _sphere()
    rng = np.random.default_rng(3)
    attrs = rng.normal(size=(clip.shape[0], 3, 6)).astype(np.float32)
    ids = raster_pallas.rasterize_binned(_t(clip), None, width=W, height=H, edge_margin_px=MARGIN).tri_id
    w_a = rng.normal(size=(H, W, 6)).astype(np.float32)
    w_d = rng.normal(size=(H, W)).astype(np.float32)

    def jloss(a, c):
        at, d, _ = jraster.interpolate_corners(a, c, jnp.asarray(ids.numpy()), width=W, height=H, clamp=True)
        hit = ids.numpy() >= 0  # background pixels read triangle 0: the port gives it no gradient
        return jnp.sum(jnp.where(hit[..., None], at, 0.0) * w_a) + jnp.sum(jnp.where(hit, d, 0.0) * w_d), (at, d)

    (_, (ja, jd)), (jga, jgc) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(attrs), clip)
    a, c = _t(attrs).requires_grad_(), _t(clip).requires_grad_()
    at, d, mask = raster.interpolate_corners(a, c, ids, width=W, height=H, clamp=True)
    hit = ids >= 0
    np.testing.assert_allclose(at.detach().numpy()[hit.numpy()], np.asarray(ja)[hit.numpy()], atol=1e-5, rtol=0)
    np.testing.assert_allclose(d.detach().numpy()[hit.numpy()], np.asarray(jd)[hit.numpy()], atol=1e-5, rtol=0)
    loss = (torch.where(hit[..., None], at, 0.0) * _t(w_a)).sum() + (torch.where(hit, d, 0.0) * _t(w_d)).sum()
    ga, gc = torch.autograd.grad(loss, (a, c))
    grad_tolerance(np.asarray(jga), ga.numpy())
    grad_tolerance(np.asarray(jgc), gc.numpy())
    unclamped = raster.interpolate_corners(a, c, ids, width=W, height=H)[0]
    assert float((unclamped - at).detach().abs().max()) > 1e-2  # the fringe pixels moved onto the face


# --- peel_layers ------------------------------------------------------------------


@pytest.mark.parametrize("cull", [True, False])
def test_peel_layers_matches_jax(cull):
    """Three dilated peels, each behind its own side's previous layer: ids
    attributed layer by layer (a difference in an earlier layer cascades),
    depth within DEPTH_FIELD_ATOL where the ids agree; nearest first."""
    _, _, clip = _sphere()
    pclip = _t(clip)
    kw = dict(width=W, height=H, num_layers=3, cull_backface=cull, edge_margin_px=MARGIN)
    j_ids, j_zs = (np.asarray(x) for x in jsoft.peel_layers(clip, None, backend="pallas_interpret", **kw))
    before = raster_row.IDS_MARGIN_KERNEL_LAUNCHES
    ids, zs = raster_soft.peel_layers(pclip, None, **kw)
    assert raster_row.IDS_MARGIN_KERNEL_LAUNCHES == before
    assert ids.shape == (3, H, W) and ids.dtype == torch.int32 and zs.dtype == torch.float32
    jf = pf = None
    for k in range(3):
        _explain(pclip, cull, _t(j_ids[k]), ids[k], None if jf is None else _t(jf), pf)
        same = (j_ids[k] >= 0) & (j_ids[k] == ids[k].numpy())
        np.testing.assert_allclose(zs[k].numpy()[same], j_zs[k][same], atol=DEPTH_FIELD_ATOL, rtol=0)
        jf = np.where(np.isfinite(j_zs[k]), j_zs[k], -np.inf if jf is None else jf).astype(np.float32)
        pf = torch.where(torch.isfinite(zs[k]), zs[k], -torch.inf if pf is None else pf)
    both = (ids[0] >= 0) & (ids[1] >= 0)
    assert int(both.sum()) > 100 and bool((zs[1][both] > zs[0][both]).all())
    assert bool((ids[0][both] != ids[1][both]).all())
    with pytest.raises(ValueError, match="backend"):  # the indexed input runs now; an unknown backend raises
        raster_soft.peel_layers(pclip, None, backend="tpu", **kw)


def test_peel_layers_raises_on_overflow():
    _, _, clip = _sphere()
    with pytest.raises(RuntimeError, match="overflow"):
        raster_soft.peel_layers(_t(clip), None, width=W, height=H, num_layers=2, edge_margin_px=MARGIN,
                                pairs_cap=16)



def test_depth_peeling_layers():
    """Sphere, culling off: layer 0 the front faces, layer 1 the back faces."""
    mesh = sphere_mesh(1.0, 16, 8, device="cpu")
    cam = Camera.create(aspect=1.0, device="cpu")
    clip = math3d.transform_points_h(mesh.positions[mesh.tris.long()], cam.view_proj())
    ids, zs = raster_soft.peel_layers(clip, None, width=W, height=H, num_layers=2, cull_backface=False)
    both = (ids[0] >= 0) & (ids[1] >= 0)
    assert int(both.sum()) > 100
    assert bool((zs[1][both] > zs[0][both]).all()) and bool((ids[0][both] != ids[1][both]).all())

