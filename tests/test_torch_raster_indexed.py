"""PyTorch port vs the JAX package: the indexed raster inputs and the CPU
raster oracles.

  * ``project_to_screen`` and ``setup_triangles`` within 1e-6·|v| (pixel
    coordinates within 1e-4); ``compute_barycentrics`` (``clamp`` both
    ways), ``interpolate`` and ``interpolate_packed`` at covered pixels
    within 5e-5 + 1e-5·|v| of jitted JAX (XLA contracts FMAs), gradients to
    the clip coordinates and the attributes under
    ``torch_parity.grad_tolerance``;
  * the oracles ``raster.rasterize`` and ``rasterize_brute`` on
    ``tests/test_raster.py``'s cases (ids exact against JAX's), and with
    ``tri_mask``, ``z_floor``, ``return_depth``, a band and
    ``edge_margin_px`` 3 against JAX's jnp rasterizer run op by op
    (``jax.disable_jit``: inside ``jit`` XLA contracts the edge functions
    into FMAs, which moves depths by up to ~40 ulps and, with a margin, a
    dilated edge pixel): ids exact, depth within 1e-6;
  * kernels 5, 5b and 4 (their plain versions, what CPU tensors run) with
    ``tris=`` against JAX's interpret mode with ``tris``: ids exact except
    at exact (kernel 5) or quantized (kernel 4) depth ties
    (``chip_smoke.depth_ties``), which the TPU kernel's leading pairs may
    resolve the other way; G-buffer within kernel 4's tolerance
    (``tests/test_torch_textured_render.py``: 2e-4, depth 2e-6);
  * in the port, indexed input equals the corner-major ``verts_clip[tris]``
    bit for bit; ``peel_layers(tris=, backend=)`` and
    ``signed_distance_px(tris=)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import depth_ties
from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu import sphere_mesh as jsphere_mesh
from physically_based_renderer_tpu.models.scene import flatten_scene as jflatten
from physically_based_renderer_tpu.ops import raster as jraster
from physically_based_renderer_tpu.ops import raster_pallas as jpallas
from physically_based_renderer_tpu.ops import raster_soft as jsoft
from physically_based_renderer_tpu_torch.ops import raster, raster_pallas, raster_row, raster_soft
from torch_parity import grad_tolerance

W, H = 128, 96
ATOL = 1e-6
DEPTH_ATOL = 1e-6  # the oracles, op by op
KERNEL_DEPTH_ATOL = 2e-6  # kernel 5 vs JAX interpret: the ulps of XLA's contracted indexed setup
ATTR_ATOL, GBUF_DEPTH_ATOL = 2e-4, 2e-6  # kernel 4's (tests/test_torch_textured_render.py)
INTERP_ATOL = 5e-5  # interpolated values against jitted JAX (XLA contracts FMAs: 1.8e-5 measured)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(t):
    return t.detach().cpu().numpy()


def _fullscreen(z=0.5):
    """tests/test_raster.py's big clockwise triangle over the viewport."""
    return (np.asarray([[-3.0, -1.0, z, 1.0], [3.0, -1.0, z, 1.0], [0.0, 3.0, z, 1.0]], np.float32),
            np.asarray([[0, 2, 1]], np.int32))


def _sphere(slices=24, stacks=12, aspect=W / H):
    mesh = jsphere_mesh(1.0, slices, stacks)
    clip = jmath3d.transform_points_h(mesh.positions, JCamera.create(aspect=aspect).view_proj())
    return np.asarray(clip), np.asarray(mesh.tris)


def _soup():
    rng = np.random.default_rng(0)
    verts = rng.uniform(-1, 1, size=(60, 3)).astype(np.float32)
    verts[:, 2] = rng.uniform(1.0, 5.0, size=60)
    tris = rng.integers(0, 60, size=(40, 3)).astype(np.int32)
    cam = JCamera.create(position=(0, 0, 0), aspect=W / H)
    return np.asarray(jmath3d.transform_points_h(jnp.asarray(verts), cam.view_proj())), tris


def _grid(aspect=W / H, textured=False):
    """The small sphere grid, indexed: clip (V, 4), tris, attrs (V, C), face material, M."""
    scene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    g = jflatten(scene)
    clip = jmath3d.transform_points_h(g.pos_w, JCamera.create(position=(0.0, -3.0, -18.0),
                                                              aspect=aspect).view_proj())
    cols = [g.pos_w, g.normal_w] + ([g.tangent_w, g.bitangent_w, g.uv] if textured else [])
    return (np.asarray(clip), np.asarray(g.tris), np.asarray(jnp.concatenate(cols, -1)), np.asarray(g.face_material),
            scene.materials.num_materials)


def _case(name):
    """(clip, tris, kwargs) of tests/test_raster.py's cases."""
    if name == "fullscreen":
        return (*_fullscreen(), {})
    if name == "backface":
        clip, tris = _fullscreen()
        return clip, tris[:, ::-1].copy(), {}
    if name == "backface_no_cull":
        clip, tris = _fullscreen()
        return clip, tris[:, ::-1].copy(), dict(cull_backface=False)
    if name == "depth_order":
        a, _ = _fullscreen(0.8)
        b, _ = _fullscreen(0.2)
        return np.concatenate([a, b]), np.asarray([[0, 2, 1], [3, 5, 4]], np.int32), {}
    if name == "depth_range":
        return (*_fullscreen(1.5), {})
    if name == "behind_camera":
        clip, tris = _fullscreen()
        clip[:, 3] = -1.0
        return clip, tris, {}
    if name == "sphere":
        return (*_sphere(), {})
    return (*_soup(), dict(cull_backface=False))


EXPECT = {"fullscreen": 0, "backface": -1, "backface_no_cull": 0, "depth_order": 1, "depth_range": -1,
          "behind_camera": -1}


@pytest.mark.parametrize("name", ["fullscreen", "backface", "backface_no_cull", "depth_order", "depth_range",
                                  "behind_camera", "sphere", "soup"])
def test_oracles_match_jax(name):
    clip, tris, kw = _case(name)
    tile_kw = dict(kw, tri_block=16) if name == "soup" else kw
    ref_brute = np.asarray(jraster.rasterize_brute(jnp.asarray(clip), jnp.asarray(tris), width=W, height=H, **kw))
    # JAX's tiled rasterizer on the meshes; on the one- and two-triangle cases JAX's
    # own test holds it equal to its brute one and to the expected ids
    ref = np.asarray(jraster.rasterize(jnp.asarray(clip), jnp.asarray(tris), width=W, height=H, **tile_kw)
                     ) if name in ("sphere", "soup") else ref_brute
    got = raster.rasterize(_t(clip), _t(tris), width=W, height=H, **tile_kw)
    got_brute = raster.rasterize_brute(_t(clip), _t(tris), width=W, height=H, **kw)
    assert got.dtype == torch.int32 and got.shape == (H, W)
    np.testing.assert_array_equal(_np(got), ref)
    np.testing.assert_array_equal(_np(got_brute), ref_brute)
    np.testing.assert_array_equal(_np(got), _np(got_brute))  # the tiled oracle equals the brute one
    if name in EXPECT:
        assert (_np(got) == EXPECT[name]).all()
    # corner-major input: the same ids
    np.testing.assert_array_equal(_np(raster.rasterize(_t(clip[tris]), None, width=W, height=H, **tile_kw)), ref)


@pytest.mark.parametrize("feature", ["tri_mask", "z_floor", "band", "margin"])
def test_tiled_oracle_features_match_jax(feature):
    clip, tris = _sphere(12, 6)
    kw = dict(width=W, height=H, return_depth=True)
    if feature == "tri_mask":
        kw["tri_mask"] = np.random.default_rng(3).uniform(size=tris.shape[0]) < 0.5
    if feature == "band":
        kw.update(rows=40, y_offset=30, tile_h=16)  # ends in a partial tile
    if feature == "margin":
        kw["edge_margin_px"] = 3.0
    if feature == "z_floor":  # the back faces, behind the front layer
        kw["cull_backface"] = False
        with jax.disable_jit():
            _, z0 = jraster.rasterize(jnp.asarray(clip), jnp.asarray(tris), **kw)
        kw["z_floor"] = np.where(np.isfinite(np.asarray(z0)), np.asarray(z0), -np.inf).astype(np.float32)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    pkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with jax.disable_jit():
        ref_id, ref_z = (np.asarray(a) for a in jraster.rasterize(jnp.asarray(clip), jnp.asarray(tris), **jkw))
    got_id, got_z = raster.rasterize(_t(clip), _t(tris), **pkw)
    np.testing.assert_array_equal(_np(got_id), ref_id)
    hit = ref_id >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_allclose(_np(got_z)[hit], ref_z[hit], atol=DEPTH_ATOL, rtol=0)
    assert np.isposinf(_np(got_z)[~hit]).all()
    if feature == "tri_mask":
        assert kw["tri_mask"][ref_id[hit]].all()
    if feature == "z_floor":
        assert (_np(got_z)[hit] > kw["z_floor"][hit]).all()


def test_screen_setup_matches_jax():
    clip, tris = _sphere(12, 6)
    for ref, got in zip(jraster.project_to_screen(jnp.asarray(clip), W, H), raster.project_to_screen(_t(clip), W, H)):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL, rtol=ATOL)
    mask = np.arange(tris.shape[0]) % 3 != 0
    ref = jraster.setup_triangles(jnp.asarray(clip), jnp.asarray(tris), W, H, True, jnp.asarray(mask))
    got = raster.setup_triangles(_t(clip), _t(tris), W, H, True, _t(mask))
    for f in ("xy", "z", "inv_w", "area"):
        np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(ref, f)), atol=1e-4, rtol=ATOL,
                                   err_msg=f)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    corner = raster.setup_corners(_t(clip)[_t(tris).long()], W, H, True, _t(mask))
    for f in ("xy", "z", "inv_w", "area", "valid"):  # the same floats as the corner-major setup
        assert torch.equal(getattr(got, f), getattr(corner, f)), f


def _ids(clip, tris):
    return np.asarray(jraster.rasterize_brute(jnp.asarray(clip), jnp.asarray(tris), width=W, height=H))


@pytest.mark.parametrize("clamp", [False, True])
def test_barycentrics_and_interpolation_match_jax(clamp):
    clip, tris = _sphere(12, 6)
    tid = _ids(clip, tris)
    rng = np.random.default_rng(4)
    attr = rng.normal(size=(clip.shape[0], 5)).astype(np.float32)
    hit = (tid >= 0).astype(np.float32)
    cots = [(rng.normal(size=s) * hit.reshape(H, W, *([1] * (len(s) - 2)))).astype(np.float32)
            for s in ((H, W, 3), (H, W, 3), (H, W), (H, W, 5), (H, W, 5))]

    def jfn(c, a):
        bp, bs, d, _ = jraster.compute_barycentrics(c, jnp.asarray(tris), jnp.asarray(tid), width=W, height=H,
                                                    clamp=clamp)
        packed, _, _ = jraster.interpolate_packed(a, c, jnp.asarray(tris), jnp.asarray(tid), width=W, height=H,
                                                  clamp=clamp)
        return bp, bs, d, jraster.interpolate(a, jnp.asarray(tris), jnp.asarray(tid), bp), packed

    refs, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(clip), jnp.asarray(attr))
    ref_g = vjp(tuple(jnp.asarray(c) for c in cots))

    c_t, a_t = _t(clip).requires_grad_(), _t(attr).requires_grad_()
    bp, bs, d, mask = raster.compute_barycentrics(c_t, _t(tris), _t(tid), width=W, height=H, clamp=clamp)
    packed, depth_p, mask_p = raster.interpolate_packed(a_t, c_t, _t(tris), _t(tid), width=W, height=H, clamp=clamp)
    outs = (bp, bs, d, raster.interpolate(a_t, _t(tris), _t(tid), bp), packed)
    hit = tid >= 0  # a background pixel extrapolates triangle 0's plane: garbage by contract, not compared
    for i, (got, ref) in enumerate(zip(outs, refs)):
        np.testing.assert_allclose(_np(got)[hit], np.asarray(ref)[hit], atol=INTERP_ATOL, rtol=1e-5, err_msg=str(i))
    np.testing.assert_array_equal(_np(mask), tid >= 0)
    torch.testing.assert_close(depth_p, d, atol=1e-6, rtol=1e-6)
    g_clip, g_attr = torch.autograd.grad(outs, (c_t, a_t), tuple(_t(c) for c in cots))
    grad_tolerance(ref_g[0], _np(g_clip))
    grad_tolerance(ref_g[1], _np(g_attr))


# -- the kernels' indexed input ------------------------------------------------


def _kernel5_both(clip, tris, kw, floors=(None, None)):
    """JAX's kernel 5 in interpret mode and the port's plain version, both
    on indexed input → (JAX outputs, port result, differing pixels)."""
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref = jpallas.rasterize_binned(jnp.asarray(clip), jnp.asarray(tris), interpret=True,
                                   z_floor=None if floors[0] is None else jnp.asarray(floors[0]), **jkw)
    pkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    out = raster_pallas.rasterize_binned(_t(clip), _t(tris), z_floor=floors[1], **pkw)
    assert not bool(out.overflowed)
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    diff = _np(out.tri_id) != ref[0]
    if diff.any():  # exact depth ties only, between two hits
        assert (_np(out.tri_id)[diff] >= 0).all() and (ref[0][diff] >= 0).all()
        assert depth_ties(_t(clip)[_t(tris).long()], kw["width"], kw["height"], np.nonzero(diff),
                          _np(out.tri_id)[diff], ref[0][diff], exact=True,
                          cull_backface=kw.get("cull_backface", True))
    return ref, out, diff


@pytest.mark.parametrize("case", ["solid", "material", "z_floor", "tri_mask"])
def test_kernel5_indexed_matches_jax(case):
    clip, tris, _, fm, num_materials = _grid()
    kw = dict(width=W, height=H, return_depth=True)
    if case == "material":
        kw.update(face_material=fm, num_materials=num_materials)
    if case == "tri_mask":
        kw["tri_mask"] = np.random.default_rng(5).uniform(size=tris.shape[0]) < 0.5
    if case == "z_floor":
        kw["cull_backface"] = False
        ref1, out1, _ = _kernel5_both(clip, tris, kw)
        floors = (np.where(ref1[0] >= 0, ref1[-1], -np.inf).astype(np.float32),
                  torch.where(out1.tri_id >= 0, out1.depth, -torch.inf))
        ref, out, diff = _kernel5_both(clip, tris, kw, floors)
    else:
        ref, out, diff = _kernel5_both(clip, tris, kw)
    hit = ref[0] >= 0
    assert 0.02 < hit.mean() < 0.95 and diff.sum() <= 4
    same = hit & ~diff
    np.testing.assert_allclose(_np(out.depth)[same], ref[-1][same], atol=KERNEL_DEPTH_ATOL, rtol=0)
    if case == "material":
        np.testing.assert_array_equal(_np(out.mat_id)[~diff], ref[1][~diff])
    # indexed input equals the corner-major clip[tris] bit for bit
    pkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    corner = raster_pallas.rasterize_binned(_t(clip)[_t(tris).long()], None,
                                            z_floor=None if case != "z_floor" else floors[1], **pkw)
    assert torch.equal(corner.tri_id, out.tri_id) and torch.equal(corner.depth, out.depth)


def test_kernel5b_indexed_matches_corner_major_and_jax():
    """Kernel 5b (margin 3 px) on indexed input: bit-equal to the corner-major
    input; against JAX's kernel-5 path in interpret mode, every differing id
    is attributed by ``chip_smoke.explain_soft_differences`` (the dilated
    path's known causes, ``tests/test_torch_soft.py``)."""
    from chip_smoke import explain_soft_differences

    clip, tris = _sphere()
    kw = dict(width=W, height=H, return_depth=True, edge_margin_px=3.0)
    out = raster_pallas.rasterize_binned(_t(clip), _t(tris), **kw)
    corner_clip = _t(clip)[_t(tris).long()]
    corner = raster_pallas.rasterize_binned(corner_clip, None, **kw)
    assert torch.equal(corner.tri_id, out.tri_id) and torch.equal(corner.depth, out.depth)
    ref_id, _ = jpallas.rasterize_binned(jnp.asarray(clip), jnp.asarray(tris), interpret=True, **kw)
    ref_id = np.asarray(ref_id)
    hit = ref_id >= 0
    assert 0.05 < hit.mean() < 0.95
    counts = explain_soft_differences(corner_clip, W, H, 3.0, True, _t(ref_id), out.tri_id,
                                      depth_tol=3e-5, edge_tol=1e-3)  # tests/test_torch_soft.py's
    assert counts["unexplained"] == 0, counts
    assert sum(counts.values()) <= 0.35 * hit.sum(), counts  # tests/test_torch_soft.py's DIFF_MAX


@pytest.mark.parametrize("textured", [False, True])
def test_kernel4_indexed_matches_jax(textured):
    clip, tris, attrs, fm, num_materials = _grid(textured=textured)
    mask = np.arange(tris.shape[0]) % 5 != 0
    kw = dict(width=W, height=H, num_materials=num_materials)
    ref = jpallas.rasterize_binned_gbuffer(jnp.asarray(clip), jnp.asarray(tris), jnp.asarray(attrs),
                                           face_material=jnp.asarray(fm), tri_mask=jnp.asarray(mask),
                                           interpret=True, **kw)
    ref = [np.asarray(r) for r in ref]
    out = raster_pallas.rasterize_binned_gbuffer(_t(clip), _t(attrs), _t(fm), tris=_t(tris), tri_mask=_t(mask), **kw)
    assert not bool(out.overflowed) and out.attrs.shape[-1] == attrs.shape[-1]
    diff = _np(out.tri_id) != ref[2]
    if diff.any():  # quantized-depth ties only
        assert depth_ties(_t(clip)[_t(tris).long()], W, H, np.nonzero(diff), _np(out.tri_id)[diff], ref[2][diff],
                          exact=False)
    hit = ref[2] >= 0
    assert 0.02 < hit.mean() < 0.95 and diff.sum() <= 4 and mask[ref[2][hit]].all()
    same = ~diff
    np.testing.assert_array_equal(_np(out.mat_id)[same], ref[3][same])
    np.testing.assert_allclose(_np(out.attrs)[same], ref[0][same], atol=ATTR_ATOL, rtol=0)
    np.testing.assert_allclose(_np(out.depth)[same], ref[1][same], atol=GBUF_DEPTH_ATOL, rtol=0)
    # indexed = corner-major, bit for bit; raster_gbuffer takes the same input
    idx = _t(tris).long()
    corner = raster_pallas.rasterize_binned_gbuffer(_t(clip)[idx], _t(attrs)[idx], _t(fm), tri_mask=_t(mask), **kw)
    diffable = raster_pallas.raster_gbuffer(_t(clip), _t(attrs), _t(fm), tris=_t(tris), **kw)
    plain = raster_pallas.rasterize_binned_gbuffer(_t(clip), _t(attrs), _t(fm), tris=_t(tris), **kw)
    for a, b in ((corner, out), (diffable, plain)):
        assert torch.equal(a.tri_id, b.tri_id) and torch.equal(a.attrs, b.attrs) and torch.equal(a.depth, b.depth)
    with pytest.raises(ValueError):
        raster_pallas.raster_gbuffer(_t(clip), _t(attrs), _t(fm), tris=_t(tris), row_layout=True, **kw)


def test_raster_gbuffer_indexed_gradients():
    """Gradients of the indexed raster_gbuffer reach the vertices: the
    corner-major input's gradients summed into each corner's vertex."""
    clip, tris, attrs, fm, num_materials = _grid()
    kw = dict(width=W, height=H, num_materials=num_materials)
    rng = np.random.default_rng(6)
    g_attrs = _t(rng.normal(size=(H, W, attrs.shape[-1])).astype(np.float32))
    g_depth = _t(rng.normal(size=(H, W)).astype(np.float32))
    vc, pa = _t(clip).requires_grad_(), _t(attrs).requires_grad_()
    out = raster_pallas.raster_gbuffer(vc, pa, _t(fm), tris=_t(tris), **kw)
    gv, gp = torch.autograd.grad((out.attrs, out.depth), (vc, pa), (g_attrs, g_depth))
    idx = _t(tris).long()
    vc_c, pa_c = _t(clip)[idx].requires_grad_(), _t(attrs)[idx].requires_grad_()
    out_c = raster_pallas.raster_gbuffer(vc_c, pa_c, _t(fm), **kw)
    gvc, gpc = torch.autograd.grad((out_c.attrs, out_c.depth), (vc_c, pa_c), (g_attrs, g_depth))
    want_v = torch.zeros_like(vc).index_add_(0, idx.reshape(-1), gvc.reshape(-1, 4))
    want_p = torch.zeros_like(pa).index_add_(0, idx.reshape(-1), gpc.reshape(-1, attrs.shape[-1]))
    torch.testing.assert_close(gv, want_v, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(gp, want_p, atol=1e-6, rtol=1e-5)
    assert float(gv.abs().sum()) > 0


def test_peel_layers_indexed_and_backends():
    clip, tris, *_ = _grid()
    kw = dict(width=W, height=H, num_layers=3, edge_margin_px=3.0)
    ids, zs = raster_soft.peel_layers(_t(clip), _t(tris), **kw)
    ids_c, zs_c = raster_soft.peel_layers(_t(clip)[_t(tris).long()], None, **kw)
    assert torch.equal(ids, ids_c) and torch.equal(zs, zs_c)
    before = raster_row.IDS_MARGIN_KERNEL_LAUNCHES
    ids_p, _ = raster_soft.peel_layers(_t(clip), _t(tris), backend="pallas_interpret", **kw)
    assert torch.equal(ids_p, ids) and raster_row.IDS_MARGIN_KERNEL_LAUNCHES == before  # the plain version
    # "jnp": the tiled oracle with its bbox clip and z clamp, as JAX's jnp peels
    clip, tris = _sphere(12, 6)
    kw["num_layers"] = 2
    with jax.disable_jit():
        ref_ids, ref_zs = jsoft.peel_layers(jnp.asarray(clip), jnp.asarray(tris), backend="jnp", **kw)
    got_ids, got_zs = raster_soft.peel_layers(_t(clip), _t(tris), backend="jnp", **kw)
    np.testing.assert_array_equal(_np(got_ids), np.asarray(ref_ids))
    hit = np.asarray(ref_ids) >= 0
    np.testing.assert_allclose(_np(got_zs)[hit], np.asarray(ref_zs)[hit], atol=DEPTH_ATOL, rtol=0)
    assert (hit.sum(axis=(1, 2)) > 0).all()
    with pytest.raises(ValueError):
        raster_soft.peel_layers(_t(clip), _t(tris), backend="cuda_magic", **kw)


def test_signed_distance_indexed_matches_jax():
    clip, tris, *_ = _grid()
    tid = np.asarray(jraster.rasterize_brute(jnp.asarray(clip), jnp.asarray(tris), width=W, height=H))
    cot = np.random.default_rng(7).normal(size=(H, W)).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda c: jsoft.signed_distance_px(c, jnp.asarray(tris), jnp.asarray(tid), width=W,
                                                                  height=H)), jnp.asarray(clip))
    c_t = _t(clip).requires_grad_()
    got = raster_soft.signed_distance_px(c_t, _t(tris), _t(tid), width=W, height=H)
    hit = tid >= 0
    np.testing.assert_allclose(_np(got)[hit], np.asarray(ref)[hit], atol=1e-4, rtol=1e-5)
    (g,) = torch.autograd.grad(got, c_t, torch.where(_t(hit), _t(cot), 0.0))
    grad_tolerance(vjp(jnp.where(jnp.asarray(hit), jnp.asarray(cot), 0.0))[0], _np(g))
    corner = raster_soft.signed_distance_px(_t(clip)[_t(tris).long()], None, _t(tid), width=W, height=H)
    assert torch.equal(corner, got.detach())
