"""PyTorch port vs the JAX package: the fused raster+shade step.

The port's plain version (``raster_shade_tiles_plain``, what CPU tensors run)
is held against the JAX row kernel ``rasterize_binned_shade_row`` in Pallas
interpret mode, from identical clip coordinates: triangle and material ids
exactly equal, RGBA and the G-buffer residual within atol 2e-4 (the
tolerance of ``tests/test_raster_shade.py``; float32 shading of a
0.05-roughness highlight). The quantized-depth tie contract of
``tests/test_depth_quantization.py`` is pinned on the port. The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py`` at 1080p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.material import MaterialBuilder as JMaterialBuilder
from physically_based_renderer_tpu.models.mesh import sphere_mesh as jsphere_mesh
from physically_based_renderer_tpu.models.scene import InstancedDraw as JDraw
from physically_based_renderer_tpu.models.scene import Scene as JScene
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster_row as jrow
from physically_based_renderer_tpu.ops.brdf import Lights as JLights
from physically_based_renderer_tpu_torch.ops import raster_row
from physically_based_renderer_tpu_torch.renderer import binning_params

ATOL = 2e-4


def _grid():
    scene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    return scene, JCamera.create(position=(0.0, -3.0, -18.0), aspect=128 / 64), 128, 64


def _lit_sphere():
    mb = JMaterialBuilder()
    mb.add("m", diffuse=(0.8, 0.3, 0.2), roughness=0.4, metallic=0.3)
    mb.add("n", diffuse=(0.2, 0.5, 0.8), roughness=0.7, metallic=0.0)
    lights = JLights.build(
        directional=[((0.577, 0.577, 0.577), (0.3, 0.25, 0.2))],
        point=[((1.5, 1.0, -2.0), (2.0, 1.5, 1.0))],
        spot=[((0.0, 2.0, -2.0), (0.0, -0.7, 0.7), (3.0, 3.0, 3.0), 8.0)],
    )
    mesh = jsphere_mesh(1.0, 12, 6)
    rng = np.random.default_rng(7)
    scene = JScene(
        draws=(JDraw.create(mesh, np.eye(4, dtype=np.float32), [0],
                            face_materials=rng.integers(0, 2, mesh.num_triangles)),),
        materials=mb.build(), atlas=None, lights=lights, ambient=jnp.asarray([0.03, 0.03, 0.03]),
    )
    return scene, JCamera.create(aspect=1.0), 64, 64


def _inputs(scene, cam):
    g = jflatten(scene, textured=False)
    clip = jmath3d.transform_points_h(g.pos_w, cam.view_proj())
    m = scene.materials
    props = jnp.concatenate(
        [m.diffuse, m.metallic[:, None], m.fresnel_r0, m.roughness[:, None], m.opacity[:, None]], -1
    )
    L = scene.lights
    args = (clip, g.attrs, g.face_material, props, L.strength, L.direction, L.position,
            L.spot_power, scene.ambient, cam.position)
    kw = dict(num_materials=m.num_materials, num_dir=L.num_dir, num_point=L.num_point,
              num_spot=L.num_spot)
    return args, kw


# (scene, binning overrides): render()'s row settings, and a narrow span
# limit that puts the larger triangles in the jumbo run every tile reads.
CASES = {
    "grid_render_bins": (_grid, lambda n, w, h: dict(tile_h=8, **binning_params(n, w, h))),
    "lit_sphere_jumbo": (_lit_sphere, lambda n, w, h: dict(tile_h=8, max_span=2)),
}


@pytest.mark.parametrize("want_gbuf", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_row_kernel(case, want_gbuf):
    make, bins = CASES[case]
    scene, cam = make()[:2]
    width, height = make()[2:]
    args, kw = _inputs(scene, cam)
    kw.update(width=width, height=height, want_gbuf=want_gbuf,
              **bins(args[0].shape[0], width, height))
    ref = jrow.rasterize_binned_shade_row(*args, interpret=True, **kw)
    out = raster_row.rasterize_binned_shade_row(*(torch.as_tensor(np.array(a)) for a in args), **kw)
    assert not bool(out.overflowed)
    np.testing.assert_array_equal(out.tri_id.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out.mat_id.numpy(), np.asarray(ref[2]))
    assert (out.tri_id.numpy() >= 0).mean() > 0.05
    np.testing.assert_allclose(out.rgba.numpy(), np.asarray(ref[0]), atol=ATOL, rtol=0)
    if want_gbuf:
        np.testing.assert_allclose(out.gbuf.numpy(), np.asarray(ref[3]), atol=ATOL, rtol=0)
    else:
        assert out.gbuf is None


# --- the quantized depth-test contract (tests/test_depth_quantization.py) ---

W, H = 128, 64
ULP = np.float32(2.0**-24)
Z_NEAR_SUBQ = np.float32(0.5) + 30 * ULP
Z_FAR_SUBQ = np.float32(0.5) + 90 * ULP  # 60 ulp behind: inside one quantum
Z_FAR_SUPER = np.float32(0.5 + 1e-3)  # ~2000 ulp behind


def _two_quads(z_first, z_second):
    """Two full-viewport quads; the first-listed quad is triangles {0, 1}."""

    def quad(z):
        return [[-3.0, -3.0, z, 1.0], [3.0, -3.0, z, 1.0], [3.0, 3.0, z, 1.0], [-3.0, 3.0, z, 1.0]]

    verts = np.asarray(quad(z_first) + quad(z_second), np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]])
    return verts[tris]  # (4, 3, 4) corner-major


def _ids(z_first, z_second, max_span=16):
    vc = torch.as_tensor(_two_quads(z_first, z_second))
    l3 = torch.zeros((1, 3))
    out = raster_row.rasterize_binned_shade_row(
        vc, torch.ones((4, 3, 6)), torch.zeros((4,), dtype=torch.int64), torch.full((1, 9), 0.5),
        l3, l3, l3, torch.zeros((1,)), torch.zeros((3,)), torch.zeros((3,)),
        width=W, height=H, cull_backface=False, num_materials=1, max_span=max_span,
    )
    return out.tri_id.numpy()


@pytest.mark.parametrize("max_span", [16, 1])  # own runs / jumbo run
def test_subquantum_tie_is_first_drawn(max_span):
    ids = _ids(Z_NEAR_SUBQ, Z_FAR_SUBQ, max_span)
    assert set(np.unique(ids)) <= {0, 1}
    # far quad drawn first still wins: 60 ulp is invisible to the quantized test
    ids = _ids(Z_FAR_SUBQ, Z_NEAR_SUBQ, max_span)
    assert set(np.unique(ids)) <= {0, 1}


@pytest.mark.parametrize("max_span", [16, 1])
def test_superquantum_separation_nearer_wins(max_span):
    assert set(np.unique(_ids(Z_NEAR_SUBQ, Z_FAR_SUPER, max_span))) <= {0, 1}
    assert set(np.unique(_ids(Z_FAR_SUPER, Z_NEAR_SUBQ, max_span))) == {2, 3}


def test_material_code_encoding():
    """Stride is the next power of two ≥ M (min 2); encoding turns off when
    T·stride reaches 2³¹."""
    assert raster_row.material_stride(49, 194432) == 64
    assert raster_row.material_stride(1, 10) == 2
    assert raster_row.material_stride(5, 10) == 8
    assert raster_row.material_stride(49, (1 << 31) // 64) == 1
    code = torch.tensor([[-1, 64 * 7 + 3]], dtype=torch.int32)
    tri, mat = raster_row.decode_codes(code, 64, torch.zeros(8, dtype=torch.int64))
    assert tri.tolist() == [[-1, 7]] and mat.tolist() == [[0, 3]]
    fm = torch.tensor([5, 6, 7])
    tri, mat = raster_row.decode_codes(torch.tensor([[-1, 2]], dtype=torch.int32), 1, fm)
    assert tri.tolist() == [[-1, 2]] and mat.tolist() == [[5, 7]]


def test_cpu_tensors_never_reach_the_kernel():
    """CPU tensors take the plain version and count no launch; the kernel
    entry refuses them instead of falling back."""
    before = raster_row.KERNEL_LAUNCHES
    _ids(Z_NEAR_SUBQ, Z_FAR_SUPER)
    assert raster_row.KERNEL_LAUNCHES == before
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="CUDA"):
        raster_row.raster_shade_tiles_cuda(
            torch.zeros(2, dtype=torch.int32), torch.zeros((1, 40)), torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 9)), z, width=8, rows=8, y_offset=0, tile_h=8, tile_w=8, mat_stride=2,
            num_dir=0, num_point=0, num_spot=0, apply_tonemap=True, want_gbuf=False,
        )
