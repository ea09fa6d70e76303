"""PyTorch port vs the JAX package: mesh, scene flattening, camera and
triangle setup, from identical NumPy inputs. Tolerance atol 1e-6 plus rtol
1e-6: float32 values up to ~20 in magnitude, where the two packages differ by
summation order and XLA's rsqrt by an ulp or two (2e-6 at 11)."""

import math

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
from physically_based_renderer_tpu.ops.brdf import Lights as JLights
from physically_based_renderer_tpu.ops.raster import setup_corners as jsetup
from physically_based_renderer_tpu_torch import math3d, scenes
from physically_based_renderer_tpu_torch.models.mesh import sphere_mesh
from physically_based_renderer_tpu_torch.models.scene import flatten_scene_corners
from physically_based_renderer_tpu_torch.ops.raster import setup_corners
from torch_parity import random_worlds, to_port

ATOL = 1e-6
RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("slices,stacks", [(8, 4), (64, 32), (13, 7)])
def test_sphere_mesh_matches(slices, stacks):
    a = jsphere_mesh(1.5, slices, stacks)
    b = sphere_mesh(1.5, slices, stacks)
    for f in ("positions", "normals", "tangents", "bitangents", "uvs"):
        np.testing.assert_array_equal(_np(getattr(b, f)), np.asarray(getattr(a, f)), err_msg=f)
    np.testing.assert_array_equal(_np(b.tris), np.asarray(a.tris))


def _random_scene(seed):
    """Two multi-instance draws under random rigid worlds, one with
    per-face materials, plus point and spot lights."""
    rng = np.random.default_rng(seed)
    mb = JMaterialBuilder()
    for i in range(5):
        mb.add(f"m{i}", diffuse=tuple(rng.uniform(0, 1, 3)), roughness=float(rng.uniform()),
               metallic=float(rng.uniform()))
    mesh_a = jsphere_mesh(1.0, 8, 4)
    mesh_b = jsphere_mesh(0.7, 6, 5)
    draws = (
        JDraw.create(mesh_a, random_worlds(rng, 3), [0, 1, 2]),
        JDraw.create(mesh_b, random_worlds(rng, 2), [0, 0],
                     face_materials=rng.integers(0, 5, mesh_b.num_triangles)),
    )
    lights = JLights.build(
        directional=[((0.577, 0.577, 0.577), (0.3, 0.25, 0.2))],
        point=[((1.5, 1.0, -2.0), (2.0, 1.5, 1.0))],
        spot=[((0.0, 2.0, -2.0), (0.0, -0.7, 0.7), (3.0, 3.0, 3.0), 8.0)],
    )
    scene = JScene(draws=draws, materials=mb.build(), atlas=None, lights=lights,
                   ambient=jnp.asarray([0.03, 0.03, 0.03]))
    cam = JCamera.create(position=tuple(rng.uniform(-1, 1, 3) + [0, 0, -12]),
                         yaw=float(rng.uniform(-0.2, 0.2)), pitch=float(rng.uniform(-0.2, 0.2)),
                         aspect=4 / 3)
    return scene, cam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flatten_scene_corners_matches(seed):
    jscene, jcam = _random_scene(seed)
    scene, _ = to_port(jscene, jcam)
    for textured in (False, True):
        a = jflatten(jscene, textured=textured)
        b = flatten_scene_corners(scene, textured=textured)
        np.testing.assert_allclose(_np(b.attrs), np.asarray(a.attrs), atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(_np(b.face_material), np.asarray(a.face_material))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_view_proj_matches(seed):
    rng = np.random.default_rng(seed)
    pos = tuple(rng.uniform(-10, 10, 3))
    yaw, pitch = float(rng.uniform(-math.pi, math.pi)), float(rng.uniform(-1.4, 1.4))
    aspect = float(rng.uniform(0.5, 2.5))
    a = JCamera.create(position=pos, yaw=yaw, pitch=pitch, aspect=aspect)
    _, b = to_port(jscenes.red_sphere_grid_scene(slices=8, stacks=4), a)
    np.testing.assert_allclose(_np(b.view_matrix()), np.asarray(a.view_matrix()), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(b.projection_matrix()), np.asarray(a.projection_matrix()), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(b.view_proj()), np.asarray(a.view_proj()), atol=ATOL, rtol=RTOL)


def test_port_scene_builders_match_conversion():
    """``scenes.red_sphere_grid_scene`` builds the same scene as converting
    the JAX one."""
    jscene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    conv, _ = to_port(jscene, JCamera.create())
    built = scenes.red_sphere_grid_scene(8, 4)
    for k in conv.materials.tensor_fields():
        assert torch.equal(getattr(conv.materials, k), getattr(built.materials, k)), k
    assert torch.equal(conv.draws[0].worlds, built.draws[0].worlds)
    assert torch.equal(conv.draws[0].material_ids, built.draws[0].material_ids)
    assert torch.equal(conv.lights.strength, built.lights.strength)
    assert torch.equal(conv.ambient, built.ambient)
    assert torch.equal(conv.clear_color, built.clear_color)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cull", [True, False])
def test_setup_corners_matches(seed, cull):
    jscene, jcam = _random_scene(seed)
    scene, cam = to_port(jscene, jcam)
    W, H = 96, 72
    g = jflatten(jscene, textured=False)
    jclip = jmath3d.transform_points_h(g.pos_w, jcam.view_proj())
    clip = math3d.transform_points_h(flatten_scene_corners(scene).pos_w, cam.view_proj())
    np.testing.assert_allclose(_np(clip), np.asarray(jclip), atol=1e-5, rtol=1e-6)
    # Setup from identical clip coordinates.
    a = jsetup(jclip, W, H, cull, None)
    b = setup_corners(torch.as_tensor(np.array(jclip)), W, H, cull, None)
    for f in ("xy", "z", "inv_w", "area"):
        np.testing.assert_allclose(_np(getattr(b, f)), np.asarray(getattr(a, f)), atol=ATOL, rtol=RTOL,
                                   err_msg=f)
    np.testing.assert_array_equal(_np(b.valid), np.asarray(a.valid))
    assert _np(b.valid).any()
