"""PyTorch port vs the JAX package: the geometry layer — ``math3d`` (its
matrix builders and the ``axis`` / ``keepdims`` of ``normalize``, ``dot``
and ``length``), every mesh builder with ``subdivide`` and
``merge_meshes``, ``flatten_scene`` and ``scene_graph.lower`` — from
identical inputs.

Tolerances: math3d within 1e-6 (float32; the port writes the small
contractions as explicit sums, XLA as dots); mesh float fields within 1e-6
(both build in NumPy; the box, the cylinder and the geosphere are the same
float32 and float64 expressions), ``tris`` and the merge's submesh ids
exact; ``flatten_scene`` within 1e-6 + 1e-6·|v| (``tests/test_torch_scene.py``'s:
the port's 3-term sums against XLA's einsum), ``tris`` and
``face_material`` exact; a lowered scene's worlds and lights exact, its
render within 2e-4 of JAX's (the same jnp rasterizer on both sides, ids
equal; the shading's float32 rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import MaterialBuilder as JMaterialBuilder
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import render as jrender
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models import mesh as jmesh
from physically_based_renderer_tpu.models import scene_graph as jgraph
from physically_based_renderer_tpu.models.scene import flatten_scene as jflatten
from physically_based_renderer_tpu.models.scene import translation_world
from physically_based_renderer_tpu_torch import Camera, MaterialBuilder, flatten_scene, math3d, render
from physically_based_renderer_tpu_torch.models import mesh as pmesh
from physically_based_renderer_tpu_torch.models import scene_graph as pgraph
from torch_parity import to_port

ATOL = 1e-6
RENDER_ATOL = 2e-4


def _np(t):
    return t.detach().cpu().numpy()


def _t(x):
    return torch.as_tensor(np.array(x))


def test_math3d_matrix_builders_match():
    rng = np.random.default_rng(0)
    x, y, z = (float(v) for v in rng.uniform(-3, 3, 3))
    a = float(rng.uniform(-np.pi, np.pi))
    pairs = [
        (jmath3d.identity4(), math3d.identity4(device="cpu")),
        (jmath3d.translation(x, y, z), math3d.translation(x, y, z, device="cpu")),
        (jmath3d.scaling(x, y, z), math3d.scaling(x, y, z, device="cpu")),
        (jmath3d.rotation_x(a), math3d.rotation_x(a, device="cpu")),
        (jmath3d.rotation_y(a), math3d.rotation_y(a, device="cpu")),
        (jmath3d.rotation_z(a), math3d.rotation_z(a, device="cpu")),
    ]
    eye, target, up = rng.normal(size=3), rng.normal(size=3), np.array([0.0, 1.0, 0.0])
    pairs.append((jmath3d.look_at_lh(*(jnp.asarray(v, jnp.float32) for v in (eye, target, up))),
                  math3d.look_at_lh(*(torch.tensor(v, dtype=torch.float32) for v in (eye, target, up)))))
    for i, (ref, got) in enumerate(pairs):
        assert got.dtype == torch.float32 and got.shape == (4, 4)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL, rtol=0, err_msg=str(i))


def test_math3d_rotation_is_differentiable():
    angle = torch.tensor(0.3, requires_grad=True)
    m = math3d.rotation_y(angle)
    m[0, 0].backward()
    np.testing.assert_allclose(float(angle.grad), -np.sin(0.3), atol=ATOL)


def test_math3d_transforms_match():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    m = (rng.normal(size=(4, 4)) + 3 * np.eye(4)).astype(np.float32)
    for jfn, pfn in ((jmath3d.transform_points, math3d.transform_points),
                     (jmath3d.transform_vectors, math3d.transform_vectors),
                     (jmath3d.transform_points_h, math3d.transform_points_h)):
        np.testing.assert_allclose(_np(pfn(_t(pts), _t(m))), np.asarray(jfn(jnp.asarray(pts), jnp.asarray(m))),
                                   atol=ATOL, rtol=ATOL)
    r, th, ph = (rng.uniform(0.1, 3, 6).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(_np(math3d.spherical_to_cartesian(_t(r), _t(th), _t(ph))),
                               np.asarray(jmath3d.spherical_to_cartesian(jnp.asarray(r), jnp.asarray(th),
                                                                         jnp.asarray(ph))), atol=ATOL)


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("keepdims", [False, True])
def test_math3d_axis_keepdims_match(axis, keepdims):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 3, 3)).astype(np.float32)
    b = rng.normal(size=(4, 3, 3)).astype(np.float32)
    ja, jb, pa, pb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    for ref, got in (
        (jmath3d.dot(ja, jb, axis=axis, keepdims=keepdims), math3d.dot(pa, pb, axis=axis, keepdims=keepdims)),
        (jmath3d.length(ja, axis=axis, keepdims=keepdims), math3d.length(pa, axis=axis, keepdims=keepdims)),
        (jmath3d.normalize(ja, axis=axis), math3d.normalize(pa, axis=axis)),
    ):
        assert tuple(got.shape) == tuple(ref.shape)
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL, rtol=ATOL)


MESHES = {
    "quad": lambda m: m.quad_mesh(2.0, 1.5),
    "grid": lambda m: m.grid_mesh(3.0, 2.0, 5, 7),
    "box": lambda m: m.box_mesh(1.0, 2.0, 0.5),
    "geosphere": lambda m: m.geosphere_mesh(1.3, 2),
    "cylinder": lambda m: m.cylinder_mesh(0.5, 0.25, 1.5, 12, 3),
    "capsule": lambda m: m.capsule_mesh(0.5, 1.0, 10, 6),
    "subdivide": lambda m: m.subdivide(m.sphere_mesh(1.0, 8, 4)),
}


def _port_mesh(name):
    """The port's builder under the same arguments, on the CPU."""
    if name == "subdivide":
        return pmesh.subdivide(pmesh.sphere_mesh(1.0, 8, 4, device="cpu"))
    call = MESHES[name]

    class OnCPU:
        def __getattr__(self, attr):
            fn = getattr(pmesh, attr)
            return lambda *a, **k: fn(*a, device="cpu", **k)

    return call(OnCPU())


def _assert_mesh_equal(got, ref, name):
    for f in ("positions", "normals", "tangents", "bitangents", "uvs"):
        g, r = _np(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.shape == r.shape and g.dtype == np.float32, (name, f)
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0, err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(_np(got.tris), np.asarray(ref.tris), err_msg=f"{name}.tris")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_builder_matches(name):
    _assert_mesh_equal(_port_mesh(name), MESHES[name](jmesh), name)


def test_merge_meshes_matches():
    jparts = [jmesh.box_mesh(), jmesh.sphere_mesh(1.0, 6, 4), jmesh.quad_mesh()]
    pparts = [pmesh.box_mesh(device="cpu"), pmesh.sphere_mesh(1.0, 6, 4, device="cpu"),
              pmesh.quad_mesh(device="cpu")]
    ref, ref_ids = jmesh.merge_meshes(jparts)
    got, got_ids = pmesh.merge_meshes(pparts)
    _assert_mesh_equal(got, ref, "merged")
    np.testing.assert_array_equal(got_ids, np.asarray(ref_ids))
    assert got_ids.dtype == np.int32 and got.num_triangles == sum(p.num_triangles for p in pparts)


def _textured_scene():
    from test_texture_combined import _textured_scene as ts

    return ts()


@pytest.mark.parametrize("which", ["grid", "textured"])
def test_flatten_scene_matches(which):
    jscene = jscenes.red_sphere_grid_scene(slices=8, stacks=4) if which == "grid" else _textured_scene()
    scene, _ = to_port(jscene, JCamera.create())
    ref, got = jflatten(jscene), flatten_scene(scene)
    for f in ("pos_w", "normal_w", "tangent_w", "bitangent_w", "uv"):
        np.testing.assert_allclose(_np(getattr(got, f)), np.asarray(getattr(ref, f)), atol=ATOL, rtol=ATOL,
                                   err_msg=f)
    np.testing.assert_array_equal(_np(got.tris), np.asarray(ref.tris))
    np.testing.assert_array_equal(_np(got.face_material), np.asarray(ref.face_material))


def _banks():
    out = []
    for mb in (JMaterialBuilder(), MaterialBuilder()):
        mb.add("red", diffuse=(1, 0, 0), roughness=0.5)
        mb.add("green", diffuse=(0, 1, 0), roughness=0.5)
        out.append(mb)
    return out[0].build(), out[1].build(device="cpu")


def _graph(g, m, case):
    """One of tests/test_scene_graph.py's four graphs, built with package
    ``g`` (its scene_graph module) from mesh module ``m``."""
    sphere = (lambda *a: m.sphere_mesh(*a)) if m is jmesh else (lambda *a: m.sphere_mesh(*a, device="cpu"))
    root = g.Node("root")
    if case == "batching":
        mesh = sphere(1.0, 8, 4)
        root = g.Node("root", transform=translation_world(0, 0, 5))
        a = root.add(g.Node("a", transform=translation_world(-2, 0, 0)))
        a.components.append(g.MeshComponent(mesh=mesh, material=0))
        b = root.add(g.Node("b", transform=translation_world(2, 0, 0)))
        b.components.append(g.MeshComponent(mesh=mesh, material=1))
        root.components.append(g.LightComponent(kind="directional", strength=(0.5, 0.5, 0.5)))
    elif case == "inactive":
        mesh = sphere(1.0, 8, 4)
        off = root.add(g.Node("off", active=False))
        off.components.append(g.MeshComponent(mesh=mesh, material=0))
        on = root.add(g.Node("on"))
        on.components.append(g.MeshComponent(mesh=mesh, material=0))
    elif case == "renders":
        n = root.add(g.Node("s"))
        n.components.append(g.MeshComponent(mesh=sphere(1.0, 12, 6), material=0))
        sun = root.add(g.Node("sun"))
        sun.components.append(g.LightComponent(kind="directional", strength=(0.4, 0.4, 0.4)))
    else:  # point and spot lights
        p = root.add(g.Node("p", transform=translation_world(0, 3, 0)))
        p.components.append(g.LightComponent(kind="point", strength=(2, 2, 2)))
        s = root.add(g.Node("s", transform=translation_world(0, 0, -4)))
        s.components.append(g.LightComponent(kind="spot", strength=(1, 1, 1), spot_power=8))
    return root


@pytest.mark.parametrize("case", ["batching", "inactive", "renders", "lights"])
def test_scene_graph_lower_matches(case):
    jbank, pbank = _banks()
    ref = jgraph.lower(_graph(jgraph, jmesh, case), jbank)
    got = pgraph.lower(_graph(pgraph, pmesh, case), pbank)
    assert len(got.draws) == len(ref.draws)
    for gd, rd in zip(got.draws, ref.draws):
        np.testing.assert_array_equal(_np(gd.worlds), np.asarray(rd.worlds))
        np.testing.assert_array_equal(_np(gd.material_ids), np.asarray(rd.material_ids))
        _assert_mesh_equal(gd.mesh, rd.mesh, "draw mesh")
    for f in ("strength", "direction", "position", "spot_power"):
        np.testing.assert_array_equal(_np(getattr(got.lights, f)), np.asarray(getattr(ref.lights, f)), err_msg=f)
    assert (got.lights.num_dir, got.lights.num_point, got.lights.num_spot) == (
        ref.lights.num_dir, ref.lights.num_point, ref.lights.num_spot)
    np.testing.assert_array_equal(_np(got.ambient), np.asarray(ref.ambient))
    if case == "batching":
        assert got.draws[0].num_instances == 2 and got.lights.num_dir == 1
    if case == "inactive":
        assert got.draws[0].num_instances == 1
    if case == "renders":  # the lowered scene renders as JAX's does, through the same jnp rasterizer
        want = np.asarray(jrender(ref, JCamera.create(aspect=1.0), width=64, height=64, raster_backend="jnp"))
        img = render(got, Camera.create(aspect=1.0, device="cpu"), width=64, height=64, raster_backend="jnp")
        np.testing.assert_allclose(_np(img), want, atol=RENDER_ATOL, rtol=0)
        assert (np.abs(_np(img)[..., :3] - 0.5).max(-1) > 1e-6).mean() > 0.05


def test_lower_keeps_the_bank_device_and_face_materials():
    _, bank = _banks()
    mesh = pmesh.box_mesh(device="cpu")
    root = pgraph.Node("root")
    root.components.append(pgraph.MeshComponent(mesh=mesh, face_materials=np.arange(12) % 2))
    root.add(pgraph.Node("b")).components.append(pgraph.MeshComponent(mesh=mesh, material=1))
    scene = pgraph.lower(root, bank, ambient=(0.1, 0.2, 0.3))
    assert len(scene.draws) == 2 and scene.ambient.device == bank.diffuse.device
    flat = flatten_scene(scene)
    np.testing.assert_array_equal(_np(flat.face_material), np.concatenate([np.arange(12) % 2, np.ones(12)]))
    np.testing.assert_allclose(_np(scene.ambient), [0.1, 0.2, 0.3], atol=ATOL)
