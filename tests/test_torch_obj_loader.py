"""PyTorch port vs the JAX package: the OBJ/MTL loader
(``models/obj_loader.py``), its native parser (``utils/native.py``, built
from ``native/objparse.cpp`` into ``build/native/``) and ``scenes.obj_scene``.

Files: JAX's tiny OBJ (``tests/test_obj_loader.py``) and one written here
that has negative indices, faces with v only, v/vt and v//vn, a 5-gon,
``usemtl`` before ``mtllib``, and a missing MTL file beside a present one.
The JAX side parses with its Python parser. Tolerances: none — parsed
arrays, meshes (normals and tangents generated in NumPy by the same
expressions) and name lists are bit-equal, material kwargs and texture
paths equal.

``obj_scene`` frames (an OBJ sphere in two materials, the textured one with
PNG diffuse, roughness and normal maps written by the port's ``save_png``):
the port's render on the CPU (kernel 4's plain version) against JAX's
``render(raster_backend="pallas_gbuf_interpret")`` under
``tests/test_raster_gbuf.py:43-63``'s pixel-fraction bounds with
``mip_lod`` (under 0.5% of values off by more than 1e-5, median under 1e-6,
0.999-quantile under 1e-2); with the maps stripped (kernel 1's plain
version) against JAX's ``"jnp"`` route within the RGBA tolerance 2e-4.
The mori_knob cases skip while the reference assets are absent, as JAX's do.
"""

import os
import textwrap

import numpy as np
import pytest

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models import obj_loader as jobj
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch import Camera, render, scenes
from physically_based_renderer_tpu_torch.models import obj_loader
from physically_based_renderer_tpu_torch.models.mesh import sphere_mesh
from physically_based_renderer_tpu_torch.renderer import raster_route
from physically_based_renderer_tpu_torch.utils import native
from physically_based_renderer_tpu_torch.utils.image_io import save_png
from test_obj_loader import ASSET_OBJ, _write_tiny_obj

W, H = 96, 64
RGBA_ATOL = 2e-4
ARRAYS = ("positions", "normals", "uvs", "tris", "face_material")
MESH_ARRAYS = ("positions", "normals", "tangents", "bitangents", "uvs", "tris")


def _write_edge_obj(tmp_path):
    """An OBJ with every corner form, negative indices, a 5-gon, a usemtl
    before any mtllib and a missing MTL beside a present one."""
    obj = textwrap.dedent(
        """
        # corner forms, negative indices, a 5-gon
        usemtl early
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0.5 1.5 0.25
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        vt 0.5 0.75
        vn 0 0 -1
        vn 0 0.6 -0.8
        f 1 2 3
        mtllib missing.mtl
        mtllib edge.mtl
        f 1/1 2/2 3/3 4/4 5/5
        usemtl shiny
        f -5//-2 -4//-2 -3//-1
        f -1/-1/-1 -2/-2/-2 -3/-3/-2
        usemtl early
        f 1/1/1 2/2/1 3/3/2
        """
    )
    mtl = textwrap.dedent(
        """
        # early has no entry: defaults
        newmtl shiny
        Kd 0.8 0.7 0.1
        Ks 0.9 0.9 0.9
        Ns 512
        Pr 0.35
        Pm 1
        Ke 0.5 0 0
        d 0.5
        map_Kd tex/albedo.png
        map_bump tex/normal.png
        """
    )
    op = tmp_path / "edge.obj"
    op.write_text(obj)
    (tmp_path / "edge.mtl").write_text(mtl)
    return str(op)


FILES = {"tiny": _write_tiny_obj, "edge": _write_edge_obj}


@pytest.mark.parametrize("parser", ["python", "native"])
@pytest.mark.parametrize("name", list(FILES))
def test_parsers_match_jax(tmp_path, name, parser):
    path = FILES[name](tmp_path)
    ref = jobj.parse_obj_python(path)
    got = getattr(obj_loader, f"parse_obj_{parser}")(path)
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (got.material_names, got.mtllibs, got.has_normals, got.has_uvs) == \
        (ref.material_names, ref.mtllibs, ref.has_normals, ref.has_uvs)


def test_edge_obj_semantics(tmp_path):
    d = obj_loader.parse_obj_native(_write_edge_obj(tmp_path))
    assert d.material_names == ["early", "shiny"] and d.mtllibs == ["missing.mtl", "edge.mtl"]
    # 1 + 3 (the 5-gon's fan) + 1 + 1 + 1 triangles; the first face has no uv or normal
    assert d.tris.shape == (7, 3) and np.array_equal(d.face_material, [0, 0, 0, 0, 1, 1, 0])
    assert np.array_equal(d.tris[1:4, 0], [d.tris[1, 0]] * 3)  # fan around the first corner
    np.testing.assert_array_equal(d.uvs[d.tris[1, 2]], [1.0, 0.0])  # vt 3 = (1, 1), v flipped
    assert d.has_normals and d.has_uvs


@pytest.mark.parametrize("name", list(FILES))
def test_load_obj_matches_jax(tmp_path, name):
    path = FILES[name](tmp_path)
    ref = jobj.load_obj(path, prefer_native=False)
    got = obj_loader.load_obj(path, device="cpu")
    for f in MESH_ARRAYS:
        a, b = getattr(got.mesh, f).numpy(), np.asarray(getattr(ref.mesh, f))
        assert np.array_equal(a, b.astype(a.dtype)), f
    assert np.array_equal(got.face_material, ref.face_material)
    assert got.material_names == ref.material_names
    assert got.material_kwargs == ref.material_kwargs
    assert got.material_textures == ref.material_textures


def test_mtl_mapping(tmp_path):
    loaded = obj_loader.load_obj(_write_tiny_obj(tmp_path), prefer_native=False, device="cpu")
    kw = loaded.material_kwargs[0]
    assert kw["diffuse"] == (1.0, 0.0, 0.0)
    assert kw["fresnel_r0"] == (0.5, 0.5, 0.5)
    assert kw["opacity"] == 0.75
    np.testing.assert_allclose(kw["roughness"], 1.0 - 64.0 / 256.0)  # PBRApp.cpp:1524
    assert loaded.material_kwargs[1]["emissive"] == (0.1, 0.2, 0.3)
    edge = obj_loader.load_obj(_write_edge_obj(tmp_path), device="cpu")
    assert edge.material_kwargs[0] == {}  # early: in no MTL that exists
    assert edge.material_kwargs[1]["roughness"] == 0.35  # Pr wins over Ns
    assert edge.material_kwargs[1]["metallic"] == 1.0
    assert edge.material_names == ["edge::early", "edge::shiny"]
    assert edge.material_textures[1] == {"diffuse": str(tmp_path / "tex" / "albedo.png"),
                                         "normal": str(tmp_path / "tex" / "normal.png")}


def test_tangents_orthogonal(tmp_path):
    loaded = obj_loader.load_obj(_write_tiny_obj(tmp_path), device="cpu")
    t, n = loaded.mesh.tangents.numpy(), loaded.mesh.normals.numpy()
    assert np.abs(np.sum(t * n, axis=1)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)


def test_native_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = native.build_library("objparse.cpp")
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.isfile(path)
    assert path == native.library_path("objparse.cpp")
    (tmp_path / "broken.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building broken.cpp"):
        native.build_library("broken.cpp")
    assert not os.listdir(tmp_path / "out") or all(f == ".lock" for f in os.listdir(tmp_path / "out"))


# -- obj_scene ---------------------------------------------------------------------------


def _seeded_map(rng, size, kind):
    yy, xx = (np.mgrid[0:size, 0:size] + 0.5) / size
    f = np.stack([np.sin(2 * np.pi * (k * xx + (k + 1) * yy) + rng.uniform(0, 6)) for k in (1, 2, 3)], -1)
    if kind == "normal":
        v = np.concatenate([0.3 * f[..., :2], np.ones_like(f[..., :1])], -1)
        img = 0.5 + 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
    else:
        img = 0.5 + 0.4 * f
    return np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_sphere_obj(tmp_path, textured=True, slices=16, stacks=8, tex=32, seed=3):
    """A sphere as OBJ text (v/vt/vn, quads where the bands allow) in two
    materials — the upper half textured through PNG maps — and its MTL."""
    m = sphere_mesh(1.0, slices, stacks, device="cpu")
    pos, nrm, uv, tris = (m.positions.numpy(), m.normals.numpy(), m.uvs.numpy(), m.tris.numpy())
    lines = ["mtllib sphere.mtl"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in pos]
    lines += [f"vt {u:.9g} {1.0 - v:.9g}" for u, v in uv]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nrm]
    upper = pos[tris].mean(1)[:, 1] > 0
    for name, sel in (("painted", upper), ("plain", ~upper)):
        lines.append(f"usemtl {name}")
        lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in t) for t in tris[sel]]
    (tmp_path / "sphere.obj").write_text("\n".join(lines) + "\n")
    rng = np.random.default_rng(seed)
    maps = ""
    if textured:
        (tmp_path / "maps").mkdir(exist_ok=True)
        for key, kind in (("map_Kd", "albedo"), ("map_Pr", "rough"), ("map_bump", "normal")):
            save_png(str(tmp_path / "maps" / f"{kind}.png"), _seeded_map(rng, tex, kind))
            maps += f"{key} maps/{kind}.png\n"
    (tmp_path / "sphere.mtl").write_text(
        "newmtl painted\nKd 1 1 1\nNs 128\nPm 0.25\n" + maps + "newmtl plain\nKd 0.2 0.6 0.9\nKs 0.1 0.1 0.1\nNs 32\n")
    return str(tmp_path / "sphere.obj")


@pytest.mark.parametrize("textured", [True, False])
def test_obj_scene_renders_like_jax(tmp_path, textured):
    path = write_sphere_obj(tmp_path, textured=textured)
    jscene = jscenes.obj_scene(path, assets=jscenes.AssetCache(asset_root=str(tmp_path), texture_size=32),
                               texture_size=32, prefer_native=False)
    scene = scenes.obj_scene(path, assets=scenes.AssetCache(asset_root=str(tmp_path), texture_size=32),
                             texture_size=32, device="cpu")
    assert (scene.atlas is not None) == textured and scene.materials.num_materials == 2
    if textured:
        np.testing.assert_array_equal(scene.atlas.mips[0].numpy(), np.asarray(jscene.atlas.mips[0]))
    for f in ("diffuse", "roughness", "metallic", "fresnel_r0", "has_tex", "tex_index"):
        np.testing.assert_array_equal(getattr(scene.materials, f).numpy(),
                                      np.asarray(getattr(jscene.materials, f)), err_msg=f)
    kw = dict(position=(0.4, 0.9, -3.2), pitch=-0.25, aspect=W / H)
    jcam, cam = JCamera.create(**kw), Camera.create(**kw, device="cpu")
    # kernel 4 for the textured OBJ, kernel 1 without maps (their plain versions on CPU tensors)
    assert raster_route("auto", scene, "cpu") == ("pallas_gbuf" if textured else "pallas_shade_row")
    got = render(scene, cam, width=W, height=H).numpy()
    ref = np.asarray(jrender(jscene, jcam, width=W, height=H,
                             raster_backend="pallas_gbuf_interpret" if textured else "jnp"))
    covered = (np.abs(got[..., :3] - 0.5).max(-1) > 1e-6).mean()
    assert covered > 0.2, covered
    d = np.abs(got - ref)
    if textured:
        assert (d > 1e-5).mean() < 5e-3, f"{(d > 1e-5).mean():.5%} values off"
        assert np.median(d) < 1e-6 and np.quantile(d, 0.999) < 1e-2
    else:
        assert d.max() <= RGBA_ATOL, d.max()


# -- mori_knob (skips without the reference assets, as the JAX tests do) -----------------


@pytest.mark.skipif(not os.path.exists(ASSET_OBJ), reason="reference assets absent")
def test_mori_knob_stats():
    for native_parser in (True, False):
        loaded = obj_loader.load_obj(ASSET_OBJ, prefer_native=native_parser, device="cpu")
        assert loaded.mesh.num_triangles == 11970 and len(loaded.material_names) == 5
        assert 6091 <= loaded.mesh.num_vertices <= 7000, loaded.mesh.num_vertices
        np.testing.assert_allclose(np.linalg.norm(loaded.mesh.normals.numpy(), axis=1), 1.0, atol=1e-3)


@pytest.mark.skipif(not os.path.exists(ASSET_OBJ), reason="reference assets absent")
def test_mori_knob_native_python_parity():
    a, b = obj_loader.parse_obj_native(ASSET_OBJ), jobj.parse_obj_python(ASSET_OBJ)
    for f in ARRAYS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.skipif(not os.path.exists(ASSET_OBJ), reason="reference assets absent")
def test_mori_knob_renders():
    scene = scenes.mori_knob_scene(texture_size=64, device="cpu")
    cam = Camera.create(position=(0.0, 0.8, -3.0), pitch=-0.2, aspect=4 / 3, device="cpu")
    a = render(scene, cam, width=160, height=120).numpy()
    assert np.isfinite(a).all()
    assert (np.abs(a[..., :3] - 0.5).max(-1) > 1e-6).mean() > 0.1
