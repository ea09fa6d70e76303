"""PyTorch port vs the JAX package: the whole forward render.

``render`` of the port (CPU tensors: the plain raster+shade version) against
JAX ``render(raster_backend="jnp")`` at atol 2e-4, the tolerance
``tests/test_raster_shade.py`` holds the JAX kernels to; band rendering
against the full frame; the import boundary (no JAX); what of the textured
slice still raises; the alpha test. (Textured frames are held against JAX in
``tests/test_torch_textured_render.py``.) (The IBL frame is held against
JAX in ``tests/test_torch_raster_shade_ibl.py``.)
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.material import MaterialBuilder as JMaterialBuilder
from physically_based_renderer_tpu.models.mesh import sphere_mesh as jsphere_mesh
from physically_based_renderer_tpu.models.scene import InstancedDraw as JDraw
from physically_based_renderer_tpu.models.scene import Scene as JScene
from physically_based_renderer_tpu.ops import ibl as jibl
from physically_based_renderer_tpu.ops.brdf import Lights as JLights
from physically_based_renderer_tpu.ops.ibl import IBLMaps as JIBLMaps
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch import MaterialBuilder, render, scenes
from physically_based_renderer_tpu_torch.ops import raster_row
from physically_based_renderer_tpu_torch.ops.texture import build_atlas
from physically_based_renderer_tpu_torch.utils import image_io
from torch_parity import random_worlds, row_args, to_port

ATOL = 2e-4


def _grid(width, height, position=(0.0, -3.0, -18.0)):
    return (jscenes.red_sphere_grid_scene(slices=8, stacks=4),
            JCamera.create(position=position, aspect=width / height))


def _lit_spheres(width, height):
    """Randomly placed spheres with per-face materials under all three light
    kinds (inputs from a fixed NumPy seed)."""
    rng = np.random.default_rng(11)
    mb = JMaterialBuilder()
    for i in range(4):
        mb.add(f"m{i}", diffuse=tuple(rng.uniform(0.1, 1, 3)), roughness=float(rng.uniform(0.2, 1)),
               metallic=float(rng.uniform()))
    mesh = jsphere_mesh(1.0, 12, 6)
    lights = JLights.build(
        directional=[((0.577, 0.577, 0.577), (0.3, 0.25, 0.2))],
        point=[((1.5, 1.0, -2.0), (2.0, 1.5, 1.0))],
        spot=[((0.0, 2.0, -2.0), (0.0, -0.7, 0.7), (3.0, 3.0, 3.0), 8.0)],
    )
    scene = JScene(
        draws=(JDraw.create(mesh, random_worlds(rng, 3, spread=1.5), [0, 1, 2],
                            face_materials=None),
               JDraw.create(mesh, random_worlds(rng, 1, spread=1.0), [0],
                            face_materials=rng.integers(0, 4, mesh.num_triangles))),
        materials=mb.build(), atlas=None, lights=lights, ambient=jnp.asarray([0.03, 0.03, 0.03]),
    )
    return scene, JCamera.create(position=(0.0, 0.0, -7.0), aspect=width / height)


CASES = {
    "grid_128x64": (_grid, 128, 64),
    "grid_96x64": (_grid, 96, 64),
    "lit_spheres_64x64": (_lit_spheres, 64, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax_jnp(case):
    make, width, height = CASES[case]
    jscene, jcam = make(width, height)
    ref = np.asarray(jrender(jscene, jcam, width=width, height=height, raster_backend="jnp"))
    scene, cam = to_port(jscene, jcam)
    img = render(scene, cam, width=width, height=height)
    assert img.shape == (height, width, 4) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, atol=ATOL, rtol=0)
    hit = (img.numpy()[..., :3] != np.asarray(jscene.clear_color)).any(-1)
    assert 0.05 < hit.mean() < 0.95


def test_render_matches_jax_jnp_hdr():
    """``apply_tonemap=False``: HDR values, same coverage; HDR specular peaks
    make float32 noise larger, so the JAX suite's own no-tonemap tolerance
    (atol 1e-2, under 0.1% of values past 1e-3) applies."""
    jscene, jcam = _grid(128, 64)
    ref = np.asarray(jrender(jscene, jcam, width=128, height=64, raster_backend="jnp",
                             apply_tonemap=False))
    scene, cam = to_port(jscene, jcam)
    img = render(scene, cam, width=128, height=64, apply_tonemap=False).numpy()
    np.testing.assert_allclose(img, ref, atol=1e-2)
    assert (np.abs(img - ref) > 1e-3).mean() < 1e-3


@pytest.mark.parametrize("rows,y_offset", [(32, 16), (24, 40), (8, 0)])
def test_band_matches_full_frame(rows, y_offset):
    scene, cam = to_port(*_grid(128, 64))
    full = render(scene, cam, width=128, height=64)
    band = render(scene, cam, width=128, height=64, rows=rows, y_offset=y_offset)
    assert band.shape == (rows, 128, 4)
    torch.testing.assert_close(band, full[y_offset : y_offset + rows], atol=1e-6, rtol=0)


def test_scene_builder_renders_like_converted_scene():
    scene, cam = to_port(*_grid(128, 64))
    built = scenes.red_sphere_grid_scene(8, 4, device="cpu")
    assert torch.equal(render(built, cam, width=128, height=64), render(scene, cam, width=128, height=64))


def test_import_leaves_jax_out(tmp_path):
    """Importing the port, and reading a DDS, a GIF and a TIFF through its
    ``load_image``, loads neither JAX, nor PIL, nor the JAX package."""
    from chip_smoke import write_dds, write_gif, write_tiff

    img = np.arange(6 * 10 * 3, dtype=np.uint8).reshape(6, 10, 3)
    files = [str(tmp_path / n) for n in ("a.dds", "b.gif", "c.tif")]
    write_dds(files[0], img)
    write_gif(files[1], img[..., :1])
    write_tiff(files[2], img, compression=5, predictor=2, tile=(16, 16))
    code = (
        "import sys, physically_based_renderer_tpu_torch as p; "
        "import physically_based_renderer_tpu_torch.utils.convert, "
        "physically_based_renderer_tpu_torch.utils.image_io, "
        "physically_based_renderer_tpu_torch.app, physically_based_renderer_tpu_torch.ops.raster_soft, "
        "physically_based_renderer_tpu_torch.utils.config, physically_based_renderer_tpu_torch.utils.profiling, "
        "physically_based_renderer_tpu_torch.utils.checkpoint, physically_based_renderer_tpu_torch.utils.ssim, "
        "physically_based_renderer_tpu_torch.models.scene_graph, physically_based_renderer_tpu_torch.models.mesh, "
        "physically_based_renderer_tpu_torch.ops.raster, physically_based_renderer_tpu_torch.renderer; "
        f"[p.utils.image_io.load_image(f) for f in {files!r}]; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m); "
        "assert 'PIL' not in sys.modules, sorted(m for m in sys.modules if 'PIL' in m); "
        "ref = [m for m in sys.modules if m.split('.')[0] == 'physically_based_renderer_tpu']; "
        "assert not ref, ref; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("field", ["atlas", "combined_atlas", "env_map", "ibl", "sky_map"])
def test_later_slice_features_raise(field, tmp_path):
    """What of the textured slice once waited for a later PR now runs: a
    texture file or an sIBL set's LDR background decodes (atlas, sky_map;
    a file that is no PNG, JPEG, BMP, DDS, GIF, TIFF, WebP, ICO or TGA raises), the u8 'packed' combined
    pages build and render (combined_atlas). IBL maps without the fused
    path's SH9 coefficients and f16 specular stack (env_map, ibl) render
    through ``ambient_ibl`` on the G-buffer path, as the JAX package's jnp
    backend renders them."""
    jscene, jcam = _grid(64, 32)
    scene, cam = to_port(jscene, jcam)
    img = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    if field == "atlas":
        (tmp_path / "rustediron").mkdir()
        (tmp_path / "rustediron" / "rustediron2_basecolor.png").write_bytes(b"not decoded")
        cache = scenes.AssetCache(asset_root=str(tmp_path))
        assert cache.page("rusted_iron", "metallic") is None  # no file: the slot stays unbound
        with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, DDS, GIF, TIFF, WebP, ICO or TGA file"):
            cache.page("rusted_iron", "diffuse")
        image_io.save_png(str(tmp_path / "rustediron" / "rustediron2_basecolor.png"), img)
        cache = scenes.AssetCache(asset_root=str(tmp_path))
        page = cache.page("rusted_iron", "diffuse")
        assert np.array_equal(cache.pages[page], img) and cache.srgb[page]
        return
    if field == "sky_map":
        (tmp_path / "Chelsea_Stairs").mkdir()
        (tmp_path / "Chelsea_Stairs" / "Chelsea_Stairs.ibl").write_text("[Header]\nName = x\n")
        cache = scenes.AssetCache(asset_root=str(tmp_path))
        assert cache.load_sky_background("chelsea_stairs", device="cpu") is None  # no LDR background
        image_io.save_png(str(tmp_path / "Chelsea_Stairs" / "Chelsea_Stairs_env.png"), img)
        sky = cache.load_sky_background("chelsea_stairs", device="cpu")
        assert sky.dtype == torch.uint8 and np.array_equal(sky.numpy(), img)
        return
    if field == "combined_atlas":
        tex = dataclasses.replace(scene, atlas=build_atlas([np.zeros((4, 4, 3), np.uint8)], [True], device="cpu"))
        packed = tex.with_combined_textures(mode="packed")
        assert type(packed.combined_atlas).__name__ == "PackedCombinedAtlas"
        assert bool(torch.isfinite(render(packed, cam, width=64, height=32)).all())
        return
    env = jnp.full((8, 16, 3), 0.5, jnp.float32)
    maps = JIBLMaps(irradiance=jibl.irradiance_map(env, 4, 8, env_samples=8),
                    specular_levels=jibl.prefilter_specular(env, 4, 8, 2, env_samples=8),
                    lut=jibl.brdf_lut(8, 16))
    jscene = dataclasses.replace(jscene, **{field: env, "ibl": maps})  # field "ibl": the maps
    scene, cam = to_port(jscene, jcam)
    assert getattr(scene, field) is not None and scene.ibl.irradiance_sh9 is None
    ref = np.asarray(jrender(jscene, jcam, width=64, height=32, raster_backend="jnp"))
    np.testing.assert_allclose(render(scene, cam, width=64, height=32).numpy(), ref, atol=ATOL, rtol=0)


def test_alpha_test_peels_to_background():
    """Alpha-tested materials render now (one depth peel): a cutout sphere
    whose opacity is under the 0.1 threshold is killed, and the pixels show
    what lies behind it — here the clear colour (its back faces are culled)."""
    _, cam = to_port(*_grid(64, 32))
    base = scenes.analytic_sphere_scene(slices=8, stacks=4, device="cpu")
    cam = dataclasses.replace(cam, position=torch.tensor([0.0, 0.0, -4.0]))
    img = {}
    for opacity in (0.05, 0.5):
        mb = MaterialBuilder()
        mb.add("cutout", alpha_test=True, opacity=opacity)
        img[opacity] = render(dataclasses.replace(base, materials=mb.build(device="cpu")), cam, width=64, height=32)
    hit = img[0.5][..., 3] < 1.0  # the sphere's own alpha is its opacity
    assert hit.sum() > 100
    torch.testing.assert_close(img[0.05][hit], base.clear_color.new_tensor([0.5, 0.5, 0.5, 1.0]).expand(
        int(hit.sum()), 4), atol=0, rtol=0)


def test_find_asset_root_candidate_order(monkeypatch, tmp_path):
    """``$PBR_ASSETS``, then the reference renderer's mounted tree, then
    ``<repo>/Assets`` — the JAX package's order — and None when none exists."""
    repo_assets = os.path.abspath(os.path.join(os.path.dirname(image_io.__file__), "..", "..", "Assets"))
    env = str(tmp_path / "env_assets")
    monkeypatch.setenv("PBR_ASSETS", env)
    for present, want in (({env, image_io.REFERENCE_ASSETS, repo_assets}, env),
                          ({image_io.REFERENCE_ASSETS, repo_assets}, image_io.REFERENCE_ASSETS),
                          ({repo_assets}, repo_assets), (set(), None)):
        asked = []

        def isdir(path, present=present):
            asked.append(os.path.abspath(path))
            return os.path.abspath(path) in present

        monkeypatch.setattr(image_io.os.path, "isdir", isdir)
        assert image_io.find_asset_root() == want
        assert asked == [env, image_io.REFERENCE_ASSETS, repo_assets][: len(asked)]
    assert len(asked) == 3 and image_io.REFERENCE_ASSETS.split(os.sep)[-2:] == ["reference", "Assets"]


def test_overflow_is_flagged():
    scene, cam = to_port(*_grid(128, 64))
    geom_tris = sum(d.num_instances * d.mesh.num_triangles for d in scene.draws)
    out = raster_row.rasterize_binned_shade_row(
        *row_args(scene, cam), width=128, height=64, tile_h=8, pairs_cap=8,
        num_materials=scene.materials.num_materials, num_dir=4,
    )
    assert bool(out.overflowed) and geom_tris > 8
