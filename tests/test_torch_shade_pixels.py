"""PyTorch port vs the JAX package: the G-buffer path's PS stage —
``fetch_columns`` (``ops/fetch.py``), the BRDF of ``ops/brdf.py``,
``ambient_ibl`` (``ops/ibl.py``) and ``renderer.shade_pixels``.

Same NumPy-seeded inputs on both sides. Tolerances: the fetch forward is
exact, and its gradient the same bits on every run (and within the JAX
suite's gradient tolerance of JAX's one-hot matmul); the BRDF and the shader
within rtol 1e-4 + 1e-6 (the same float32 formulas; XLA fuses some into FMAs)
at roughness ≥ 0.2 — at roughness 0 the JAX package's float32 GGX is noisy
(ROADMAP §C), so there the port is held to its own float64 evaluation;
gradients within ``torch_parity.grad_tolerance``. ``ambient_ibl`` under the
three kinds of IBL maps (SH9 + f16 stack; irradiance map + f32 stack; the
levels alone) within 1e-5 (the f16 taps are the same values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import InstancedDraw as JDraw
from physically_based_renderer_tpu import MaterialBuilder as JMaterialBuilder
from physically_based_renderer_tpu import Scene as JScene
from physically_based_renderer_tpu import sphere_mesh as jsphere_mesh
from physically_based_renderer_tpu import renderer as jrenderer
from physically_based_renderer_tpu.ops import brdf as jbrdf
from physically_based_renderer_tpu.ops import fetch as jfetch
from physically_based_renderer_tpu.ops import ibl as jibl
from physically_based_renderer_tpu.ops.brdf import Lights as JLights
from physically_based_renderer_tpu.ops.texture import build_atlas as jbuild_atlas
from physically_based_renderer_tpu_torch import renderer
from physically_based_renderer_tpu_torch.ops import brdf, fetch, ibl
from physically_based_renderer_tpu_torch.utils.convert import ibl_from_numpy
from torch_parity import grad_tolerance, ibl_to_numpy, seeded_env, to_port
from physically_based_renderer_tpu import Camera as JCamera

RTOL, ATOL = 1e-4, 1e-6
ROWS, W = 12, 24


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def test_fetch_columns_value_gradient_and_bits():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(7, 28)).astype(np.float32)
    mid = rng.integers(-2, 9, size=(40, 64))  # out-of-range ids clamp, as in JAX
    mid[:20] = 0  # a long run of one id, as the background has
    g = rng.normal(size=(40, 64, 28)).astype(np.float32)
    ref = np.asarray(jfetch.fetch_columns(jnp.asarray(table), jnp.asarray(mid)))
    jg = jax.grad(lambda t: jnp.sum(jfetch.fetch_columns(t, jnp.asarray(mid)) * g))(jnp.asarray(table))
    grads = []
    for _ in range(2):
        t = _t(table).requires_grad_()
        out = fetch.fetch_columns(t, _t(mid))
        np.testing.assert_array_equal(out.detach().numpy(), ref)
        (gt,) = torch.autograd.grad(torch.sum(out * _t(g)), t)
        grads.append(gt)
    assert torch.equal(grads[0], grads[1])
    grad_tolerance(np.asarray(jg), grads[0].numpy())


def _brdf_inputs(seed, rough_lo=0.2):
    rng = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    s = (ROWS, W)
    return dict(
        albedo=rng.uniform(0, 1, s + (3,)).astype(np.float32),
        metallic=rng.uniform(0, 1, s).astype(np.float32),
        f0=rng.uniform(0, 0.2, s + (3,)).astype(np.float32),
        roughness=rng.uniform(rough_lo, 1, s).astype(np.float32),
        pos=rng.uniform(-2, 2, s + (3,)).astype(np.float32),
        n=unit(rng.normal(size=s + (3,))),
        v=unit(rng.normal(size=s + (3,)) + np.array([0, 0, -2.0])),
    )


def _lights():
    return dict(directional=[((0.577, -0.577, 0.577), (0.4, 0.3, 0.2))],
                point=[((1.0, 2.0, -3.0), (3.0, 2.0, 1.0))],
                spot=[((0.0, 3.0, -3.0), (0.0, -0.7, 0.7), (4.0, 4.0, 4.0), 6.0)])


@pytest.mark.parametrize("seed", [1, 2])
def test_compute_lighting_matches(seed):
    x = _brdf_inputs(seed)
    jl = JLights.build(**_lights())
    pl = brdf.Lights.build(**_lights(), device="cpu")
    keys = ("albedo", "metallic", "f0", "roughness", "n")

    def jfn(albedo, metallic, f0, roughness, n):
        mat = jbrdf.MaterialSample(albedo, metallic, f0, roughness)
        return jbrdf.compute_lighting(jl, mat, jnp.asarray(x["pos"]), n, jnp.asarray(x["v"]))

    ref = jfn(*(jnp.asarray(x[k]) for k in keys))
    w = np.random.default_rng(seed + 10).normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(5)))(*(jnp.asarray(x[k]) for k in keys))
    leaves = [_t(x[k]).requires_grad_() for k in keys]
    mat = brdf.MaterialSample(*leaves[:4])
    got = brdf.compute_lighting(pl, mat, _t(x["pos"]), leaves[4], _t(x["v"]))
    _close(got.detach().numpy(), ref)
    for r, g in zip(jg, torch.autograd.grad(torch.sum(got * _t(w)), leaves)):
        grad_tolerance(np.asarray(r), g.numpy())


def test_compute_lighting_at_roughness_zero_matches_float64():
    """Roughness 0 (clamped to 0.05): the float32 NDF's 1 − (n·h)² cancels;
    the port's float32 within 2e-4 of its float64 at the shaded values."""
    x = _brdf_inputs(3, rough_lo=0.0)
    x["roughness"][:] = 0.0
    pl = brdf.Lights.build(**_lights(), device="cpu")
    out = {}
    for dt in (torch.float32, torch.float64):
        c = lambda k: _t(x[k]).to(dt)  # noqa: E731
        mat = brdf.MaterialSample(c("albedo"), c("metallic"), c("f0"), c("roughness"))
        lights = dataclasses.replace(pl, **{k: getattr(pl, k).to(dt) for k in ("strength", "direction", "position",
                                                                               "spot_power")})
        out[dt] = brdf.compute_lighting(lights, mat, c("pos"), c("n"), c("v")).double()
    torch.testing.assert_close(out[torch.float32], out[torch.float64], rtol=2e-4, atol=2e-4)


def test_normal_sample_to_world_space_matches():
    rng = np.random.default_rng(4)
    a = [rng.uniform(-1, 1, (50, 3)).astype(np.float32) for _ in range(4)]
    ref = jbrdf.normal_sample_to_world_space(*(jnp.asarray(t) for t in a))
    got = brdf.normal_sample_to_world_space(*(_t(t) for t in a))
    _close(got.numpy(), ref, atol=1e-7)
    assert not np.allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0)  # not renormalised


def _maps(kind):
    maps = jibl.IBLMaps.build(jnp.asarray(seeded_env(21, 16, 32)))
    if kind == "map_f32":
        maps = dataclasses.replace(maps, irradiance_sh9=None, irradiance_f16=None, specular_stack_f16=None)
    elif kind == "levels":
        maps = dataclasses.replace(maps, irradiance_sh9=None, irradiance_f16=None, specular_stack=None,
                                   specular_stack_f16=None)
    return maps, ibl_from_numpy(ibl_to_numpy(maps), device="cpu")


@pytest.mark.parametrize("kind", ["sh9_f16", "map_f32", "levels"])
def test_ambient_ibl_matches(kind):
    x = _brdf_inputs(5)
    jmaps, pmaps = _maps(kind)
    keys = ("n", "v", "albedo", "f0", "metallic", "roughness")
    ref = jibl.ambient_ibl(jmaps, *(jnp.asarray(x[k]) for k in keys))
    leaves = [_t(x[k]).requires_grad_() for k in keys]
    got = ibl.ambient_ibl(pmaps, *leaves)
    _close(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    w = np.random.default_rng(6).normal(size=ref.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jibl.ambient_ibl(jmaps, *a) * w), argnums=(2, 3, 4, 5))(
        *(jnp.asarray(x[k]) for k in keys))
    for r, g in zip(jg, torch.autograd.grad(torch.sum(got * _t(w)), leaves[2:])):
        grad_tolerance(np.asarray(r), g.numpy())


def _displaced_scene():
    """Two spheres: a displacement-mapped one (albedo, normal, height maps)
    and an analytic one, under the default lights (tests/
    test_texture_combined.py's parallax scene, with a normal map)."""
    rng = np.random.default_rng(7)
    pages = [rng.uniform(0, 1, (16, 16, 3)).astype(np.float32) for _ in range(3)]
    atlas = jbuild_atlas(pages, [True, False, False], size=16)
    mb = JMaterialBuilder()
    mb.add("m", textures={"diffuse": 0, "normal": 1, "displacement": 2}, height_scale=0.6,
           uv_transform=[[1.5, 0.1], [0.0, 1.2], [-0.2, 0.05]])
    mb.add("plain", diffuse=(0.2, 0.9, 0.1), roughness=0.3)
    from physically_based_renderer_tpu.models.scene import translation_world

    return JScene(draws=(JDraw.create(jsphere_mesh(1.0, 12, 6), np.stack([translation_world(-1.2, 0, 0),
                                                                        translation_world(1.2, 0, 0)]), [0, 1]),),
                  materials=mb.build(), atlas=atlas, lights=JLights.default_scene_lights(),
                  ambient=jnp.asarray([0.03, 0.03, 0.03]))


def _gbuffer_inputs(seed=8):
    rng = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    s = (ROWS, W)
    yy, xx = np.mgrid[0:ROWS, 0:W].astype(np.float32)
    uv = np.stack([0.03 * xx + 0.2, 0.05 * yy + 0.1], -1) + rng.uniform(-0.01, 0.01, s + (2,))
    return dict(pos_w=rng.uniform(-1, 1, s + (3,)).astype(np.float32),
                normal_w=unit(rng.normal(size=s + (3,)) + np.array([0, 0, -1.5])),
                tangent_w=unit(rng.normal(size=s + (3,))), bitangent_w=unit(rng.normal(size=s + (3,))),
                uv=uv.astype(np.float32), material_id=rng.integers(0, 2, s))


@pytest.mark.parametrize("mip_lod", [False, True])
def test_shade_pixels_parallax_and_uv_clip_match(mip_lod):
    jscene = _displaced_scene()
    scene, cam = to_port(jscene, JCamera.create(position=(0.0, 0.0, -4.0), aspect=1.0))
    g = _gbuffer_inputs()
    common = dict(ambient=None, ibl=None, combined=None, mip_lod=mip_lod)
    ref = jrenderer.shade_pixels(**{k: jnp.asarray(v) for k, v in g.items()}, materials=jscene.materials,
                                 atlas=jscene.atlas, lights=jscene.lights, eye=jnp.asarray([0.0, 0.0, -4.0]),
                                 **{**common, "ambient": jscene.ambient})
    got = renderer.shade_pixels(**{k: _t(v) for k, v in g.items()}, materials=scene.materials, atlas=scene.atlas,
                                lights=scene.lights, eye=cam.position, **{**common, "ambient": scene.ambient})
    hdr, opacity, keep = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(got[2].numpy(), keep)
    assert 0 < keep.mean() < 1  # the uv clip kills some displaced fragments
    _close(got[0].numpy(), hdr, atol=1e-5)
    _close(got[1].numpy(), opacity)


def test_shade_pixels_ibl_split_matches():
    """``ibl_split``: direct + SH9 diffuse, and the env-BRDF factor, reflect
    direction and roughness the merged gather completes."""
    from test_texture_combined import _textured_scene

    jscene = _textured_scene()
    jscene = dataclasses.replace(jscene, env_map=jnp.asarray(seeded_env(22, 16, 32))).with_ibl()
    jscene = jscene.with_combined_textures(mode="quad")
    scene, cam = to_port(jscene, JCamera.create(position=(0.0, 0.0, -4.0), aspect=1.0))
    g = _gbuffer_inputs(9)
    eye = np.array([0.0, 0.0, -4.0], np.float32)
    ref = jrenderer.shade_pixels(**{k: jnp.asarray(v) for k, v in g.items()}, materials=jscene.materials,
                                 atlas=jscene.atlas, lights=jscene.lights, ambient=jscene.ambient,
                                 eye=jnp.asarray(eye), ibl=jscene.ibl, combined=jscene.combined_atlas,
                                 mip_lod=True, ibl_split=True)
    got = renderer.shade_pixels(**{k: _t(v) for k, v in g.items()}, materials=scene.materials, atlas=scene.atlas,
                                lights=scene.lights, ambient=scene.ambient, eye=_t(eye), ibl=scene.ibl,
                                combined=scene.combined_atlas, mip_lod=True, ibl_split=True)
    assert len(got) == len(ref) == 6 and got[2] is None and ref[2] is None
    for name, r, p in zip(("hdr", "opacity", None, "spec_f", "rdir", "roughness"), ref, got):
        if name is not None:
            _close(p.numpy(), r, atol=1e-5)
