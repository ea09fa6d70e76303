"""PyTorch port vs the JAX package: the IBL modules.

From the same seeded NumPy inputs: ``world_to_sky_uv``,
``camera_ray_directions`` and ``sample_sky`` (u8 and f32 skies);
``IBLMaps.build`` field by field, ``sh9_irradiance`` and
``env_brdf_approx``; the env gather (``sample_spec_sky_merged`` +
``specular_levels_lerp``) with its gradients to the specular stack and to
the reflect directions, and the u8 sky that JAX merges into it; ``shade_core(ibl=True)``; ``load_hdr`` and the sIBL
descriptor parser on ``tests/test_sibl.py``'s synthetic files.

Tolerances, each with its reason:
  * uv: 2e-6 (atan2/asin rounding; |values| ≤ 1.2);
  * ray directions: 1e-4 against JAX, 5e-5 against float64: the float32
    inverse of the view-projection (LU, another pivot order) carries ~3e-5,
    and the JAX package's is no closer to float64;
  * sky samples: 1e-6 + rtol 1e-5 (the same texels and weights; f32 lerp
    rounding, and XLA contracts FMAs on the CPU);
  * the BRDF LUT: 1e-4 (256 importance samples through XLA's own sin, cos
    and pow approximations; the fused path reads no LUT);
  * maps: rtol 1e-4 + 1e-5·max (f32 quadrature sums in another order; the
    level-0 mirror weight cancels 1 − n·l near 1e-6);
  * f16 stack copies: one f16 ulp (the f32 stacks differ by the above);
  * env gather: values 1e-5, gradients the JAX suite's ``grad_tolerance``
    (rtol 2e-3 + 5e-5·max);
  * shade_core(ibl=True): the ``ibl=False`` test's HDR tolerance, atol 1e-5
    + rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu.models import sibl as jsibl
from physically_based_renderer_tpu.ops import ibl as jibl
from physically_based_renderer_tpu.ops import shade_core as jsc
from physically_based_renderer_tpu.ops import sky as jsky
from physically_based_renderer_tpu.ops.texture import quad_pack_equirect_u8
from physically_based_renderer_tpu.utils import image_io as jimage_io
from physically_based_renderer_tpu_torch import Camera, math3d
from physically_based_renderer_tpu_torch.models import sibl
from physically_based_renderer_tpu_torch.ops import ibl, shade_core as tsc, sky
from physically_based_renderer_tpu_torch.ops.texture import sample_sky_u8, sky_u8
from physically_based_renderer_tpu_torch.utils import image_io
from physically_based_renderer_tpu_torch.utils.convert import ibl_from_numpy
from test_sibl import SYNTH
from test_torch_shade_core import _inputs
from torch_parity import grad_tolerance, ibl_to_numpy, seeded_env

T = lambda x: torch.as_tensor(np.asarray(x))


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_world_to_sky_uv_matches_jax():
    d = _unit(np.random.default_rng(0), 512)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]
    np.testing.assert_allclose(sky.world_to_sky_uv(T(d)).numpy(),
                               np.asarray(jsky.world_to_sky_uv(jnp.asarray(d))), atol=2e-6)
    back = ibl.sky_uv_to_direction(*sky.world_to_sky_uv(T(d)).unbind(-1))
    ref = jibl.sky_uv_to_direction(*jnp.moveaxis(jsky.world_to_sky_uv(jnp.asarray(d)), -1, 0))
    np.testing.assert_allclose(back.numpy(), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("rows,y_offset", [(64, 0), (24, 20)])
def test_camera_ray_directions_match_jax(rows, y_offset):
    jcam = JCamera.create(position=(0.3, -2.0, -9.0), yaw=0.3, pitch=-0.2, aspect=2.0)
    cam = Camera.create(position=(0.3, -2.0, -9.0), yaw=0.3, pitch=-0.2, aspect=2.0, device="cpu")
    ref = jsky.camera_ray_directions(jmath3d.inverse(jcam.view_proj()), 128, 64, rows, y_offset)
    got = sky.camera_ray_directions(math3d.inverse(cam.view_proj()), 128, 64, rows, y_offset)
    assert got.shape == (rows, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    f64 = sky.camera_ray_directions(torch.linalg.inv(cam.view_proj().double()), 128, 64, rows, y_offset)
    np.testing.assert_allclose(got.numpy(), f64.numpy(), atol=5e-5)


@pytest.mark.parametrize("kind", ["u8_words", "u8_source", "f32"])
def test_sample_sky_matches_jax(kind):
    rng = np.random.default_rng(1)
    src = rng.uniform(-0.1, 1.1, (16, 32, 3)).astype(np.float32)
    d = _unit(rng, 777)
    if kind == "f32":
        ref, port_sky = jsky.sample_sky(jnp.asarray(src * 3), jnp.asarray(d)), T(src * 3)
    else:
        words = quad_pack_equirect_u8(jnp.asarray(src))
        ref = jsky.sample_sky(words, jnp.asarray(d))
        port_sky = sky_u8(np.asarray(words) if kind == "u8_words" else src)
        assert port_sky.dtype == torch.uint8 and port_sky.shape == (16, 32, 3)
    np.testing.assert_allclose(sky.sample_sky(port_sky, T(d)).numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def maps():
    env = seeded_env(3)
    return env, jibl.IBLMaps.build(jnp.asarray(env)), ibl.IBLMaps.build(T(env))


def _maps_close(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_ibl_maps_build_matches_jax(maps):
    _, ref, got = maps
    _maps_close(got.irradiance, ref.irradiance)
    assert len(got.specular_levels) == len(ref.specular_levels) == 5
    for a, b in zip(ref.specular_levels, got.specular_levels):
        assert b.shape == a.shape
        _maps_close(b, a)
    _maps_close(got.specular_stack, ref.specular_stack)
    _maps_close(got.irradiance_sh9, ref.irradiance_sh9)
    np.testing.assert_allclose(got.lut.numpy(), np.asarray(ref.lut), atol=1e-4)
    # the f16 copies hold what the JAX package's quad words hold
    carried = ibl_from_numpy(ibl_to_numpy(ref), device="cpu")
    for name in ("specular_stack_f16", "irradiance_f16"):
        a, b = getattr(carried, name), getattr(got, name)
        assert b.dtype == a.dtype == torch.float16 and b.shape == a.shape
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(), rtol=2 ** -10, atol=1e-7)
    assert float(got.specular_stack.max()) > 5.0  # the sun lobes reach the maps


def test_sh9_irradiance_and_env_brdf_match_jax(maps):
    _, ref, got = maps
    rng = np.random.default_rng(2)
    n = _unit(rng, 300)
    np.testing.assert_allclose(
        ibl.sh9_irradiance(got.irradiance_sh9, T(n)).numpy(),
        np.asarray(jibl.sh9_irradiance(ref.irradiance_sh9, jnp.asarray(n))), rtol=1e-4, atol=1e-5)
    nv = rng.uniform(0, 1, 300).astype(np.float32)
    r = rng.uniform(0, 1, 300).astype(np.float32)
    np.testing.assert_allclose(ibl.env_brdf_approx(T(nv), T(r)).numpy(),
                               np.asarray(jibl.env_brdf_approx(jnp.asarray(nv), jnp.asarray(r))), atol=1e-6)


@pytest.mark.parametrize("with_sky", [True, False])
def test_env_gather_matches_jax(maps, with_sky):
    """Values, and gradients to the specular stack and to r, of
    ``sample_spec_sky_merged`` + ``specular_levels_lerp`` on a 24×40 band
    with a third of it background; roughness hits the lerp's ends 0 and 1."""
    _, jmaps, _ = maps
    pmaps = ibl_from_numpy(ibl_to_numpy(jmaps), device="cpu")
    rng = np.random.default_rng(4 + with_sky)
    shape = (24, 40)
    r = _unit(rng, 24 * 40).reshape(*shape, 3)
    hit = rng.uniform(size=shape) > 0.33
    rough = rng.uniform(0, 1, shape).astype(np.float32)
    rough[0, :8] = 0.0
    rough[1, :8] = 1.0
    w = rng.normal(size=(*shape, 3)).astype(np.float32)
    sky_src = rng.uniform(0, 1, (8, 16, 3)).astype(np.float32)
    sky_uv = rng.uniform(-0.2, 1.2, (*shape, 2)).astype(np.float32)
    words = quad_pack_equirect_u8(jnp.asarray(sky_src)) if with_sky else None

    def jloss(stack, rr, rough_):
        m = dataclasses.replace(jmaps, specular_stack=stack)
        smp, sky_rgb = jibl.sample_spec_sky_merged(
            m, rr, jnp.asarray(hit), words, jnp.asarray(sky_uv) if with_sky else None)
        smp = jnp.where(jnp.asarray(hit)[..., None], smp, 0.0)
        pre = jibl.specular_levels_lerp(smp, rough_, m.num_specular_levels)
        return jnp.sum(pre * w), (pre, sky_rgb)

    (_, (jpre, jsky_rgb)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jmaps.specular_stack, jnp.asarray(r), jnp.asarray(rough))
    stack = pmaps.specular_stack.clone().requires_grad_()
    rr, rough_t = T(r).requires_grad_(), T(rough).requires_grad_()
    pm = dataclasses.replace(pmaps, specular_stack=stack)
    smp = ibl.sample_spec_sky_merged(pm, rr, T(hit))
    pre = ibl.specular_levels_lerp(torch.where(T(hit)[..., None], smp, 0.0), rough_t, 5)
    torch.sum(pre * T(w)).backward()
    np.testing.assert_allclose(pre.detach().numpy(), np.asarray(jpre), atol=1e-5, rtol=1e-6)
    if with_sky:  # the port samples the sky that JAX merges into the gather on its own
        bg = ~hit
        sky_rgb = sample_sky_u8(sky_u8(np.asarray(words)), T(sky_uv))
        np.testing.assert_allclose(sky_rgb.numpy()[bg], np.asarray(jsky_rgb)[bg], atol=1e-6)
    else:
        assert jsky_rgb is None
    grad_tolerance(jg[0], stack.grad.numpy())
    # at background the JAX package's merged gather decodes sky words as f16
    # taps (NaN there); its caller masks them, so compare hit pixels
    grad_tolerance(np.asarray(jg[1])[hit], rr.grad.numpy()[hit])
    assert not rr.grad.numpy()[~hit].any()
    grad_tolerance(jg[2], rough_t.grad.numpy())
    assert float(np.abs(jg[2][:2, :8]).sum()) > 0  # the ties carry a gradient


@pytest.mark.parametrize("counts", [(4, 0, 0), (1, 1, 1), (0, 0, 0)])
def test_shade_core_ibl_matches_jax(counts):
    num_dir, num_point, num_spot = counts
    pos, nrm, props, lights = _inputs(31 + sum(counts), *counts)
    sh9 = np.random.default_rng(8).normal(size=(9, 3)).astype(np.float32)
    uni_j = jsc.pack_shading_uniforms(**{k: jnp.asarray(v) for k, v in lights.items()}, sh9=jnp.asarray(sh9))
    uni_t = tsc.pack_shading_uniforms(**{k: T(v) for k, v in lights.items()}, sh9=T(sh9))
    np.testing.assert_array_equal(uni_t.numpy(), np.asarray(uni_j))
    assert uni_t.shape[1] == tsc.uniform_count(max(sum(counts), 1), True)
    kw = dict(num_dir=num_dir, num_point=num_point, num_spot=num_spot)
    out_j = jsc.shade_core(tuple(jnp.asarray(x) for x in pos), tuple(jnp.asarray(x) for x in nrm),
                           tuple(jnp.asarray(x) for x in props), uni_j, ibl=True, apply_tonemap=False, **kw)
    out_t = tsc.shade_core(tuple(T(x) for x in pos), tuple(T(x) for x in nrm), tuple(T(x) for x in props),
                           uni_t, ibl=True, apply_tonemap=False, **kw)
    assert len(out_t) == len(out_j) == tsc.num_output_channels(True) == 11
    for c, (a, b) in enumerate(zip(out_j, out_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a).reshape(-1), atol=1e-5, rtol=1e-4,
                                   err_msg=f"channel {c}")
    g = tsc.unpack_uniform_grads(uni_t, max(sum(counts), 1), True)
    ref = jsc.unpack_uniform_grads(jnp.asarray(uni_t.numpy()), max(sum(counts), 1), True)
    for a, b in zip(ref, g):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(g[6].numpy(), sh9)


def test_load_hdr_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.uniform(0, 1, (8, 12, 3)) ** 2 * 50.0).astype(np.float32)
    p = str(tmp_path / "x.hdr")
    jimage_io.save_hdr(p, img)
    got = image_io.load_hdr(p)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, jimage_io.load_hdr(p))
    maxc = img.max(axis=-1, keepdims=True)
    assert (np.abs(got - img) <= maxc / 128.0 + 1e-6).all()
    # an adaptive-RLE scanline (what the sIBL *_Env.hdr files hold)
    width = 9
    row = bytes([2, 2, 0, width]) + b"".join(bytes([128 + width, v]) for v in (100, 120, 140, 129))
    (tmp_path / "rle.hdr").write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 1 +X 9\n" + row)
    rle = image_io.load_hdr(str(tmp_path / "rle.hdr"))
    np.testing.assert_array_equal(rle, jimage_io.load_hdr(str(tmp_path / "rle.hdr")))
    np.testing.assert_allclose(rle[0, 0], np.array([100, 120, 140]) * 2.0 ** (129 - 136))


def test_sibl_parser_matches_jax(tmp_path):
    p = tmp_path / "test.ibl"
    p.write_text(SYNTH)
    a, b = jsibl.parse_ibl(str(p)), sibl.parse_ibl(str(p))
    for f in ("name", "background_file", "environment_file", "environment_multiplier",
              "reflection_file", "reflection_multiplier"):
        assert getattr(b, f) == getattr(a, f), f
    assert dataclasses.asdict(b.sun) == dataclasses.asdict(a.sun)
    assert [dataclasses.asdict(x) for x in b.lights] == [dataclasses.asdict(x) for x in a.lights]
    np.testing.assert_allclose(b.sun.direction(), a.sun.direction(), atol=1e-6)
    assert sibl.find_ibl(str(tmp_path)) == str(p)
    lights = sibl.sibl_scene_lights(b, device="cpu")
    ref = jsibl.sibl_scene_lights(a)
    assert lights.num_dir == ref.num_dir == 2
    np.testing.assert_allclose(lights.strength.numpy(), np.asarray(ref.strength), rtol=1e-6)
    np.testing.assert_allclose(lights.direction.numpy(), np.asarray(ref.direction), atol=1e-6)
    # sun direction inverts the sky mapping
    uv = sky.world_to_sky_uv(T(-b.sun.direction())[None]).numpy()[0]
    assert abs(uv[0] % 1.0 - b.sun.u % 1.0) < 1e-3 and abs(uv[1] - b.sun.v) < 1e-3
