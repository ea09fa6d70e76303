"""PyTorch port vs the JAX package: the fused IBL path.

From the same seeded NumPy inputs:
  * the plain version of the forward kernel's IBL mode (what CPU tensors run
    in place of ``csrc/raster_shade_row.cu``'s IBL instantiation) against JAX
    ``rasterize_binned_shade_row(..., sh9, interpret=True)``: ids exactly
    equal, the 11 HDR channels and the G-buffer within atol 2e-4 + rtol 1e-4
    (float32 shading of HDR values up to ~10);
  * the plain version of the adjoint's IBL mode against JAX
    ``shade_backward(..., ibl=True, interpret=True)``, the 27 SH9 slots of
    g_uni included: the JAX suite's gradient tolerance (``grad_tolerance``:
    rtol 2e-3 + 5e-5·max);
  * the whole IBL frame through ``render`` against JAX ``render`` on its
    fused IBL backend, with the LDR sky, the HDR env as sky, and no sky:
    atol 5e-4, ``tests/test_raster_shade_ibl.py``'s image tolerance;
  * its gradients, with that file's tolerances: materials and light strength
    rtol 2e-3 + 5e-5·max; the env-map gradients — the specular stack, SH9,
    and the environment map through ``IBLMaps.build`` — rtol 2e-3 +
    1e-4·max (a stack texel sums the tap cotangents of many pixels, which
    cancel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.ops import ibl as jibl
from physically_based_renderer_tpu.ops import raster_pallas as jrp
from physically_based_renderer_tpu.ops import raster_row as jrow
from physically_based_renderer_tpu.ops import shade_core as jsc
from physically_based_renderer_tpu.ops.texture import quad_pack_equirect_u8
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch import render
from physically_based_renderer_tpu_torch.ops import ibl, raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops import shade_core as tsc
from test_torch_backward import _port_inputs
from test_torch_raster_row import _inputs, _lit_sphere
from torch_parity import grad_tolerance, random_gbuffer, seeded_env, to_port

W, H = 128, 64
ATOL, RTOL = 2e-4, 1e-4
JAX_IBL = "pallas_shade_ibl_interpret"


def _with_ibl(jscene, sky: str, seed: int = 3):
    """The scene under a seeded HDR env (IBL maps built by the JAX package)
    with ``sky``: "u8" a seeded LDR background (quad words), "env" the env
    itself, "none" the clear colour."""
    env = jnp.asarray(seeded_env(seed))
    s = dataclasses.replace(jscene, env_map=env).with_ibl()
    if sky == "u8":
        bg = np.random.default_rng(seed).uniform(0, 1, (24, 48, 3)).astype(np.float32)
        s = dataclasses.replace(s, sky_map=quad_pack_equirect_u8(jnp.asarray(bg)))
    elif sky == "none":
        s = dataclasses.replace(s, env_map=None)
    return s


def _sphere():
    scene = jscenes.analytic_sphere_scene(roughness=0.35, metallic=0.4, slices=32, stacks=16)
    return scene, JCamera.create(position=(0.0, 0.0, -3.0), aspect=W / H)


def _grid():
    return (jscenes.red_sphere_grid_scene(slices=8, stacks=4),
            JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H))


SCENES = {"sphere": _sphere, "grid": _grid}


@pytest.mark.parametrize("want_gbuf", [False, True])
@pytest.mark.parametrize("case", ["sphere", "lit_sphere_jumbo"])
def test_plain_ibl_mode_matches_jax_row_kernel(case, want_gbuf):
    if case == "sphere":
        jscene, jcam = _sphere()
        width, height, bins = W, H, dict(tile_h=8)
    else:
        jscene, jcam, width, height = _lit_sphere()
        bins = dict(tile_h=8, max_span=2)
    jscene = _with_ibl(jscene, "none")
    args, kw = _inputs(jscene, jcam)
    kw.update(width=width, height=height, want_gbuf=want_gbuf, **bins)
    sh9 = jscene.ibl.irradiance_sh9
    ref = jrow.rasterize_binned_shade_row(*args, sh9, interpret=True, **kw)
    t = lambda a: torch.as_tensor(np.array(a))
    before = raster_row.IBL_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES
    out = raster_row.rasterize_binned_shade_row(*(t(a) for a in args), t(sh9), **kw)
    assert (raster_row.IBL_KERNEL_LAUNCHES, raster_row.KERNEL_LAUNCHES) == before
    assert not bool(out.overflowed)
    np.testing.assert_array_equal(out.tri_id.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out.mat_id.numpy(), np.asarray(ref[2]))
    hit = out.tri_id.numpy() >= 0
    assert 0.05 < hit.mean() < 0.95
    assert out.rgba.shape == (height, width, 11)
    np.testing.assert_allclose(out.rgba.numpy(), np.asarray(ref[0]), atol=ATOL, rtol=RTOL)
    assert not out.rgba.numpy()[~hit].any()
    if want_gbuf:
        np.testing.assert_allclose(out.gbuf.numpy(), np.asarray(ref[3]), atol=ATOL, rtol=0)


def test_plain_ibl_adjoint_matches_jax_kernel():
    gb = random_gbuffer(13)
    rng = np.random.default_rng(14)
    g_chan = rng.normal(size=(*gb["mat_id"].shape, 11)).astype(np.float32)
    sh9 = (rng.normal(size=(9, 3)) * 0.5 + np.eye(9, 3)[0]).astype(np.float32)
    kw = dict(gb["counts"], apply_tonemap=False)
    uni_j = jsc.pack_shading_uniforms(**{k: jnp.asarray(v) for k, v in gb["lights"].items()},
                                      sh9=jnp.asarray(sh9))
    ref = jrp.shade_backward(jnp.asarray(g_chan), jnp.asarray(gb["attrs"]), jnp.asarray(gb["mat_id"]),
                             jnp.asarray(gb["hit"]), jnp.asarray(gb["mat_props"]), uni_j, ibl=True,
                             interpret=True, **kw)
    args = list(_port_inputs(gb))
    args[0] = torch.as_tensor(g_chan)
    args[5] = tsc.pack_shading_uniforms(**{k: torch.as_tensor(v) for k, v in gb["lights"].items()},
                                        sh9=torch.as_tensor(sh9))
    got = raster_pallas.shade_backward(*args, ibl=True, **kw)
    for name, a, b in zip(("g_attrs", "g_props", "g_uni"), ref, got):
        assert b.shape == a.shape, name
        grad_tolerance(np.asarray(a), b.numpy())
    g_sh9 = tsc.unpack_uniform_grads(got[2], 4, True)[6]
    assert g_sh9.shape == (9, 3) and (g_sh9.abs() > 0).all()
    assert not got[2][0, 3:6].any()  # the IBL mode reads no ambient
    ref_table = jrp._scatter_props_by_id(
        jnp.where(jnp.asarray(gb["hit"])[..., None], ref[1], 0.0), jnp.asarray(gb["mat_id"]), 5, 9)
    grad_tolerance(np.asarray(ref_table), got[3].numpy())


@pytest.mark.parametrize("sky", ["u8", "env", "none"])
@pytest.mark.parametrize("case", sorted(SCENES))
def test_ibl_frame_matches_jax(case, sky):
    jscene, jcam = SCENES[case]()
    jscene = _with_ibl(jscene, sky)
    ref = np.asarray(jrender(jscene, jcam, width=W, height=H, raster_backend=JAX_IBL))
    scene, cam = to_port(jscene, jcam)
    img = render(scene, cam, width=W, height=H)
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    np.testing.assert_allclose(img.numpy(), ref, atol=5e-4, rtol=0)


@pytest.mark.parametrize("case", sorted(SCENES))
def test_ibl_frame_gradients_match_jax(case):
    jscene, jcam = SCENES[case]()
    jscene = _with_ibl(jscene, "u8")

    def jloss(mats, maps, strength):
        s = dataclasses.replace(jscene, materials=mats, ibl=maps,
                                lights=dataclasses.replace(jscene.lights, strength=strength))
        return jnp.mean(jrender(s, jcam, width=W, height=H, raster_backend=JAX_IBL)[..., :3] ** 2)

    gj = jax.grad(jloss, argnums=(0, 1, 2), allow_int=True)(jscene.materials, jscene.ibl,
                                                           jscene.lights.strength)
    scene, cam = to_port(jscene, jcam)
    mats = {k: getattr(scene.materials, k).clone().requires_grad_()
            for k in ("diffuse", "roughness", "metallic", "fresnel_r0")}
    stack = scene.ibl.specular_stack.clone().requires_grad_()
    sh9 = scene.ibl.irradiance_sh9.clone().requires_grad_()
    strength = scene.lights.strength.clone().requires_grad_()
    s = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mats),
        ibl=dataclasses.replace(scene.ibl, specular_stack=stack, irradiance_sh9=sh9),
        lights=dataclasses.replace(scene.lights, strength=strength),
    )
    before = raster_row.IBL_KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_IBL_LAUNCHES
    torch.mean(render(s, cam, width=W, height=H)[..., :3] ** 2).backward()
    assert (raster_row.IBL_KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_IBL_LAUNCHES) == before
    for k, t in mats.items():
        assert bool(torch.isfinite(t.grad).all()), k
        grad_tolerance(getattr(gj[0], k), t.grad.numpy())
    grad_tolerance(gj[1].specular_stack, stack.grad.numpy(), atol_frac=1e-4)
    grad_tolerance(gj[1].irradiance_sh9, sh9.grad.numpy(), atol_frac=1e-4)
    grad_tolerance(gj[2], strength.grad.numpy())
    assert float(stack.grad.abs().sum()) > 0 and float(sh9.grad.abs().sum()) > 0


def test_env_map_gradient_matches_jax():
    """d loss / d env_map through the map build and the frame."""
    jscene, jcam = _sphere()
    jscene = _with_ibl(jscene, "u8")
    env0 = seeded_env(3)

    def jloss(env):
        s = dataclasses.replace(jscene, env_map=env, ibl=jibl.IBLMaps.build(env))
        return jnp.mean(jrender(s, jcam, width=W, height=H, raster_backend=JAX_IBL)[..., :3] ** 2)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(env0)))
    scene, cam = to_port(jscene, jcam)
    env = torch.as_tensor(env0).requires_grad_()
    s = dataclasses.replace(scene, env_map=env).with_ibl()
    torch.mean(render(s, cam, width=W, height=H)[..., :3] ** 2).backward()
    assert bool(torch.isfinite(env.grad).all()) and float(env.grad.abs().sum()) > 0
    grad_tolerance(gj, env.grad.numpy(), atol_frac=1e-4)
