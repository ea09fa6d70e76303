"""PyTorch port vs the JAX package: ``render(raster_backend=)``, route by
route.

Every route of the port against the JAX backend of the same name on the
same scene, images and material gradients. The JAX package runs its kernels
on the CPU in interpret mode (``*_interpret``) and has no CPU form of its
row kernels, so ``pallas_shade_row`` and ``pallas_gbuf_row`` are held
against the JAX route that computes the same function at another binning
(``jnp``, ``pallas_gbuf_interpret``): ids may differ only at a depth tie.

Tolerances: untextured images within 2e-4 (``tests/test_torch_render.py``'s:
the float32 shading of the two packages; the fused routes' GGX form is the
port's ``|n×h|²``), outside pixels whose triangle id differs at a depth tie
(at most 0.2% of them); material gradients under
``torch_parity.grad_tolerance``; the textured frame under
``tests/test_raster_gbuf.py:43-63``'s pixel-fraction bounds (a bilinear tap
on a texel boundary moves with the uvs' ulps), never an elementwise
``allclose``. Then the JAX call forms of ``tests/test_raster_gbuf.py`` and
``tests/test_overflow.py`` run on the port, unknown and mismatched routes
raise, ``*_interpret`` names raise on CUDA tensors, every kernel route
raises on a binning overflow, and ``RenderConfig.raster_backend`` reaches
``render``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch import render, scenes
from physically_based_renderer_tpu_torch.app import RenderLoop
from physically_based_renderer_tpu_torch.renderer import raster_route
from physically_based_renderer_tpu_torch.utils.config import RenderConfig
from torch_parity import grad_tolerance, seeded_env, to_port

W, H = 64, 48
ATOL = 2e-4
TIE_SHARE = 2e-3

# port route → the JAX backend it is held against on the CPU
JAX_BACKEND = {
    "pallas_shade_row": "jnp",
    "pallas_shade": "pallas_shade_interpret",
    "pallas_gbuf": "pallas_gbuf_interpret",
    "pallas_gbuf_row": "pallas_gbuf_interpret",
    "pallas": "pallas_interpret",
    "jnp": "jnp",
    "brute": "brute",
}
FIELDS = ("diffuse", "roughness", "metallic")


def _grid():
    return jscenes.red_sphere_grid_scene(slices=8, stacks=4), JCamera.create(position=(0.0, -3.0, -18.0),
                                                                             aspect=W / H)


def _assert_image_close(got, ref):
    bad = np.abs(got - ref).max(-1) > ATOL
    assert bad.mean() <= TIE_SHARE, f"{bad.mean():.4%} of pixels off by more than {ATOL}"


def _jax_grads(jscene, jcam, backend):
    def loss(fields):
        mats = dataclasses.replace(jscene.materials, **fields)
        img = jrender(dataclasses.replace(jscene, materials=mats), jcam, width=W, height=H, raster_backend=backend)
        return jnp.mean(img[..., :3] ** 2)

    g = jax.grad(loss)({k: getattr(jscene.materials, k) for k in FIELDS})
    return {k: np.asarray(v) for k, v in g.items()}


def _port_grads(scene, cam, route):
    leaves = {k: getattr(scene.materials, k).clone().requires_grad_() for k in FIELDS}
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves))
    img = render(s, cam, width=W, height=H, raster_backend=route)
    grads = torch.autograd.grad(torch.mean(img[..., :3] ** 2), list(leaves.values()))
    return img.detach().numpy(), dict(zip(FIELDS, (g.numpy() for g in grads)))


@pytest.mark.parametrize("route", sorted(JAX_BACKEND))
def test_route_matches_jax(route):
    jscene, jcam = _grid()
    scene, cam = to_port(jscene, jcam)
    ref = np.asarray(jrender(jscene, jcam, width=W, height=H, raster_backend=JAX_BACKEND[route]))
    img, grads = _port_grads(scene, cam, route)
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    _assert_image_close(img, ref)
    ref_g = _jax_grads(jscene, jcam, JAX_BACKEND[route])
    for k in FIELDS:
        grad_tolerance(ref_g[k], grads[k])
    # a *_interpret name is its route on CPU tensors
    if route in ("pallas", "pallas_gbuf", "pallas_shade"):
        same = render(scene, cam, width=W, height=H, raster_backend=route + "_interpret")
        assert torch.equal(same, torch.as_tensor(img))


@pytest.mark.parametrize("route", ["pallas_shade_ibl", "pallas_shade_ibl_row"])
def test_ibl_routes_match_jax(route):
    jscene, jcam = _grid()
    jscene = dataclasses.replace(jscene, env_map=jnp.asarray(seeded_env(3))).with_ibl()
    scene, cam = to_port(jscene, jcam)
    ref = np.asarray(jrender(jscene, jcam, width=W, height=H, raster_backend="pallas_shade_ibl_interpret"))
    img = render(scene, cam, width=W, height=H, raster_backend=route).numpy()
    bad = np.abs(img - ref).max(-1) > 5e-4  # tests/test_raster_shade_ibl.py's IBL image tolerance
    assert bad.mean() <= TIE_SHARE, f"{bad.mean():.4%}"
    with pytest.raises(ValueError):  # a fused shade route refuses an IBL scene
        render(scene, cam, width=W, height=H, raster_backend="pallas_shade")


def _textured_scene():
    from test_texture_combined import _textured_scene as ts

    return ts()


@pytest.mark.parametrize("route", ["pallas_gbuf_row", "jnp"])
def test_textured_route_matches_jax(route):
    jscene, jcam = _textured_scene(), JCamera.create(aspect=W / H)
    scene, cam = to_port(jscene, jcam)
    ref = np.asarray(jrender(jscene, jcam, width=W, height=H, mip_lod=False,
                             raster_backend="jnp" if route == "jnp" else "pallas_gbuf_interpret"))
    got = render(scene, cam, width=W, height=H, mip_lod=False, raster_backend=route).numpy()
    d = np.abs(got - ref)  # tests/test_raster_gbuf.py:43-63's bounds
    assert (d > 1e-5).mean() < 1e-3, f"{(d > 1e-5).mean():.5%} values off"
    assert d.max() < 1e-2 and np.median(d) < 1e-6
    with pytest.raises(ValueError):  # the fused routes shade untextured scenes only
        render(scene, cam, width=W, height=H, raster_backend="pallas_shade_row")


def test_jax_call_forms_run_on_the_port():
    """tests/test_raster_gbuf.py:27 and tests/test_overflow.py:42, as written
    for the JAX package, on the port."""
    scene = scenes.analytic_sphere_scene(slices=16, stacks=8, device="cpu")
    from physically_based_renderer_tpu_torch import Camera

    cam = Camera.create(aspect=128 / 96, device="cpu")
    a = render(scene, cam, width=128, height=96, raster_backend="jnp")
    b = render(scene, cam, width=128, height=96, raster_backend="pallas_gbuf_interpret")
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    band = render(scene, cam, width=128, height=96, rows=32, y_offset=48, raster_backend="pallas_gbuf_interpret")
    torch.testing.assert_close(band, b[48:80], atol=1e-6, rtol=0)

    from physically_based_renderer_tpu_torch.renderer import check_raster_capacity

    grid = scenes.red_sphere_grid_scene(16, 8, device="cpu")
    gcam = Camera.create(position=(0.0, -3.0, -18.0), aspect=128 / 64, device="cpu")
    ref = render(grid, gcam, width=128, height=64, raster_backend="jnp")
    stats = check_raster_capacity(grid, gcam, width=128, height=64, pairs_cap=128)
    fixed = render(grid, gcam, width=128, height=64, raster_backend="pallas_shade_interpret",
                   raster_pairs_cap=stats["suggested_pairs_cap"])
    torch.testing.assert_close(fixed, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("route", ["pallas_shade", "pallas_shade_row", "pallas_gbuf", "pallas_gbuf_row", "pallas"])
def test_every_kernel_route_raises_on_overflow(route):
    scene = scenes.red_sphere_grid_scene(8, 4, device="cpu")
    from physically_based_renderer_tpu_torch import Camera

    cam = Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        render(scene, cam, width=W, height=H, raster_backend=route, raster_pairs_cap=16)


def test_unknown_and_mismatched_routes_raise():
    scene = scenes.red_sphere_grid_scene(8, 4, device="cpu")
    from physically_based_renderer_tpu_torch import Camera

    cam = Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device="cpu")
    for bad in ("tpu", "pallas_row", "pallas_gbuf_row_interpret", "pallas_shade_ibl"):
        with pytest.raises(ValueError):
            render(scene, cam, width=W, height=H, raster_backend=bad)
    with pytest.raises(ValueError, match="whole frames"):
        render(scene, cam, width=W, height=H, rows=16, y_offset=8, raster_backend="brute")
    # the brute rasterizer has no depth peel, so no alpha test (the JAX package asserts it)
    alpha = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, any_alpha_test=True))
    with pytest.raises(ValueError, match="alpha test"):
        render(alpha, cam, width=W, height=H, raster_backend="brute")
    # an *_interpret name names a plain version: refused on the card
    for name in ("pallas_interpret", "pallas_gbuf_interpret", "pallas_shade_interpret",
                 "pallas_shade_ibl_interpret"):
        with pytest.raises(ValueError, match="CPU tensors only"):
            raster_route(name, scene, "cuda")
        if "ibl" not in name:  # the grid has no IBL maps
            assert raster_route(name, scene, "cpu") == name.removesuffix("_interpret")
    assert raster_route("auto", scene, "cuda") == "pallas_shade_row"


def test_render_config_reaches_render():
    scene = scenes.red_sphere_grid_scene(8, 4, device="cpu")
    from physically_based_renderer_tpu_torch import Camera

    cam = Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device="cpu")
    loop = RenderLoop(scene, cam, RenderConfig(width=W, height=H, raster_backend="brute"))
    frame = loop.step()
    np.testing.assert_array_equal(frame, render(scene, cam, width=W, height=H, raster_backend="brute").numpy())
    with pytest.raises(ValueError, match="unknown raster_backend"):
        RenderLoop(scene, cam, RenderConfig(width=W, height=H, raster_backend="tpu")).step()
