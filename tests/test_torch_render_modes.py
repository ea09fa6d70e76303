"""PyTorch port vs the JAX package: ``render_wireframe``, ``render_ssaa``
and ``ops/raster_soft.signed_distance_px``, on ``analytic_sphere_scene(12,
6)`` as ``tests/test_app.py`` renders them.

* ``signed_distance_px`` on the same ids: within 1e-4 px, and its gradient
  to the clip coordinates within the JAX suite's gradient tolerance
  (``torch_parity.grad_tolerance``);
* ``render_wireframe`` at 96×96: JAX rasterizes with its jnp rasterizer and
  the port with kernel 5, so pixel-fraction bounds: under 1% of the pixels
  differ (a pixel centre within ulps of a wire's edge can flip);
* ``render_ssaa(factor=2)`` at 64×64 (a 128×128 ``render``): elementwise
  within 2e-4, the untextured frame tolerance of
  ``tests/test_torch_render.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import math3d as jmath3d
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.models.scene import flatten_scene_corners as jflatten
from physically_based_renderer_tpu.ops import raster as jraster
from physically_based_renderer_tpu.ops import raster_soft as jsoft
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu.renderer import render_ssaa as jrender_ssaa
from physically_based_renderer_tpu.renderer import render_wireframe as jrender_wireframe
from physically_based_renderer_tpu_torch import render
from physically_based_renderer_tpu_torch.ops import raster_row
from physically_based_renderer_tpu_torch.ops.raster_soft import signed_distance_px
from physically_based_renderer_tpu_torch.renderer import render_ssaa, render_wireframe
from torch_parity import grad_tolerance, to_port

SD_ATOL = 1e-4


def _scene():
    return jscenes.analytic_sphere_scene(slices=12, stacks=6), JCamera.create(aspect=1.0)


def _sd_inputs(width=96, height=96, rows=None, y_offset=0):
    jscene, jcam = _scene()
    g = jflatten(jscene, textured=False)
    clip = jmath3d.transform_points_h(g.pos_w, jcam.view_proj())
    tri_id = jraster.rasterize(clip, None, width=width, height=height, rows=rows, y_offset=y_offset)
    return clip, tri_id


def test_signed_distance_matches_jax():
    for rows, y_offset in ((None, 0), (40, 30)):  # the frame, and a band
        clip, tri_id = _sd_inputs(rows=rows, y_offset=y_offset)
        kw = dict(width=96, height=96, y_offset=y_offset)
        ref = np.asarray(jsoft.signed_distance_px(clip, None, tri_id, **kw))
        got = signed_distance_px(torch.as_tensor(np.array(clip)), None, torch.as_tensor(np.array(tri_id)), **kw)
        np.testing.assert_allclose(got.numpy(), ref, atol=SD_ATOL, rtol=0)
        hit = np.asarray(tri_id) >= 0
        assert (got.numpy()[hit] >= -SD_ATOL).all() and (got.numpy()[hit] < 20).all()


def test_signed_distance_geometry_gradient_matches_jax():
    """d Σ w·sd / d clip, with seeded weights w over the frame (background
    pixels read triangle 0, as in the JAX package, and carry gradient)."""
    clip, tri_id = _sd_inputs()
    w = np.random.default_rng(3).normal(size=tri_id.shape).astype(np.float32)
    ref = jax.grad(lambda c: jnp.sum(jnp.asarray(w) * jsoft.signed_distance_px(c, None, tri_id, width=96,
                                                                                 height=96)))(clip)
    c = torch.as_tensor(np.array(clip)).requires_grad_()
    (torch.as_tensor(w) * signed_distance_px(c, None, torch.as_tensor(np.array(tri_id)), width=96, height=96)).sum(
    ).backward()
    assert float(c.grad.abs().sum()) > 0
    grad_tolerance(np.asarray(ref), c.grad.numpy())


def test_render_wireframe_matches_jax():
    jscene, jcam = _scene()
    scene, cam = to_port(jscene, jcam)
    ref = np.asarray(jrender_wireframe(jscene, jcam, width=96, height=96))
    before = raster_row.IDS_KERNEL_LAUNCHES
    img = render_wireframe(scene, cam, width=96, height=96).numpy()
    assert raster_row.IDS_KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert img.shape == (96, 96, 4) and (img[..., 3] == 1).all()
    dark = (img[..., :3] < 0.1).all(-1)
    grey = np.abs(img[..., :3] - 0.5).max(-1) < 1e-6
    assert dark.any() and grey.any() and 0.005 < dark.mean() < 0.2  # tests/test_app.py's checks
    differ = np.abs(img - ref).max(-1) > 1e-6
    assert differ.mean() < 0.01, differ.sum()
    np.testing.assert_allclose(img[~differ], ref[~differ], atol=1e-6, rtol=0)


def test_render_ssaa_matches_jax():
    jscene, jcam = _scene()
    scene, cam = to_port(jscene, jcam)
    ref = np.asarray(jrender_ssaa(jscene, jcam, width=64, height=64, factor=2))
    aa = render_ssaa(scene, cam, width=64, height=64, factor=2)
    assert aa.shape == (64, 64, 4)
    np.testing.assert_allclose(aa.numpy(), ref, atol=2e-4, rtol=0)
    full = render(scene, cam, width=128, height=128)
    torch.testing.assert_close(aa, full.reshape(64, 2, 64, 2, 4).mean(dim=(1, 3)), atol=0, rtol=0)
    hard = render(scene, cam, width=64, height=64).numpy()

    def frac_intermediate(img):  # tests/test_app.py: silhouettes take intermediate values
        d = np.abs(img[..., :3] - 0.5).max(-1)
        return ((d > 0.01) & (d < 0.2)).mean()

    assert frac_intermediate(aa.numpy()) > frac_intermediate(hard)
    np.testing.assert_allclose(hard, np.asarray(jrender(jscene, jcam, width=64, height=64)), atol=2e-4, rtol=0)
