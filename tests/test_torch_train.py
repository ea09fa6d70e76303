"""PyTorch port vs the JAX package: the inverse-rendering training step.

``make_train_step`` of the port against the JAX package's
``parallel.sharded.make_train_step`` on a one-device mesh, for three SGD
steps from the same perturbed grid toward the same target: the losses agree
to 1e-4 relative, and each step's material update (−lr·grad) within the
gradient tolerance of ``tests/test_torch_backward.py``. Then the port's
version of ``tests/test_sharded.py::test_sharded_train_step_reduces_loss``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from physically_based_renderer_tpu import Camera as JCamera
from physically_based_renderer_tpu import scenes as jscenes
from physically_based_renderer_tpu.parallel import sharded as jsharded
from physically_based_renderer_tpu.renderer import render as jrender
from physically_based_renderer_tpu_torch import Camera, make_train_step, render, scenes
from torch_parity import to_port

W, H = 128, 64
FIELDS = ("diffuse", "metallic", "fresnel_r0", "roughness", "opacity")


def test_train_step_matches_jax_one_device_mesh():
    jscene = jscenes.red_sphere_grid_scene(slices=8, stacks=4)
    jcam = JCamera.create(position=(0.0, -3.0, -18.0), aspect=W / H)
    target = jrender(jscene, jcam, width=W, height=H, raster_backend="jnp")[..., :3]
    rng = np.random.default_rng(21)
    m = jscene.materials
    # Perturbed away from the sharp-highlight, black-channel corner (roughness
    # ≤ 0.05 with a zero albedo channel), where the shaded channel sits at the
    # tonemap's 1e-8 floor and the JAX package's float32 GGX noise decides
    # which side of it a pixel lands on.
    start = dataclasses.replace(
        m,
        roughness=jnp.clip(m.roughness + rng.uniform(-0.15, 0.15, m.roughness.shape), 0.1, 1.0)
        .astype(jnp.float32),
        diffuse=jnp.clip(m.diffuse + rng.uniform(-0.2, 0.2, m.diffuse.shape), 0.05, 1.0)
        .astype(jnp.float32),
    )
    jscene = dataclasses.replace(jscene, materials=start)
    scene, cam = to_port(jscene, jcam)
    lr = 2.0

    mesh = jsharded.make_render_mesh(jax.devices()[:1])
    jstep = jsharded.make_train_step(mesh=mesh, width=W, height=H, learning_rate=lr)
    step = make_train_step(width=W, height=H, learning_rate=lr)
    jtarget = jsharded.shard_target(target, mesh)
    ttarget = torch.as_tensor(np.array(target))
    for _ in range(3):
        jprev, prev = jscene.materials, scene.materials
        jscene, jloss = jstep(jscene, jcam, jtarget)
        scene, loss = step(scene, cam, ttarget)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        for k in FIELDS:
            new = np.asarray(getattr(jscene.materials, k))
            jd = new - np.asarray(getattr(jprev, k))
            d = (getattr(scene.materials, k) - getattr(prev, k)).numpy()
            # An update read back from float32 values carries their rounding:
            # two ulps of the value on top of the gradient tolerance.
            scale = max(float(np.abs(jd).max()), 1e-12)
            np.testing.assert_allclose(
                d, jd, rtol=2e-3, atol=5e-5 * scale + 1e-10 + 2 * float(np.spacing(np.abs(new)).max())
            )
        assert torch.equal(scene.materials.tex_index, prev.tex_index)
        assert torch.equal(scene.materials.transmission, prev.transmission)
    assert float(loss) > 0


def test_train_step_reduces_loss():
    """The port's ``test_sharded_train_step_reduces_loss``: a grey sphere
    fitted to a red one."""
    w, h = 128, 96
    cam = Camera.create(aspect=w / h, device="cpu")
    target = render(scenes.analytic_sphere_scene((0.9, 0.2, 0.1), 0.3, 0.8, slices=16, stacks=8,
                                                 device="cpu"),
                    cam, width=w, height=h)[..., :3]
    scene = scenes.analytic_sphere_scene((0.5, 0.5, 0.5), 0.7, 0.2, slices=16, stacks=8,
                                         device="cpu")
    step = make_train_step(width=w, height=h, learning_rate=20.0)
    losses = []
    for _ in range(15):
        scene, loss = step(scene, cam, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.2, losses
    assert not scene.materials.diffuse.requires_grad
