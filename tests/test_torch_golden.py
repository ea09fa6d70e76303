"""Golden tests of the port against the independent NumPy oracle
(``tests/reference_renderer.py``, BASELINE config 1) and central finite
differences — ``tests/test_render_golden.py``'s five tests, held on the
PyTorch package. This file imports no JAX: the oracle is NumPy, and the
port renders through its ``"auto"`` route (kernel 1's plain version on CPU
tensors).

The JAX tests' frames and bounds: 160×120 for the sphere against the
oracle (< 1% of pixels off by > 2e-2, median error < 2e-3) and for its
coverage (within 5% of the analytic disc); 64×48 for the gradients (a
material's roughness, metallic and albedo and a light's strength within
rtol 2e-2 of central differences at eps 1e-3; the world matrices' gradient
finite and nonzero).
"""

import dataclasses

import numpy as np
import torch

import reference_renderer as oracle
from physically_based_renderer_tpu_torch import Camera, render, scenes
from physically_based_renderer_tpu_torch.models.mesh import sphere_mesh

W, H = 160, 120

DIR_LIGHTS = [
    ((0.57735, 0.57735, 0.57735), (0.25, 0.25, 0.25)),
    ((0.57735, -0.57735, 0.57735), (0.25, 0.25, 0.25)),
    ((-0.57735, 0.57735, 0.57735), (0.25, 0.25, 0.25)),
    ((-0.57735, -0.57735, 0.57735), (0.25, 0.25, 0.25)),
]


def _cam(aspect):
    return Camera.create(aspect=aspect, device="cpu")


def _oracle_sphere(albedo, metallic, roughness, slices=24, stacks=12):
    mesh = sphere_mesh(1.0, slices, stacks, device="cpu")
    vp = _cam(W / H).view_proj().double().numpy()
    f0 = (1 - metallic) * np.asarray([0.04] * 3) + metallic * np.asarray(albedo)
    img, depth = oracle.render_constant_material(
        mesh.positions.numpy(), mesh.normals.numpy(), mesh.tris.numpy(), np.eye(4), vp,
        np.asarray([0.0, 0.0, -5.0]), W, H, albedo, metallic, f0, roughness, DIR_LIGHTS,
    )
    return img, depth


def test_analytic_sphere_matches_oracle():
    albedo, metallic, roughness = (1.0, 0.0, 0.0), 0.5, 0.5
    scene = scenes.analytic_sphere_scene(albedo, roughness, metallic, slices=24, stacks=12, device="cpu")
    img = render(scene, _cam(W / H), width=W, height=H)[..., :3].numpy()
    expected, _ = _oracle_sphere(albedo, metallic, roughness)
    diff = np.abs(img - expected)
    # edge pixels may disagree (different, equally valid tie rules); the interior must match
    bad = (diff.max(axis=-1) > 2e-2).mean()
    assert bad < 0.01, f"{bad:.4%} pixels differ by >2e-2"
    assert np.median(diff) < 2e-3


def test_sphere_coverage_fraction():
    scene = scenes.analytic_sphere_scene(slices=48, stacks=24, device="cpu")
    cam = _cam(W / H)
    img = render(scene, cam, width=W, height=H).numpy()
    covered = (np.abs(img[..., :3] - 0.5).max(axis=-1) > 1e-6).sum()
    # the silhouette of a unit sphere seen from 5 units: angular radius asin(1/5)
    pix_r = np.tan(np.arcsin(1.0 / 5.0)) / np.tan(cam.fov_y / 2) * (H / 2)
    expect = np.pi * pix_r**2
    assert abs(covered - expect) / expect < 0.05


def _small():
    return scenes.analytic_sphere_scene(slices=16, stacks=8, device="cpu"), _cam(64 / 48)


def _central(loss_fn, args, i, eps=1e-3):
    hi, lo = list(args), list(args)
    hi[i] += eps
    lo[i] -= eps
    with torch.no_grad():
        return (float(loss_fn(*hi)) - float(loss_fn(*lo))) / (2 * eps)


def test_grad_matches_finite_difference_material():
    scene, cam = _small()

    def loss_fn(rough, metal, albedo_r):
        mats = scene.materials
        diffuse = torch.cat([torch.as_tensor(albedo_r, dtype=torch.float32).expand(mats.diffuse.shape[0], 1),
                             mats.diffuse[:, 1:]], dim=-1)
        mats = dataclasses.replace(mats, roughness=torch.ones_like(mats.roughness) * rough,
                                   metallic=torch.ones_like(mats.metallic) * metal, diffuse=diffuse)
        img = render(dataclasses.replace(scene, materials=mats), cam, width=64, height=48)
        return torch.mean(img[..., :3] ** 2)

    args = [0.4, 0.6, 0.9]
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    grads = torch.autograd.grad(loss_fn(*leaves), leaves)
    for i in range(3):
        g = float(grads[i])
        assert np.isfinite(g)
        np.testing.assert_allclose(g, _central(loss_fn, args, i), rtol=2e-2, atol=1e-6, err_msg=str(i))


def test_grad_matches_finite_difference_light():
    scene, cam = _small()

    def loss_fn(strength_scale):
        lights = dataclasses.replace(scene.lights, strength=scene.lights.strength * strength_scale)
        img = render(dataclasses.replace(scene, lights=lights), cam, width=64, height=48)
        return torch.mean(img[..., :3])

    s = torch.tensor(1.0, requires_grad=True)
    (g,) = torch.autograd.grad(loss_fn(s), s)
    np.testing.assert_allclose(float(g), _central(loss_fn, [1.0], 0), rtol=2e-2)


def test_grad_flows_to_world_matrices():
    scene, cam = _small()

    def loss_fn(scale):
        draw = scene.draws[0]
        w = draw.worlds * torch.stack([scale, scale, scale, torch.ones_like(scale)])[None, :, None]
        s = dataclasses.replace(scene, draws=(dataclasses.replace(draw, worlds=w),))
        img = render(s, cam, width=64, height=48)
        return torch.mean(img[..., :3])

    scale = torch.tensor(1.0, requires_grad=True)
    (g,) = torch.autograd.grad(loss_fn(scale), scale)
    assert np.isfinite(float(g)) and abs(float(g)) > 0.0
