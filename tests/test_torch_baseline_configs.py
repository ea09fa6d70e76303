"""BASELINE.json config goldens held on the port: ``tests/
test_baseline_configs.py``'s tests, the port's ``render`` (on CPU tensors:
kernel 1's plain version for the untextured grid, kernel 4's and
``shade_pixels`` for the textured sphere) against the independent NumPy
oracle ``tests/reference_renderer.py`` through ``_oracle_of_scene`` over
the port's ``flatten_scene``. This file imports no JAX.

The JAX tests' frames and bounds, unchanged: config 2 (the 7×7 sphere grid)
at 192×144 and config 3 (a synthetic textured sphere, also through the
combined pages) at 160×120, under 1% and 1.5% of pixels off by more than
2e-2; config 3's texel gradient against a directional central difference
(eps 1e-3) at 48×48, rtol 0.1 (+ 1e-4). Config 4 (mori_knob, 192×144 and
its material-gradient finite difference at 96×72) skips while the
reference assets are absent, as the JAX tests do.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import reference_renderer as oracle
from physically_based_renderer_tpu_torch import Camera, InstancedDraw, MaterialBuilder, Scene, render, scenes
from physically_based_renderer_tpu_torch.models.mesh import sphere_mesh
from physically_based_renderer_tpu_torch.models.scene import flatten_scene
from physically_based_renderer_tpu_torch.ops.brdf import Lights
from physically_based_renderer_tpu_torch.ops.texture import build_atlas
from physically_based_renderer_tpu_torch.utils.image_io import REFERENCE_ASSETS

DIR_LIGHTS = [
    ((0.57735, 0.57735, 0.57735), (0.25, 0.25, 0.25)),
    ((0.57735, -0.57735, 0.57735), (0.25, 0.25, 0.25)),
    ((-0.57735, 0.57735, 0.57735), (0.25, 0.25, 0.25)),
    ((-0.57735, -0.57735, 0.57735), (0.25, 0.25, 0.25)),
]

ASSET_OBJ = os.path.join(REFERENCE_ASSETS, "mori_knob", "testObj.obj")  # where the JAX tests look


def _oracle_of_scene(scene, cam, width, height, materials):
    geom = flatten_scene(scene)
    img, _ = oracle.render_general(
        geom.pos_w.numpy(), geom.normal_w.numpy(), geom.tangent_w.numpy(), geom.bitangent_w.numpy(),
        geom.uv.numpy(), geom.tris.numpy(), geom.face_material.numpy(), materials, np.eye(4),
        cam.view_proj().double().numpy(), cam.position.double().numpy(), width, height, DIR_LIGHTS,
    )
    return img


def _check(img, img_oracle, max_bad=0.01, tol=2e-2):
    diff = np.abs(img.detach().numpy()[..., :3] - img_oracle)
    bad = (diff.max(axis=-1) > tol).mean()
    assert bad < max_bad, f"{bad:.4%} pixels differ by > {tol}"


def test_config2_sphere_grid_matches_oracle():
    w, h = 192, 144
    scene = scenes.red_sphere_grid_scene(slices=16, stacks=8, device="cpu")
    cam = Camera.create(position=(0.0, -5.0, -16.0), aspect=w / h, device="cpu")
    img = render(scene, cam, width=w, height=h)
    mats = [dict(diffuse=(1.0, 0.0, 0.0), fresnel_r0=(0.04,) * 3, roughness=(i % 7) / 6.0,
                 metallic=1.0 - (i // 7) / 6.0) for i in range(49)]
    _check(img, _oracle_of_scene(scene, cam, w, h, mats))


def _synthetic_textured_scene(size=32):
    """``tests/test_baseline_configs.py``'s scene, from the same seed: a
    sphere with seeded albedo, metallic, roughness and normal maps."""
    rng = np.random.default_rng(7)
    alb = rng.uniform(0.1, 0.9, (size, size, 3)).astype(np.float32)
    met = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 1, (size, size, 3)).astype(np.float32)
    nrm = np.stack([np.full((size, size), 0.5), np.full((size, size), 0.5), np.full((size, size), 1.0)],
                   axis=-1).astype(np.float32)
    nrm[..., :2] += rng.uniform(-0.2, 0.2, (size, size, 2)).astype(np.float32)
    atlas = build_atlas([alb, met, rough, nrm], [False, False, False, False], size=size, device="cpu")
    mb = MaterialBuilder()
    mb.add("rust", textures={"diffuse": 0, "metallic": 1, "roughness": 2, "normal": 3})
    scene = Scene(
        draws=(InstancedDraw.create(sphere_mesh(1.0, 16, 8, device="cpu"), np.eye(4, dtype=np.float32), [0]),),
        materials=mb.build(device="cpu"),
        atlas=atlas,
        lights=Lights.default_scene_lights(device="cpu"),
        ambient=torch.tensor([0.03, 0.03, 0.03]),
        clear_color=torch.tensor([0.5, 0.5, 0.5]),
    )
    mip0 = atlas.mips[0].double().numpy()
    oracle_mats = [dict(tex_diffuse=mip0[0], tex_metallic=mip0[1], tex_roughness=mip0[2], tex_normal=mip0[3])]
    return scene, oracle_mats


def test_config3_textured_sphere_matches_oracle():
    w, h = 160, 120
    scene, oracle_mats = _synthetic_textured_scene()
    cam = Camera.create(aspect=w / h, device="cpu")
    expected = _oracle_of_scene(scene, cam, w, h, oracle_mats)
    _check(render(scene, cam, width=w, height=h), expected, max_bad=0.015)
    # the combined pages hit the same golden
    _check(render(scene.with_combined_textures(), cam, width=w, height=h), expected, max_bad=0.015)


def test_config3_texture_texel_grads_fd():
    scene, _ = _synthetic_textured_scene(size=16)
    cam = Camera.create(aspect=1.0, device="cpu")

    def loss(mip0):
        s = dataclasses.replace(scene, atlas=dataclasses.replace(scene.atlas, mips=(mip0,) + scene.atlas.mips[1:]))
        return torch.mean(render(s, cam, width=48, height=48)[..., :3])

    mip0 = scene.atlas.mips[0].clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(mip0), mip0)
    assert bool(torch.isfinite(g).all())
    # a directional difference (a single texel's needs a tiny eps near the
    # normal-map texels, whose shading response is highly curved)
    d = torch.as_tensor(np.random.default_rng(0).normal(size=tuple(mip0.shape)), dtype=torch.float32)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(mip0 + eps * d)) - float(loss(mip0 - eps * d))) / (2 * eps)
    np.testing.assert_allclose(float(torch.sum(g * d)), fd, rtol=0.1, atol=1e-4)


@pytest.mark.skipif(not os.path.exists(ASSET_OBJ), reason="reference assets absent")
def test_config4_mori_knob_matches_oracle():
    w, h = 192, 144
    scene = scenes.mori_knob_scene(texture_size=64, device="cpu")
    cam = Camera.create(position=(0.0, 0.8, -3.0), pitch=-0.2, aspect=w / h, device="cpu")
    img = render(scene, cam, width=w, height=h)
    m = scene.materials
    mats = [dict(diffuse=tuple(m.diffuse[i].tolist()), metallic=float(m.metallic[i]),
                 fresnel_r0=tuple(m.fresnel_r0[i].tolist()), roughness=float(m.roughness[i]))
            for i in range(m.num_materials)]
    _check(img, _oracle_of_scene(scene, cam, w, h, mats), max_bad=0.02)


@pytest.mark.skipif(not os.path.exists(ASSET_OBJ), reason="reference assets absent")
def test_config4_mori_knob_material_grads_fd():
    scene = scenes.mori_knob_scene(texture_size=32, device="cpu")
    cam = Camera.create(position=(0.0, 0.8, -3.0), pitch=-0.2, aspect=4 / 3, device="cpu")

    def loss(rough):
        mats = dataclasses.replace(scene.materials, roughness=scene.materials.roughness * rough)
        return torch.mean(render(dataclasses.replace(scene, materials=mats), cam, width=96, height=72)[..., :3])

    r = torch.ones((), requires_grad=True)
    (g,) = torch.autograd.grad(loss(r), r)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(torch.tensor(1 + eps))) - float(loss(torch.tensor(1 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=3e-2)
