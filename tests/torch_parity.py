"""Helpers for the PyTorch port's tests: flatten a JAX ``Scene`` /
``Camera`` into the nested NumPy dict that
``physically_based_renderer_tpu_torch.utils.convert`` takes, so one scene
runs through both packages from identical arrays; and the ``cuda_device``
fixture of the tests that need the card. Imports nothing of JAX itself."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch import flatten_scene_corners, math3d
from physically_based_renderer_tpu_torch.utils.convert import camera_from_numpy, scene_from_numpy


def _np(x):
    return None if x is None else np.asarray(x)


def scene_to_numpy(scene) -> dict:
    draws = []
    for d in scene.draws:
        m = d.mesh
        draws.append(
            dict(
                mesh={k: _np(getattr(m, k)) for k in
                      ("positions", "normals", "tangents", "bitangents", "uvs", "tris")},
                worlds=_np(d.worlds),
                material_ids=_np(d.material_ids),
                face_materials=_np(d.face_materials),
            )
        )
    mats = {}
    for f in dataclasses.fields(scene.materials):
        v = getattr(scene.materials, f.name)
        mats[f.name] = v if isinstance(v, bool) else _np(v)
    lt = scene.lights
    lights = dict(
        strength=_np(lt.strength),
        direction=_np(lt.direction),
        position=_np(lt.position),
        spot_power=_np(lt.spot_power),
        num_dir=lt.num_dir,
        num_point=lt.num_point,
        num_spot=lt.num_spot,
    )
    return dict(
        draws=draws,
        materials=mats,
        lights=lights,
        ambient=_np(scene.ambient),
        clear_color=_np(scene.clear_color),
        atlas=scene.atlas,
        env_map=_np(scene.env_map),
        ibl=scene.ibl,
        sky_map=_np(scene.sky_map),
        combined_atlas=scene.combined_atlas,
    )


def camera_to_numpy(cam) -> dict:
    return dict(
        position=_np(cam.position),
        yaw=_np(cam.yaw),
        pitch=_np(cam.pitch),
        fov_y=cam.fov_y,
        aspect=cam.aspect,
        near=cam.near,
        far=cam.far,
    )


def to_port(scene, cam, device="cpu"):
    """(JAX scene, JAX camera) → (port scene, port camera) on ``device``."""
    return (
        scene_from_numpy(scene_to_numpy(scene), device=device),
        camera_from_numpy(camera_to_numpy(cam), device=device),
    )


def row_args(scene, cam):
    """Positional arguments of ``rasterize_binned_shade_row`` for a port scene."""
    g = flatten_scene_corners(scene)
    L = scene.lights
    return (math3d.transform_points_h(g.pos_w, cam.view_proj()), g.attrs, g.face_material,
            scene.materials.props_table(), L.strength, L.direction, L.position, L.spot_power,
            scene.ambient, cam.position)


def random_worlds(rng: np.random.Generator, n: int, spread: float = 3.0) -> np.ndarray:
    """``n`` row-vector rigid world matrices (rotation + translation)."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        out[i, :3, :3] = q
        out[i, 3, :3] = rng.uniform(-spread, spread, size=3)
        out[i, 3, 3] = 1.0
    return out


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (tests
    marked ``cuda`` run on the card: ``python -m pytest tests -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
