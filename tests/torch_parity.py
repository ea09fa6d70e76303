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


def ibl_to_numpy(maps) -> dict | None:
    """A JAX ``IBLMaps`` as a dict of NumPy arrays (its field names)."""
    if maps is None:
        return None
    out = {f.name: _np(getattr(maps, f.name)) for f in dataclasses.fields(maps)
           if f.name != "specular_levels"}
    out["specular_levels"] = [np.asarray(t) for t in maps.specular_levels]
    return out


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
        ibl=ibl_to_numpy(scene.ibl),
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


def random_gbuffer(seed: int, rows: int = 32, width: int = 128, *, roughness=None,
                   highlight_frac: float = 0.0) -> dict:
    """NumPy inputs of ``shade_backward``: 2 directional, 1 point and 1 spot
    light, 5 materials, ~30% background, an RGBA cotangent. ``roughness``
    None draws it from [0.2, 1]; a number sets every material's. With
    ``highlight_frac`` > 0 that share of the pixels gets a normal within
    ~0.2° of the first light's half vector: the sharp-highlight case."""
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    num_mat = 5
    unit = lambda d: (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    props = np.concatenate(
        [f(num_mat, 3, lo=0, hi=1), f(num_mat, 1, lo=0, hi=1), f(num_mat, 3, lo=0, hi=0.1),
         f(num_mat, 1, lo=0.2, hi=1) if roughness is None else np.full((num_mat, 1), roughness, np.float32),
         f(num_mat, 1, lo=0.3, hi=1)], axis=1)
    lights = dict(
        light_strength=f(4, 3, lo=0.2, hi=2),
        light_direction=unit(f(4, 3)),
        light_position=np.concatenate([np.zeros((2, 3), np.float32), f(2, 3, lo=-4, hi=4)]),
        light_spot_power=np.array([0, 0, 0, rng.uniform(2, 16)], np.float32),
        ambient=f(3, lo=0, hi=0.1),
        eye=np.array([0.3, -0.5, -8.0], np.float32),
    )
    # Spot light aimed at the origin, so its cone covers part of the frame.
    lights["light_direction"][3] = unit(-lights["light_position"][3])
    pos = f(rows, width, 3, lo=-2, hi=2)
    nrm = f(rows, width, 3) * rng.uniform(0.5, 2.0, (rows, width, 1)).astype(np.float32)
    if highlight_frac > 0:
        v = unit(lights["eye"] - pos)
        h = unit(v - lights["light_direction"][0])
        sel = rng.uniform(size=(rows, width)) < highlight_frac
        nrm = np.where(sel[..., None], unit(h + 4e-3 * f(rows, width, 3)), nrm).astype(np.float32)
    return dict(
        g_chan=rng.normal(size=(rows, width, 4)).astype(np.float32),
        attrs=np.concatenate([pos, nrm], axis=-1),
        mat_id=rng.integers(0, num_mat, (rows, width)).astype(np.int32),
        hit=rng.uniform(size=(rows, width)) > 0.3,
        mat_props=props.astype(np.float32),
        lights=lights,
        counts=dict(num_dir=2, num_point=1, num_spot=1),
    )


def seeded_env(seed: int, height: int = 16, width: int = 32) -> np.ndarray:
    """An HDR equirect (H, W, 3) f32 (the sIBL ``_Env.hdr`` convention): a
    smooth sky gradient plus two bright sun lobes (values up to ~50), from a
    seed."""
    rng = np.random.default_rng(seed)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    theta, phi = 2 * np.pi * uu, np.pi * (0.5 - vv)
    d = np.stack([np.cos(phi) * np.cos(theta), np.sin(phi), np.cos(phi) * np.sin(theta)], -1)
    env = np.stack([0.3 + 0.7 * (1 - vv), 0.4 + 0.5 * (1 - vv), 0.6 + 0.6 * (1 - vv)], -1)
    for _ in range(2):
        s = rng.normal(size=3)
        s /= np.linalg.norm(s)
        s[1] = abs(s[1])
        lobe = np.maximum(d @ s, 0.0) ** rng.uniform(20, 60)
        env = env + rng.uniform(30, 50) * lobe[..., None] * rng.uniform(0.7, 1.0, 3)
    return env.astype(np.float32)


def grad_tolerance(ref, got, rtol: float = 2e-3, atol_frac: float = 5e-5):
    """``|got − ref| ≤ atol_frac·max|ref| + 1e-10 + rtol·|ref|`` elementwise
    (the JAX suite's gradient tolerance, ``tests/test_raster_shade.py``)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-12)
    np.testing.assert_allclose(got, ref, atol=atol_frac * scale + 1e-10, rtol=rtol)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (tests
    marked ``cuda`` run on the card: ``python -m pytest tests -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
