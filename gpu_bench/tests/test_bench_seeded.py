"""Inputs from the seed: the same seed gives the same inputs, another seed
other inputs, and every seed the same sizes and the same camera poses."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpu_bench import seeded

SEEDS = (2**31 + 5, 2**31 + 6)


@pytest.mark.parametrize("make", [
    lambda s: seeded.texture_pages(s, ["diffuse", "normal", "roughness"], 32, "cpu"),
    lambda s: seeded.environment(s, 16, 32, "cpu"),
    lambda s: seeded.sky_u8(s, 16, 32, "cpu"),
    lambda s: seeded.targets(s, 2, 8, 16, "cpu"),
])
def test_same_seed_same_input_other_seed_other_input(make):
    a, b, c = make(SEEDS[0]), make(SEEDS[0]), make(SEEDS[1])
    assert torch.equal(a, b)
    assert a.shape == c.shape and not torch.equal(a, c)


def test_pages_are_textures_normal_maps_unit():
    pages = seeded.texture_pages(3, ["diffuse", "normal"], 64, "cpu")
    assert pages.dtype == torch.uint8 and pages.shape == (2, 64, 64, 3)
    n = pages[1].double() / 255.0 * 2.0 - 1.0
    assert torch.allclose(n.norm(dim=-1), torch.ones(64, 64, dtype=torch.float64), atol=0.02)
    assert float(n[..., 2].min()) > 0.9


@pytest.mark.parametrize("path", [
    {"centre": [0.0, -8.75, 0.0], "radius": 27.0, "poses": 240, "yaw_amp": 0.35, "pitch_amp": 0.12},
    {"centre": [0.0, 0.0, 0.0], "radius": 2.5, "poses": 360, "yaw_amp": None, "pitch_amp": 0.3},
])
def test_camera_path_visits_the_same_poses_in_another_order(path):
    a, b = seeded.camera_path(SEEDS[0], path, path["poses"]), seeded.camera_path(SEEDS[1], path, path["poses"])
    assert np.array_equal(a, seeded.camera_path(SEEDS[0], path, path["poses"]))
    assert not np.array_equal(a, b)
    key = lambda p: sorted(map(tuple, np.round(p, 5)))  # noqa: E731
    assert key(a) == key(b)
    fwd = np.stack([np.cos(a[:, 4]) * np.sin(a[:, 3]), np.sin(a[:, 4]), np.cos(a[:, 4]) * np.cos(a[:, 3])], -1)
    assert np.allclose(a[:, :3] + path["radius"] * fwd, np.asarray(path["centre"])[None], atol=1e-4)
