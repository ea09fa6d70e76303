"""Built-in analytic scenes — the counterpart of the analytic builders of
``physically_based_renderer_tpu/scenes.py`` (``PBRApp.cpp:504-1094``).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE
from .models.material import MaterialBuilder
from .models.mesh import sphere_mesh
from .models.scene import InstancedDraw, Scene, default_clear_color, translation_world
from .ops.brdf import Lights

AMBIENT = (0.03, 0.03, 0.03)  # PBRApp.cpp:478


def analytic_sphere_scene(
    albedo=(1.0, 0.0, 0.0),
    roughness=0.5,
    metallic=0.5,
    slices: int = 64,
    stacks: int = 32,
    lights: Lights | None = None,
    *,
    device=DEFAULT_DEVICE,
) -> Scene:
    """One constant-material sphere under the default 4 directional lights."""
    mb = MaterialBuilder()
    mb.add("sphere", diffuse=albedo, roughness=roughness, metallic=metallic)
    return Scene(
        draws=(
            InstancedDraw.create(
                sphere_mesh(1.0, slices, stacks, device=device), np.eye(4, dtype=np.float32), [0]
            ),
        ),
        materials=mb.build(device=device),
        lights=lights if lights is not None else Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
    )


def red_sphere_grid_scene(slices: int = 64, stacks: int = 32, *, device=DEFAULT_DEVICE) -> Scene:
    """The 7×7 analytic red-sphere sweep: roughness=(i%7)/6,
    metallic=1-(i//7)/6, positions from PBRApp.cpp:1016-1024."""
    mb = MaterialBuilder()
    worlds, mids = [], []
    for i in range(49):
        mid = mb.add(
            f"sphere_red_{i}",
            diffuse=(1.0, 0.0, 0.0),
            fresnel_r0=(0.04, 0.04, 0.04),
            roughness=(i % 7) / 6.0,
            metallic=1.0 - (i // 7) / 6.0,
        )
        x = (i % 7) * 2.5 - 3 * 2.5
        y = (i // 7) * -2.5 - 2.5
        worlds.append(translation_world(x, y, 0.0))
        mids.append(mid)
    mesh = sphere_mesh(1.0, slices, stacks, device=device)
    return Scene(
        draws=(InstancedDraw.create(mesh, np.stack(worlds), mids),),
        materials=mb.build(device=device),
        lights=Lights.default_scene_lights(device=device),
        ambient=torch.tensor(AMBIENT, dtype=torch.float32, device=device),
        clear_color=default_clear_color(device),
    )
