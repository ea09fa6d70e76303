"""physically_based_renderer_tpu_torch — the PyTorch + CUDA port of
``physically_based_renderer_tpu``.

The JAX package stays the reference; this package mirrors its module names.
It imports torch and NumPy, never JAX. The forward render of untextured,
non-IBL scenes runs through a hand-written Hopper kernel
(``csrc/raster_shade_row.cu``) on CUDA tensors and through its plain PyTorch
version on CPU tensors::

    import physically_based_renderer_tpu_torch as pbr
    scene = pbr.scenes.red_sphere_grid_scene(device="cuda")
    cam = pbr.Camera.create(position=(0.0, -3.0, -18.0), aspect=1920 / 1080, device="cuda")
    img = pbr.render(scene, cam, width=1920, height=1080)  # (1080, 1920, 4)
"""

from . import math3d, scenes
from .camera import Camera
from .models.material import MaterialBank, MaterialBuilder
from .models.mesh import Mesh, sphere_mesh
from .models.scene import InstancedDraw, Scene, flatten_scene_corners
from .ops.brdf import Lights
from .renderer import render

__all__ = [
    "Camera",
    "InstancedDraw",
    "Lights",
    "MaterialBank",
    "MaterialBuilder",
    "Mesh",
    "Scene",
    "flatten_scene_corners",
    "math3d",
    "render",
    "scenes",
    "sphere_mesh",
]
