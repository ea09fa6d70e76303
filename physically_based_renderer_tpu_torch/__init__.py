"""physically_based_renderer_tpu_torch — the PyTorch + CUDA port of
``physically_based_renderer_tpu``.

The JAX package stays the reference; this package mirrors its module names.
It imports torch and NumPy, never JAX. The render of untextured scenes, with
or without image-based lighting, and its gradients run through hand-written
Hopper kernels on CUDA tensors (``csrc/raster_shade_row.cu`` forward,
``csrc/shade_backward.cu`` backward, each with a shade mode and an IBL mode)
and through their plain PyTorch versions on CPU tensors::

    import physically_based_renderer_tpu_torch as pbr
    scene = pbr.scenes.red_sphere_grid_scene(device="cuda")
    cam = pbr.Camera.create(position=(0.0, -3.0, -18.0), aspect=1920 / 1080, device="cuda")
    img = pbr.render(scene, cam, width=1920, height=1080)  # (1080, 1920, 4)
    step = pbr.make_train_step(width=1920, height=1080)  # SGD on the materials
    scene, loss = step(scene, cam, target_rgb)
    # image-based lighting: an HDR equirect env (H, W, 3) on the card
    lit = dataclasses.replace(scene, env_map=env).with_ibl()
"""

from . import math3d, scenes
from .camera import Camera
from .models.material import MaterialBank, MaterialBuilder
from .models.mesh import Mesh, sphere_mesh
from .models.scene import InstancedDraw, Scene, flatten_scene_corners
from .ops.brdf import Lights
from .ops.ibl import IBLMaps
from .parallel.sharded import make_train_step
from .renderer import render

__all__ = [
    "Camera",
    "IBLMaps",
    "InstancedDraw",
    "Lights",
    "MaterialBank",
    "MaterialBuilder",
    "Mesh",
    "Scene",
    "flatten_scene_corners",
    "make_train_step",
    "math3d",
    "render",
    "scenes",
    "sphere_mesh",
]
