"""physically_based_renderer_tpu_torch — the PyTorch + CUDA port of
``physically_based_renderer_tpu``.

The JAX package stays the reference; this package mirrors its module names.
It imports torch and NumPy, never JAX. The render, with or without
image-based lighting, textures (atlases, combined pages, normal and parallax
maps, mip LOD) and alpha-tested materials, its gradients, and the row-band
and triangle-sharded paths over ``torch.distributed`` run through
hand-written Hopper kernels on CUDA tensors (``csrc/raster_shade_row.cu``:
the fused raster+shade forward, its IBL mode and its G-buffer mode — the
textured path's raster;
``csrc/shade_backward.cu``: the shading adjoint; ``csrc/shade_forward.cu``:
shading of a resolved G-buffer band) and through their plain PyTorch
versions on CPU tensors. The constructors put their tensors on the card
unless the caller names another device (``DEFAULT_DEVICE``)::

    import physically_based_renderer_tpu_torch as pbr
    scene = pbr.scenes.red_sphere_grid_scene()  # on the card
    cam = pbr.Camera.create(position=(0.0, -3.0, -18.0), aspect=1920 / 1080)
    img = pbr.render(scene, cam, width=1920, height=1080)  # (1080, 1920, 4)
    step = pbr.make_train_step(width=1920, height=1080)  # SGD on the materials
    scene, loss = step(scene, cam, target_rgb)
    # image-based lighting: an HDR equirect env (H, W, 3) on the card
    lit = dataclasses.replace(scene, env_map=env).with_ibl()
    # textures: an AssetCache filled with decoded pages, then one page a material
    textured = pbr.scenes.pbr_scene(cache).with_combined_textures(mode="quad")
    # one process per card in an initialised process group: this rank's band
    band = pbr.render_tri_sharded(scene, cam, width=1920, height=1080)
    frame = pbr.fetch_image(band)
"""

from . import math3d, scenes
from .camera import Camera
from .models.material import MaterialBank, MaterialBuilder
from .models.mesh import Mesh, sphere_mesh
from .models.scene import InstancedDraw, Scene, flatten_scene_corners
from .ops.brdf import Lights
from .device import DEFAULT_DEVICE
from .ops.ibl import IBLMaps
from .parallel.distributed import fetch_image, initialize_distributed, measure_scaling
from .parallel.sharded import make_train_step, render_sharded, render_tri_sharded, shard_target
from .renderer import render

__all__ = [
    "DEFAULT_DEVICE",
    "Camera",
    "IBLMaps",
    "InstancedDraw",
    "Lights",
    "MaterialBank",
    "MaterialBuilder",
    "Mesh",
    "Scene",
    "fetch_image",
    "flatten_scene_corners",
    "initialize_distributed",
    "make_train_step",
    "math3d",
    "measure_scaling",
    "render",
    "render_sharded",
    "render_tri_sharded",
    "scenes",
    "shard_target",
    "sphere_mesh",
]
