"""The port's CUDA kernel on the card, against its plain PyTorch version.

Marked ``cuda``: these skip where there is no GPU. They import nothing of
JAX, so on the machine with the card they run without the JAX package's
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: triangle/material ids exactly equal; RGBA atol 2e-4 (float32
shading, the same expressions; only sqrt/div/pow rounding may differ).
"""

import dataclasses

import pytest
import torch

from physically_based_renderer_tpu_torch import Camera, render, scenes
from physically_based_renderer_tpu_torch.ops import raster_row
from physically_based_renderer_tpu_torch.renderer import binning_params
from torch_parity import cuda_device, row_args  # noqa: F401  (fixture)

ATOL = 2e-4
W, H = 128, 64


def _grid(device="cpu"):
    scene = scenes.red_sphere_grid_scene(8, 4, device=device)
    return scene, Camera.create(position=(0.0, -3.0, -18.0), aspect=W / H, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("bins", ["render", "jumbo"])
def test_kernel_matches_plain_version(cuda_device, bins):
    scene, cam = _grid(cuda_device)
    args = row_args(scene, cam)
    kw = dict(width=W, height=H, tile_h=8, want_gbuf=True, num_materials=49, num_dir=4)
    kw.update(binning_params(args[0].shape[0], W, H) if bins == "render" else dict(max_span=2))
    before = raster_row.KERNEL_LAUNCHES
    out = raster_row.rasterize_binned_shade_row(*args, **kw)
    assert raster_row.KERNEL_LAUNCHES == before + 1
    ref = raster_row.rasterize_binned_shade_row(*(a.cpu() for a in args), **kw)
    assert torch.equal(out.tri_id.cpu(), ref.tri_id)
    assert torch.equal(out.mat_id.cpu(), ref.mat_id)
    torch.testing.assert_close(out.rgba.cpu(), ref.rgba, atol=ATOL, rtol=0)
    torch.testing.assert_close(out.gbuf.cpu(), ref.gbuf, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    scene, cam = _grid()
    ref = render(scene, cam, width=W, height=H)
    got = render(scene.to(cuda_device), cam.to(cuda_device), width=W, height=H)
    torch.testing.assert_close(got.cpu(), ref, atol=ATOL, rtol=0)
    band = render(scene.to(cuda_device), cam.to(cuda_device), width=W, height=H, rows=24, y_offset=20)
    torch.testing.assert_close(band.cpu(), ref[20:44], atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_render_on_card_refuses_gradients(cuda_device):
    scene, cam = _grid(cuda_device)
    mats = dataclasses.replace(scene.materials, roughness=scene.materials.roughness.requires_grad_())
    with pytest.raises(NotImplementedError, match="backward"):
        render(dataclasses.replace(scene, materials=mats), cam, width=W, height=H)
