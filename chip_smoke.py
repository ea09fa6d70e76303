#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of JAX.
It builds ``physically_based_renderer_tpu_torch/csrc/raster_shade_row.cu``
into ``build/kernels/``, then on the 1920×1080 frame of the 7×7 sphere grid
(``red_sphere_grid_scene(64, 32)``, 194,432 triangles, the ``bench.py``
camera):

  1. holds the kernel against its plain PyTorch version on the card at the
     main path's shapes (codes exact, RGBA within 2e-4, G-buffer within 1e-4,
     no binning overflow) and times both;
  2. times the frame's stages (setup+bin, kernel, compose) with CUDA events;
  3. renders 5 frames through ``render(...)`` and checks that each launched
     the kernel once; writes ``build/chip_smoke_grid.png``;
  4. checks a small frame against the CPU render (the plain version, which the
     CPU tests hold against the JAX package).

Every phase is a plain assertion; any failure exits non-zero. The last two
lines are a JSON summary of the kernels and ``{"ok": true, "device": …}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

WIDTH, HEIGHT = 1920, 1080
CAMERA_POS = (0.0, -3.0, -18.0)
RGBA_ATOL = 2e-4  # f32 shading, same expressions; sqrt/div/pow rounding only
GBUF_ATOL = 1e-4  # world positions ~10: a few f32 ulps
SMALL_ATOL = 2e-4  # card vs CPU on the small frame (the JAX parity tolerance)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # The clip transform is written as explicit f32 sums, but no matmul or
    # convolution on this path may run in TF32 either.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import physically_based_renderer_tpu_torch as pbr
    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.renderer import binning_params, compose
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    raster_row.kernel_library()
    print(f"build: raster_shade_row.cu {time.perf_counter() - t0:.2f} s")

    scene = pbr.scenes.red_sphere_grid_scene(64, 32, device=dev)
    cam = pbr.Camera.create(position=CAMERA_POS, aspect=WIDTH / HEIGHT, device=dev)
    mats, lights = scene.materials, scene.lights
    num_tris = sum(d.num_instances * d.mesh.num_triangles for d in scene.draws)
    assert num_tris == 194432, num_tris
    mat_stride = raster_row.material_stride(mats.num_materials, num_tris)
    assert mat_stride == 64, mat_stride
    params = binning_params(num_tris, WIDTH, HEIGHT)

    def setup_and_bin():
        geom = pbr.flatten_scene_corners(scene)
        clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
        binned = raster_row.bin_for_shade(
            clip, geom.attrs, geom.face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT,
            y_offset=0, tile_h=8, tile_w=128, cull_backface=True, **params,
        )
        return geom, binned

    geom, binned = setup_and_bin()
    table = mats.props_table().contiguous()
    uni = pack_shading_uniforms(
        lights.strength, lights.direction, lights.position, lights.spot_power,
        scene.ambient, cam.position,
    )
    kw = dict(
        width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=8, tile_w=128, mat_stride=mat_stride,
        num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
        apply_tonemap=True,
    )
    args = (binned.starts, binned.packed, binned.pair_tri, table, uni)

    # 1. Kernel against its plain version on the card, at the main path's shapes.
    assert not bool(binned.overflowed), "binning overflowed its pair cap"
    npairs = int(binned.starts[-1])
    code_k, rgba_k, gbuf_k = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=True, **kw)
    code_p, rgba_p, gbuf_p = raster_row.raster_shade_tiles_plain(*args, want_gbuf=True, **kw)
    code_k2, rgba_k2, _ = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw)
    torch.cuda.synchronize()
    hits = int((code_k >= 0).sum())
    code_mismatch = int((code_k != code_p).sum())
    rgba_err = float((rgba_k - rgba_p).abs().max())
    gbuf_err = float((gbuf_k - gbuf_p).abs().max())
    print(f"kernel vs plain: hit pixels {hits}, pairs {npairs} (jumbo {int(binned.starts[0])}), "
          f"code mismatches {code_mismatch}, rgba max abs err {rgba_err:.3e}, "
          f"gbuf max abs err {gbuf_err:.3e}")
    assert code_mismatch == 0
    assert torch.equal(code_k2, code_k) and torch.equal(rgba_k2, rgba_k)
    assert rgba_err <= RGBA_ATOL, rgba_err
    assert gbuf_err <= GBUF_ATOL, gbuf_err
    assert hits > 0.1 * WIDTH * HEIGHT, hits

    kernel_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw), 20)
    plain_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_plain(*args, want_gbuf=False, **kw), 3, 1)
    print(f"fused raster+shade step at 1080p: kernel {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms "
          f"[{smi}]")

    # 2. Stage times of the frame.
    setup_ms = cuda_ms(setup_and_bin, 10)

    def decode_and_compose():
        tri_id, _ = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
        return compose(rgba_k, tri_id, scene.clear_color)

    compose_ms = cuda_ms(decode_and_compose, 10)

    # 3. The main path: 5 frames through render(); each launches the kernel once.
    frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)  # warm
    torch.cuda.synchronize()
    raster_row.KERNEL_LAUNCHES = 0
    frame_times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
        end.record()
        torch.cuda.synchronize()
        frame_times.append(start.elapsed_time(end))
    launches = raster_row.KERNEL_LAUNCHES
    assert launches == 5, launches
    frame_ms = statistics.median(frame_times)
    print(f"stage medians at 1080p: setup+bin {setup_ms:.3f} ms, kernel {kernel_ms:.3f} ms, "
          f"compose {compose_ms:.3f} ms, whole frame via render() {frame_ms:.3f} ms "
          f"({WIDTH * HEIGHT / frame_ms / 1e3:.1f} Mpix/s forward) [{smi}]")

    assert frame.shape == (HEIGHT, WIDTH, 4) and frame.dtype == torch.float32
    assert bool(torch.isfinite(frame).all())
    assert float((frame - decode_and_compose()).abs().max()) == 0.0
    img = frame.cpu().numpy()
    os.makedirs("build", exist_ok=True)
    save_png(os.path.join("build", "chip_smoke_grid.png"), img)
    mean_rgb = img[..., :3].reshape(-1, 3).mean(0)
    print(f"build/chip_smoke_grid.png mean RGB {mean_rgb.round(4).tolist()}")
    # A red sweep over the 0.5-grey clear colour: red above the grey level,
    # green and blue below it.
    assert mean_rgb[0] > mean_rgb[1] + 0.02 and abs(mean_rgb[1] - mean_rgb[2]) < 1e-3, mean_rgb
    assert mean_rgb[1] < 0.5, mean_rgb

    # 4. A small frame on the card against the CPU render.
    small = dict(width=128, height=64)
    s_scene = pbr.scenes.red_sphere_grid_scene(8, 4)
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64)
    ref = pbr.render(s_scene, s_cam, **small)
    got = pbr.render(s_scene.to(dev), s_cam.to(dev), **small).cpu()
    small_err = float((got - ref).abs().max())
    print(f"128x64 frame, card vs CPU render: max abs err {small_err:.3e}")
    assert small_err <= SMALL_ATOL, small_err

    print(json.dumps({"kernels": [{
        "name": "raster_shade_row",
        "route": "cuda",
        "source": "physically_based_renderer_tpu_torch/csrc/raster_shade_row.cu",
        "replaces": "physically_based_renderer_tpu/ops/raster_row.py:59",
        "launches": launches,
        "max_abs_err": rgba_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
