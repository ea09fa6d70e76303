#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of JAX.
It builds ``physically_based_renderer_tpu_torch/csrc/raster_shade_row.cu``
and ``csrc/shade_backward.cu`` into ``build/kernels/`` (one nvcc each, in
parallel), then on the 1920×1080 frame of the 7×7 sphere grid
(``red_sphere_grid_scene(64, 32)``, 194,432 triangles, the ``bench.py``
camera):

  1. holds the kernel against its plain PyTorch version on the card at the
     main path's shapes (codes exact, RGBA within 2e-4, G-buffer within 1e-4,
     no binning overflow) and times both;
  2. times the frame's stages (setup+bin, kernel, compose) with CUDA events;
  3. renders 5 frames through ``render(...)`` and checks that each launched
     the kernel once; writes ``build/chip_smoke_grid.png``;
  4. checks a small frame against the CPU render (the plain version, which the
     CPU tests hold against the JAX package);
  5. holds the backward kernel against its plain version on the phase-1
     frame with the bench loss's cotangent (g_attrs/g_props within rtol 1e-3
     and 1e-6·max|value|, g_uni within rtol 1e-3, the material-table
     cotangent within what those imply summed over each material), checks
     that g_uni and the table are the same bits on two launches, and times
     the kernel, its plain version and the plain material scatter;
  6. runs 5 forward+backward steps of the bench loss (material gradients)
     through ``render``: each launches each kernel once, skips the geometry
     recompute, and gives finite gradients, the same bits every step; prints
     the step time;
  7. runs 5 ``make_train_step`` steps from a perturbed grid toward the
     original's render: the loss must fall;
  8. checks render gradients on the card (materials, light strength, eye,
     world matrices) against the CPU on a small frame.

Then the same grid under image-based lighting: a seeded 256×512 HDR
environment (a sky gradient and two sun lobes up to ~50), its IBL maps and a
seeded 1536×3072 u8 LDR background, which switch ``render`` to the fused IBL
path (both kernels' IBL modes, then the env gather):

  a. builds the IBL maps on the card, times the build, holds them against
     the CPU build;
  b. holds the forward kernel's IBL mode against its plain version at 1080p
     (codes exact, the 11 HDR channels within 2e-4 + 1e-4·|value|, G-buffer
     within 1e-4, no overflow) and times both;
  c. holds the adjoint's IBL mode against its plain version with the
     cotangent autograd gives through the env-gather epilogue (the bench loss
     over all four image channels, so every one of the 11 is nonzero): as
     phase 5, the 27 SH9 slots of g_uni included; same bits on two launches;
     times both;
  d. renders 5 IBL frames through ``render``: one IBL forward launch each,
     no adjoint; writes ``build/chip_smoke_grid_ibl.png``;
  e. runs 5 bench steps on the IBL frame: one launch of each IBL kernel a
     step, the same material-gradient bits every step;
  f. one step with the gradient to the environment map through the map
     build: finite, nonzero; its time and peak memory; whether two runs give
     the same bits;
  g. a 128×64 IBL frame on the card against the CPU: the image, and the
     gradients to materials, the specular stack, the SH9 coefficients and
     the environment map.

Every phase is a plain assertion; any failure exits non-zero. The last two
lines are a JSON summary of the kernels (both modes of each) and
``{"ok": true, "device": …}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
BWD_RTOL = 1e-3  # adjoint kernel vs autograd on the same inputs: f32 op order only
BWD_ATOL_FRAC = 1e-6  # absolute floor, as a share of the largest |value|; for g_uni it
# covers slots that cancel over the frame (the eye's x: the grid is mirror-symmetric)
TABLE_SUM_RTOL = 1e-5  # f32 sums in a fixed tree order, as a share of the sum of |terms|
GRAD_RTOL, GRAD_ATOL_FRAC = 2e-3, 5e-5  # card vs CPU gradients (the JAX suite's tolerance)
TRAIN_LR = 100.0  # SGD rate at which 5 steps lower the grid's loss (CPU rehearsal at 192×108)
IBL_ATOL, IBL_RTOL = 2e-4, 1e-4  # the IBL mode's HDR channels, kernel vs plain (up to ~1e3 at sun-lit highlights)
MAPS_RTOL, MAPS_ATOL_FRAC = 1e-4, 1e-5  # IBL maps, card vs CPU: f32 quadrature sums in another order
ENV_GRAD_ATOL_FRAC = 1e-4  # env-map gradients, card vs CPU (tests/test_raster_shade_ibl.py's)
IBL_IMAGE_ATOL = 5e-4  # the IBL frame, card vs CPU (tests/test_raster_shade_ibl.py's)


def seeded_env(seed: int, height: int, width: int):
    """An HDR equirect (H, W, 3) f32, the sIBL ``_Env.hdr`` convention: a
    smooth sky gradient plus two bright sun lobes (values up to ~50)."""
    import numpy as np

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


def seeded_background(seed: int, height: int, width: int):
    """An LDR equirect background (H, W, 3) in [0, 1]: a horizon gradient
    with texel noise, to be quantised to u8 like an sIBL ``_3k`` JPEG."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vv = ((np.arange(height) + 0.5) / height)[:, None, None]
    base = np.concatenate([0.35 + 0.5 * (1 - vv), 0.45 + 0.4 * (1 - vv), 0.55 + 0.4 * (1 - vv)], -1)
    return np.clip(base + rng.uniform(-0.08, 0.08, (height, width, 3)), 0.0, 1.0).astype(np.float32)


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


def close(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol_frac: float, name: str) -> float:
    """Assert |got − ref| ≤ atol_frac·max|ref| + rtol·|ref|; return the max abs error."""
    ref = ref.to(got.device, got.dtype)
    err = (got - ref).abs()
    bound = atol_frac * float(ref.abs().max()) + rtol * ref.abs()
    worst = float((err - bound).max()) if err.numel() else 0.0
    assert worst <= 0.0, f"{name}: max abs err {float(err.max()):.3e} exceeds its bound by {worst:.3e}"
    return float(err.max()) if err.numel() else 0.0


def bench_loss_grads(pbr, scene, cam, width, height, fields):
    """Gradients of mean(render[..., :3]²) w.r.t. ``fields`` (names of
    material fields, or "strength", "eye", "worlds")."""
    mats = {k: getattr(scene.materials, k).detach().clone().requires_grad_()
            for k in fields if hasattr(scene.materials, k)}
    leaves = dict(mats)
    lights, cam_ = scene.lights, cam
    draws = scene.draws
    if "strength" in fields:
        leaves["strength"] = lights.strength.detach().clone().requires_grad_()
        lights = dataclasses.replace(lights, strength=leaves["strength"])
    if "eye" in fields:
        leaves["eye"] = cam.position.detach().clone().requires_grad_()
        cam_ = dataclasses.replace(cam, position=leaves["eye"])
    if "worlds" in fields:
        leaves["worlds"] = draws[0].worlds.detach().clone().requires_grad_()
        draws = (dataclasses.replace(draws[0], worlds=leaves["worlds"]), *draws[1:])
    s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **mats),
                            lights=lights, draws=draws)
    loss = torch.mean(pbr.render(s, cam_, width=width, height=height)[..., :3] ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    # fields the render does not read (transmission, sheen, ...) get zeros, as in JAX
    return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                           for (k, t), g in zip(leaves.items(), grads)}


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
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.renderer import binning_params, compose
    from physically_based_renderer_tpu_torch.utils import cuda_build
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda_build.build_libraries(["raster_shade_row", "shade_backward"])
    raster_row.kernel_library()
    raster_pallas.kernel_library()
    print(f"build: raster_shade_row.cu + shade_backward.cu (parallel) {time.perf_counter() - t0:.2f} s")

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
    raster_pallas.SHADE_BWD_LAUNCHES = 0
    frame_times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
        end.record()
        torch.cuda.synchronize()
        frame_times.append(start.elapsed_time(end))
    fwd_launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    assert fwd_launches == (5, 0), fwd_launches
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

    # 5. Backward kernel against its plain version on the phase-1 frame, with
    #    the cotangent of the bench loss mean(img[..., :3]²).
    hit = code_k >= 0
    _, mat_id = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
    g_chan = torch.zeros_like(rgba_k)
    g_chan[..., :3] = torch.where(hit[..., None], 2.0 * rgba_k[..., :3] / (3 * WIDTH * HEIGHT), 0.0)
    attrs = gbuf_k[..., :6]  # the forward's (rows, W, 7) G-buffer, read with its stride
    bwd_kw = dict(num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
                  apply_tonemap=True)
    bwd_args = (g_chan, attrs, mat_id, hit, table, uni)
    got = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    ref = raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw)
    again = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    torch.cuda.synchronize()
    bwd_errs = [close(got[0], ref[0], BWD_RTOL, BWD_ATOL_FRAC, "g_attrs"),
                close(got[1], ref[1], BWD_RTOL, BWD_ATOL_FRAC, "g_props"),
                close(got[2], ref[2], BWD_RTOL, BWD_ATOL_FRAC, "g_uni")]
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3]), \
        "g_uni or the table cotangent differs between two launches"
    assert not got[0][~hit].any() and not got[1][~hit].any()
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    # The table cotangent the kernel sums itself: against float64 sums by
    # material of its own g_props (f32 summation order only), and against the
    # plain version's table within the bound the per-pixel tolerance implies.
    num_mats = table.shape[0]
    by_mat = lambda v: torch.zeros((num_mats, 9), dtype=torch.float64, device=dev).index_add_(
        0, mat_id[hit].long(), v[hit].double())
    own_err = (got[3].double() - by_mat(got[1])).abs()
    assert bool((own_err <= TABLE_SUM_RTOL * by_mat(got[1].abs())).all()), float(own_err.max())
    table_bound = (BWD_RTOL * by_mat(ref[1].abs())
                   + BWD_ATOL_FRAC * float(ref[1].abs().max()) * by_mat(torch.ones_like(ref[1]))
                   + TABLE_SUM_RTOL * by_mat(ref[1].abs()))
    table_err = (got[3].double() - ref[3].double()).abs()
    assert bool((table_err <= table_bound).all()), f"table cotangent: max abs err {float(table_err.max()):.3e}"
    bwd_errs.append(float(table_err.max()))
    bwd_err = max(bwd_errs)
    print(f"backward kernel vs plain: max abs err g_attrs {bwd_errs[0]:.3e}, g_props {bwd_errs[1]:.3e}, "
          f"g_uni {bwd_errs[2]:.3e} (|g_uni| max {float(ref[2].abs().max()):.3e}), table "
          f"{bwd_errs[3]:.3e} (|table| max {float(ref[3].abs().max()):.3e}; vs f64 of its own "
          f"g_props {float(own_err.max()):.3e})")
    bwd_ms = cuda_ms(lambda: raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw), 20)
    bwd_plain_ms = cuda_ms(lambda: raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw), 5, 1)
    g_props = ref[1]
    scatter_ms = cuda_ms(lambda: raster_pallas._scatter_props_by_id(g_props, mat_id, *table.shape), 20)
    print(f"shade backward at 1080p: kernel (table sum included) {bwd_ms:.3f} ms, plain version "
          f"{bwd_plain_ms:.3f} ms, of which the plain material scatter (bincount) {scatter_ms:.3f} ms "
          f"[{smi}]")

    # 6. The bench step: forward + backward of the bench loss at 1080p,
    #    material gradients only. Each step launches each kernel once.
    mat_fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
    bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)  # warm
    torch.cuda.synchronize()
    raster_row.KERNEL_LAUNCHES = 0
    raster_pallas.SHADE_BWD_LAUNCHES = 0
    geom_before = raster_pallas.GEOMETRY_RECOMPUTES
    step_ms, first = [], None
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert (raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES) == (i + 1, i + 1)
        first = first or grads
        assert all(torch.equal(grads[k], first[k]) for k in grads), "step gradients differ between steps"
    train_launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    assert raster_pallas.GEOMETRY_RECOMPUTES == geom_before, "material-only step ran the geometry VJP"
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["roughness"].abs().sum()) > 0 and float(grads["diffuse"].abs().sum()) > 0
    step_med = statistics.median(step_ms)
    print(f"bench step (fwd+bwd, material grads) at 1080p: median {step_med:.3f} ms over 5 "
          f"({WIDTH * HEIGHT / step_med / 1e3:.1f} Mpix/s), steps {[round(t, 3) for t in step_ms]}, "
          f"loss {float(loss):.6f}, launches fwd/bwd {train_launches} [{smi}]")

    # 7. The trainer: 5 SGD steps from perturbed materials toward the
    #    original's render.
    target = frame[..., :3].detach()
    gen = torch.Generator(device=dev).manual_seed(0)
    start = dataclasses.replace(
        mats,
        roughness=(mats.roughness + 0.3 * torch.rand(mats.roughness.shape, generator=gen, device=dev)
                   - 0.15).clamp(0.1, 1.0),
        diffuse=(mats.diffuse + 0.4 * torch.rand(mats.diffuse.shape, generator=gen, device=dev)
                 - 0.2).clamp(0.05, 1.0),
    )
    s = dataclasses.replace(scene, materials=start)
    step = pbr.make_train_step(width=WIDTH, height=HEIGHT, learning_rate=TRAIN_LR)
    raster_row.KERNEL_LAUNCHES = 0
    raster_pallas.SHADE_BWD_LAUNCHES = 0
    losses = []
    for _ in range(5):
        s, loss = step(s, cam, target)
        losses.append(float(loss))
    trainer_launches = raster_row.KERNEL_LAUNCHES, raster_pallas.SHADE_BWD_LAUNCHES
    assert trainer_launches == (5, 5), trainer_launches
    print(f"trainer, 5 SGD steps at 1080p (lr {TRAIN_LR}): losses {[f'{x:.4e}' for x in losses]}")
    assert all(math.isfinite(x) for x in losses) and losses[-1] < 0.5 * losses[0], losses
    rough_err0 = float((start.roughness - mats.roughness).abs().mean())
    rough_err = float((s.materials.roughness - mats.roughness).abs().mean())
    print(f"  mean |roughness − original|: {rough_err0:.4f} → {rough_err:.4f}")

    # 8. Gradients on the card against the CPU on the small frame.
    fields = ["diffuse", "roughness", "metallic", "fresnel_r0", "strength", "eye", "worlds"]
    _, g_cpu = bench_loss_grads(pbr, s_scene, s_cam, 128, 64, fields)
    _, g_dev = bench_loss_grads(pbr, s_scene.to(dev), s_cam.to(dev), 128, 64, fields)
    grad_errs = {k: close(g_dev[k], g_cpu[k], GRAD_RTOL, GRAD_ATOL_FRAC, k) for k in fields}
    print("128x64 gradients, card vs CPU, max abs err: "
          + ", ".join(f"{k} {v:.2e}" for k, v in grad_errs.items()))

    ibl_kernels = ibl_phases(pbr, scene, cam, dev, smi)

    print(json.dumps({"kernels": [{
        "name": "raster_shade_row",
        "route": "cuda",
        "source": "physically_based_renderer_tpu_torch/csrc/raster_shade_row.cu",
        "replaces": "physically_based_renderer_tpu/ops/raster_row.py:59",
        "launches": train_launches[0],
        "max_abs_err": rgba_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "shade_backward",
        "route": "cuda",
        "source": "physically_based_renderer_tpu_torch/csrc/shade_backward.cu",
        "replaces": "physically_based_renderer_tpu/ops/raster_pallas.py:1660",
        "launches": train_launches[1],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }, *ibl_kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def ibl_phases(pbr, grid, cam, dev, smi):
    """Phases a-g: the 1080p grid under IBL. Returns the JSON entries of the
    two kernels' IBL modes."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import ibl, raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.ops.sky import camera_ray_directions, sample_sky
    from physically_based_renderer_tpu_torch.ops.texture import sky_u8
    from physically_based_renderer_tpu_torch.ops.tonemap import tonemap
    from physically_based_renderer_tpu_torch.renderer import binning_params, compose_ibl
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    # a. The IBL maps, built on the card from the seeded env, against the CPU build.
    env_np = seeded_env(7, 256, 512)
    env = torch.as_tensor(env_np, device=dev)
    build_ms = cuda_ms(lambda: ibl.IBLMaps.build(env), 3, 1)
    maps = ibl.IBLMaps.build(env)
    t0 = time.perf_counter()
    maps_cpu = ibl.IBLMaps.build(torch.as_tensor(env_np))
    cpu_build_s = time.perf_counter() - t0
    map_errs = {}
    for name in ("irradiance", "specular_stack", "irradiance_sh9", "lut"):
        map_errs[name] = close(getattr(maps, name), getattr(maps_cpu, name), MAPS_RTOL, MAPS_ATOL_FRAC, name)
    for name in ("specular_stack_f16", "irradiance_f16"):  # one f16 ulp, relative
        map_errs[name] = close(getattr(maps, name).float(), getattr(maps_cpu, name).float(), 2.0**-10,
                               1e-6, name)
    assert float(maps.specular_stack.max()) > 5.0, "the sun lobes are missing from the maps"
    print(f"a. IBL maps from a 256x512 env on the card: build {build_ms:.3f} ms (CPU build {cpu_build_s:.2f} s); "
          "card vs CPU max abs err " + ", ".join(f"{k} {v:.2e}" for k, v in map_errs.items()) + f" [{smi}]")

    bg = sky_u8(seeded_background(8, 1536, 3072)).to(dev)
    scene = dataclasses.replace(grid, env_map=env, ibl=maps, sky_map=bg)
    mats, lights = scene.materials, scene.lights

    # b. The forward kernel's IBL mode against its plain version at 1080p.
    geom = pbr.flatten_scene_corners(scene)
    vp = cam.view_proj()
    clip = math3d.transform_points_h(geom.pos_w, vp)
    num_tris = geom.num_triangles
    mat_stride = raster_row.material_stride(mats.num_materials, num_tris)
    binned = raster_row.bin_for_shade(
        clip, geom.attrs, geom.face_material, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0,
        tile_h=8, tile_w=128, cull_backface=True, **binning_params(num_tris, WIDTH, HEIGHT),
    )
    assert not bool(binned.overflowed), "binning overflowed its pair cap"
    table = mats.props_table().contiguous()
    uni = pack_shading_uniforms(lights.strength, lights.direction, lights.position, lights.spot_power,
                                scene.ambient, cam.position, maps.irradiance_sh9)
    kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=8, tile_w=128, mat_stride=mat_stride,
              num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
              apply_tonemap=False, ibl=True)
    args = (binned.starts, binned.packed, binned.pair_tri, table, uni)
    code_k, chan_k, gbuf_k = raster_row.raster_shade_tiles_cuda(*args, want_gbuf=True, **kw)
    code_p, chan_p, gbuf_p = raster_row.raster_shade_tiles_plain(*args, want_gbuf=True, **kw)
    torch.cuda.synchronize()
    hit = code_k >= 0
    assert int((code_k != code_p).sum()) == 0, "IBL kernel codes differ from the plain version's"
    assert chan_k.shape == (HEIGHT, WIDTH, 11)
    assert not chan_k[~hit].any(), "the IBL kernel wrote a nonzero background channel"
    err = (chan_k - chan_p).abs()
    bound = IBL_ATOL + IBL_RTOL * chan_p.abs()
    assert bool((err <= bound).all()), f"IBL channels: max abs err {float(err.max()):.3e}"
    chan_err = float(err.max())
    gbuf_err = float((gbuf_k - gbuf_p).abs().max())
    assert gbuf_err <= GBUF_ATOL, gbuf_err
    per_ch = [f"{float(err[..., c].max()):.1e}" for c in range(11)]
    ibl_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw), 20)
    ibl_plain_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_plain(*args, want_gbuf=False, **kw), 3, 1)
    print(f"b. IBL forward kernel vs plain at 1080p: hit pixels {int(hit.sum())}, codes exact, channel max abs "
          f"err {chan_err:.3e} (per channel {per_ch}; |hdr| max {float(chan_p[..., :3].abs().max()):.2f}), "
          f"gbuf {gbuf_err:.3e}; kernel {ibl_ms:.3f} ms, plain version {ibl_plain_ms:.3f} ms [{smi}]")

    # c. The adjoint's IBL mode against its plain version, with the cotangent
    #    of the bench loss (all four image channels) through the epilogue.
    dirs = camera_ray_directions(math3d.inverse(vp), WIDTH, HEIGHT)
    chan_leaf = chan_k.detach().requires_grad_()
    img = compose_ibl(chan_leaf, code_k, scene, bg, dirs, True)
    (g_chan,) = torch.autograd.grad(torch.mean(img**2), chan_leaf)
    g_chan = torch.where(hit[..., None], g_chan, 0.0)
    assert bool(torch.isfinite(g_chan).all())
    nonzero = [bool(g_chan[..., c].any()) for c in range(11)]
    assert all(nonzero), f"cotangent channels all zero: {[c for c in range(11) if not nonzero[c]]}"
    _, mat_id = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
    bwd_kw = dict(num_dir=lights.num_dir, num_point=lights.num_point, num_spot=lights.num_spot,
                  apply_tonemap=False, ibl=True)
    bwd_args = (g_chan, gbuf_k[..., :6], mat_id, hit, table, uni)
    got = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    ref = raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw)
    again = raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw)
    torch.cuda.synchronize()
    errs = [close(got[0], ref[0], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_attrs"),
            close(got[1], ref[1], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_props"),
            close(got[2], ref[2], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_uni")]
    s0 = uni.shape[1] - 27
    sh_err = close(got[2][:, s0:], ref[2][:, s0:], BWD_RTOL, BWD_ATOL_FRAC, "IBL g_uni SH9 slots")
    # the spheres' albedo is pure red: the red slots carry the gradient, the others none
    g_sh9 = got[2][0, s0:].reshape(9, 3)
    assert bool((g_sh9[:, 0].abs() > 0).all()) and not g_sh9[:, 1:].any(), g_sh9
    assert torch.equal(again[2], got[2]) and torch.equal(again[3], got[3]), \
        "IBL g_uni or table cotangent differs between two launches"
    assert not got[0][~hit].any() and not got[1][~hit].any()
    num_mats = table.shape[0]
    by_mat = lambda v: torch.zeros((num_mats, 9), dtype=torch.float64, device=dev).index_add_(
        0, mat_id[hit].long(), v[hit].double())
    own_err = (got[3].double() - by_mat(got[1])).abs()
    assert bool((own_err <= TABLE_SUM_RTOL * by_mat(got[1].abs())).all()), float(own_err.max())
    table_bound = (BWD_RTOL * by_mat(ref[1].abs())
                   + BWD_ATOL_FRAC * float(ref[1].abs().max()) * by_mat(torch.ones_like(ref[1]))
                   + TABLE_SUM_RTOL * by_mat(ref[1].abs()))
    table_err = (got[3].double() - ref[3].double()).abs()
    assert bool((table_err <= table_bound).all()), f"IBL table cotangent: max abs err {float(table_err.max()):.3e}"
    errs.append(float(table_err.max()))
    bwd_ibl_err = max(errs)
    bwd_ibl_ms = cuda_ms(lambda: raster_pallas.shade_backward_cuda(*bwd_args, **bwd_kw), 20)
    bwd_ibl_plain_ms = cuda_ms(lambda: raster_pallas.shade_backward_plain(*bwd_args, **bwd_kw), 5, 1)
    print(f"c. IBL adjoint vs plain at 1080p: max abs err g_attrs {errs[0]:.3e}, g_props {errs[1]:.3e}, g_uni "
          f"{errs[2]:.3e} (SH9 slots {sh_err:.3e}; |g_sh9| max {float(ref[2][:, s0:].abs().max()):.3e}), table "
          f"{errs[3]:.3e}; kernel {bwd_ibl_ms:.3f} ms, plain version {bwd_ibl_plain_ms:.3f} ms [{smi}]")

    # d. Five IBL frames through render(): the IBL forward once each, no adjoint.
    frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
    torch.cuda.synchronize()
    counters = ("KERNEL_LAUNCHES", "IBL_KERNEL_LAUNCHES"), ("SHADE_BWD_LAUNCHES", "SHADE_BWD_IBL_LAUNCHES")

    def reset():
        for name in counters[0]:
            setattr(raster_row, name, 0)
        for name in counters[1]:
            setattr(raster_pallas, name, 0)

    def launches():  # (forward, forward IBL, adjoint, adjoint IBL)
        return (*(getattr(raster_row, n) for n in counters[0]), *(getattr(raster_pallas, n) for n in counters[1]))

    reset()
    frame_times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        frame = pbr.render(scene, cam, width=WIDTH, height=HEIGHT)
        end.record()
        torch.cuda.synchronize()
        frame_times.append(start.elapsed_time(end))
    assert launches() == (0, 5, 0, 0), launches()
    frame_ms = statistics.median(frame_times)
    epilogue_ms = cuda_ms(lambda: compose_ibl(chan_k, code_k, scene, bg, dirs, True), 10)
    assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
    assert float((frame - compose_ibl(chan_k, code_k, scene, bg, dirs, True)).abs().max()) == 0.0
    sky_bg = tonemap(sample_sky(bg, dirs))
    assert torch.equal(frame[~hit][:, :3], sky_bg[~hit]), "the background is not the sky"
    img = frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_grid_ibl.png"), img)
    fg = img[hit.cpu().numpy()][:, :3].mean(0)
    print(f"d. 5 IBL frames via render() at 1080p: median {frame_ms:.3f} ms "
          f"({WIDTH * HEIGHT / frame_ms / 1e3:.1f} Mpix/s forward), epilogue (env gather + sky + compose) "
          f"{epilogue_ms:.3f} ms; build/chip_smoke_grid_ibl.png foreground mean RGB {fg.round(4).tolist()}, "
          f"mean RGB {img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()} [{smi}]")
    assert fg[0] > fg[1] + 0.05 and fg[0] > fg[2] + 0.05, fg  # red spheres under a bluish sky

    # e. Five bench steps on the IBL frame: material gradients.
    mat_fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
    bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)  # warm
    torch.cuda.synchronize()
    reset()
    step_ms, first = [], None
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert launches() == (0, i + 1, 0, i + 1), launches()
        first = first or grads
        assert all(torch.equal(grads[k], first[k]) for k in grads), "IBL step gradients differ between steps"
    ibl_launches = launches()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["roughness"].abs().sum()) > 0 and float(grads["metallic"].abs().sum()) > 0
    step_med = statistics.median(step_ms)
    print(f"e. IBL bench step (fwd+bwd, material grads) at 1080p: median {step_med:.3f} ms over 5 "
          f"({WIDTH * HEIGHT / step_med / 1e3:.1f} Mpix/s), steps {[round(t, 3) for t in step_ms]}, "
          f"loss {float(loss):.6f}, launches (fwd, fwd IBL, bwd, bwd IBL) {ibl_launches} [{smi}]")

    # f. One step with the gradient to the environment map through the map build.
    def env_step():
        env_leaf = env.clone().requires_grad_()
        s = dataclasses.replace(scene, env_map=env_leaf).with_ibl()
        torch.mean(pbr.render(s, cam, width=WIDTH, height=HEIGHT)[..., :3] ** 2).backward()
        return env_leaf.grad

    env_step()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g_env = env_step()
    torch.cuda.synchronize()
    env_step_ms = (time.perf_counter() - t0) * 1e3
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    g_env2 = env_step()
    assert bool(torch.isfinite(g_env).all()) and float(g_env.abs().sum()) > 0
    print(f"f. env-map gradient step at 1080p (map build + frame + backward): {env_step_ms:.3f} ms, peak "
          f"{peak_mib:.1f} MiB above the scene; |grad| max {float(g_env.abs().max()):.3e}; same bits on a "
          f"second run: {torch.equal(g_env, g_env2)} [{smi}]")

    # g. A 128x64 IBL frame on the card against the CPU: image and gradients.
    s_grid = pbr.scenes.red_sphere_grid_scene(8, 4)
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64)
    s_env, s_bg = seeded_env(9, 16, 32), sky_u8(seeded_background(10, 24, 48))

    def small(device):
        e = torch.as_tensor(s_env, device=device).requires_grad_()
        s = dataclasses.replace(s_grid.to(device), env_map=e, sky_map=s_bg.to(device)).with_ibl()
        leaves = {k: getattr(s.materials, k).detach().clone().requires_grad_()
                  for k in ("diffuse", "roughness", "metallic", "fresnel_r0")}
        stack = s.ibl.specular_stack.detach().clone().requires_grad_()
        sh9 = s.ibl.irradiance_sh9.detach().clone().requires_grad_()
        s = dataclasses.replace(s, materials=dataclasses.replace(s.materials, **leaves),
                                ibl=dataclasses.replace(s.ibl, specular_stack=stack, irradiance_sh9=sh9))
        img = pbr.render(s, s_cam.to(device), width=128, height=64)
        torch.mean(img[..., :3] ** 2).backward()
        # the map leaves cut the build out of the frame: the env gradient goes
        # through a second frame that builds its maps
        s2 = dataclasses.replace(s_grid.to(device), env_map=e, sky_map=s_bg.to(device)).with_ibl()
        torch.mean(pbr.render(s2, s_cam.to(device), width=128, height=64)[..., :3] ** 2).backward()
        return img.detach(), {**{k: t.grad for k, t in leaves.items()}, "specular_stack": stack.grad,
                              "irradiance_sh9": sh9.grad, "env_map": e.grad}

    img_cpu, g_cpu = small("cpu")
    img_dev, g_dev = small(dev)
    img_err = float((img_dev.cpu() - img_cpu).abs().max())
    assert img_err <= IBL_IMAGE_ATOL, img_err
    env_like = ("specular_stack", "irradiance_sh9", "env_map")
    small_errs = {k: close(g_dev[k], g_cpu[k], GRAD_RTOL, ENV_GRAD_ATOL_FRAC if k in env_like else GRAD_ATOL_FRAC, k)
                  for k in g_cpu}
    print(f"g. 128x64 IBL frame, card vs CPU: image max abs err {img_err:.3e}; gradients max abs err "
          + ", ".join(f"{k} {v:.2e}" for k, v in small_errs.items()))

    return [{
        "name": "raster_shade_row_ibl",
        "route": "cuda",
        "source": "physically_based_renderer_tpu_torch/csrc/raster_shade_row.cu",
        "replaces": "physically_based_renderer_tpu/ops/raster_row.py:59",
        "launches": ibl_launches[1],
        "max_abs_err": chan_err,
        "ms": ibl_ms,
        "plain_ms": ibl_plain_ms,
    }, {
        "name": "shade_backward_ibl",
        "route": "cuda",
        "source": "physically_based_renderer_tpu_torch/csrc/shade_backward.cu",
        "replaces": "physically_based_renderer_tpu/ops/raster_pallas.py:1660",
        "launches": ibl_launches[3],
        "max_abs_err": bwd_ibl_err,
        "ms": bwd_ibl_ms,
        "plain_ms": bwd_ibl_plain_ms,
    }]


if __name__ == "__main__":
    sys.exit(main())
