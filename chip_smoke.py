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

Then the sharded paths (``parallel/sharded.py``), on the grid again, in a
world-1 NCCL process group (a ``FileStore`` under ``build/``):

  h. holds the G-buffer mode of the row kernel (``csrc/raster_shade_row.cu``,
     kernel 2) against its plain version at 1080p with the triangle-sharded
     ring's binning (8-row tiles, max span 16): the full frame over all
     triangles; a 270-row band at y_offset 540 (it ends in a partial tile)
     over the first quarter of the triangles, zero-padded; the C = 14
     instantiation on seeded 14-channel attributes; and a depth peel behind
     the first layer's depth (no back-face culling, so the second layer is
     the spheres' back faces). Codes exact, G-buffer within phase 1's 1e-4;
     times both;
  i. holds the G-buffer shading kernel (``csrc/shade_forward.cu``, kernel 6)
     against its plain version on phase h's full-frame G-buffer, in the shade
     mode and the IBL mode (a seeded SH9); times both;
  j. runs 5 bench steps through ``render_tri_sharded`` (material gradients):
     each launches kernels 2, 6 and 3 once, and the gradients are the same
     bits every step;
  k. measures ``bench.py``'s three overhead ratios at 1080p, each the ratio
     of two medians of 20 runs after a warm-up, the two sides interleaved run
     by run, with the quartiles of the run-by-run ratios as their spread:
     ``render_sharded`` over ``render``, ``make_train_step`` in the group
     over the plain step, ``render_tri_sharded`` over ``render``; and
     ``render`` alone before the group is made;
  l. a 128×64 frame on the card against the CPU through ``render_sharded``
     and ``render_tri_sharded``: the images and the material gradients.

Every phase is a plain assertion; any failure exits non-zero. The last two
lines are a JSON summary of the kernels (each mode of each; its launches on
its own main path, phase 6, e or j; its time beside the least time the H100
could take for the same work, ``bound_ms``) and ``{"ok": true, "device": …}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

WIDTH, HEIGHT = 1920, 1080
DEVICE = "cuda:0"
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
DEPTH_ATOL = 1e-6  # the G-buffer mode's NDC depth, kernel vs plain: the same plane, unfused
TRI_BINS = dict(tile_h=8, tile_w=128, max_span=16, pairs_cap=None, big_cap=None, big2_span=0, big2_cap=None)
RATIO_RUNS = 10  # runs per side per turn of phase k (two turns a side)
TEXTURE_SIZE = 512  # the seeded texture pages of phases m-r (bench.py's pbr configs)

# The least time the card could take for a kernel's work (the H100 SXM's
# published figures, at the 700 W limit): the
# larger of the bytes it must move (each input read once, each output
# written once) over the HBM rate and its FP32 operations over the FP32 rate.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# FP32 operations (multiplies, adds, subtracts, divides, square roots,
# powers; not compares), counted from the CUDA sources: a (pair, pixel)
# depth test of the raster loop (two offsets, three edge planes and the
# depth plane at four each).
RASTER_TEST_FLOPS = 18


def shade_flops(num_dir: int, num_point: int, num_spot: int, tonemap: bool, ibl: bool) -> int:
    """FP32 operations of one ``shade_core::shade`` call (csrc/shade_core.cuh):
    51 before the lights, 95 a directional light (+15 point, +22 spot), the
    ambient term and tonemap 15 (6 without), the IBL tail 162 instead."""
    lights = 95 * num_dir + 110 * num_point + 117 * num_spot
    return 51 + lights + (162 if ibl else 15 if tonemap else 6)


def plane_flops(num_ch: int, depth: bool) -> int:
    """FP32 operations of a winner's epilogue: the pixel offset, num_ch
    planes, the perspective divides (and the depth plane)."""
    return 2 + 4 * num_ch + (num_ch - 1) + (4 if depth else 0)


def raster_tests(starts: torch.Tensor, npix: int) -> int:
    """(pair, pixel) depth tests the raster loop runs: every tile takes the
    jumbo run and its own run against each of its pixels."""
    ntiles = starts.shape[0] - 1
    return (ntiles * int(starts[0]) + int(starts[-1]) - int(starts[0])) * npix


def ptxas_summary(log: str) -> list[str]:
    """'kernel<template args>: N registers, S B spill stores' for each entry
    function of an nvcc -Xptxas=-v log."""

    def demangle(sym: str) -> str:  # _ZN <len><id>... [I L<type><value>E ... E] E
        i, ids = 3, []
        while i < len(sym) and sym[i].isdigit():
            n = re.match(r"\d+", sym[i:]).group()
            ids.append(sym[i + len(n) : i + len(n) + int(n)])
            i += len(n) + int(n)
        args = re.findall(r"L[a-z](\d+)E", sym[i:]) if sym[i : i + 1] == "I" else []
        return ids[-1] + (f"<{','.join(args)}>" if args else "")

    out, name, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_ZN\w+)'", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores")
            name = None
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def raster_read_bytes(starts, packed, pair_tri, *, num_ch: int, width: int, rows: int, y_offset: int,
                      tile_h: int, tile_w: int, z_floor=None, **_) -> int:
    """Bytes a raster kernel must read for this run's binning, each once: the
    tile starts; the RASTER_FIELDS depth-test fields and the triangle id of
    each real pair (``packed`` and ``pair_tri`` are padded to the pair cap,
    and no losing pair's other fields are needed); the z floor when given;
    and the material field and num_ch interpolation planes (3 floats each)
    of each distinct winning pair, found by the plain version's resolve."""
    from physically_based_renderer_tpu_torch.ops import raster_row
    from physically_based_renderer_tpu_torch.ops.raster_bin import RASTER_FIELDS

    res = raster_row._resolve_plain(starts, packed, pair_tri, width=width, rows=rows, y_offset=y_offset,
                                    tile_h=tile_h, tile_w=tile_w, z_floor=z_floor)
    winners = int(res.pair.unique().numel())
    floor = 0 if z_floor is None else nbytes(z_floor)
    return nbytes(starts) + floor + 4 * (int(starts[-1]) * (RASTER_FIELDS + 1) + winners * (1 + 3 * num_ch))


def bound(moved_bytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time for the work, and which
    of the two sets it."""
    t_bytes = moved_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd) -> dict:
    """One kernel of the summary line. No single PyTorch call computes any
    of these functions (a tile raster with a quantized depth resolve, or a
    Cook-Torrance shade and its adjoint), so ``library_ms`` is null."""
    return {"name": name, "route": "cuda", "source": f"physically_based_renderer_tpu_torch/csrc/{source}",
            "replaces": f"physically_based_renderer_tpu/{replaces}", "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


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


def _seeded_field(rng, size: int, channels: int):
    """(size, size, channels) smooth fields in about [−1, 1]: three random
    sinusoids a channel at integer frequencies 1-4 (so the field tiles, as
    the wrap sampler expects, and its mip levels keep structure)."""
    import numpy as np

    yy, xx = (np.mgrid[0:size, 0:size] + 0.5) / size
    out = np.zeros((size, size, channels))
    for c in range(channels):
        for _ in range(3):
            kx, ky = rng.integers(1, 5, 2)
            out[..., c] += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * (kx * xx + ky * yy) + rng.uniform(0, 2 * np.pi))
    return out / 3.0


def seeded_texture_pages(seed: int, size: int, alpha: bool = False) -> dict:
    """Texture pages from a seed, in place of the absent asset files: one
    (size, size, 3) uint8 image (quantised as a decoded JPEG is) for each
    (set, slot) the textured spheres of ``scenes.TEXTURED_SPHERES`` bind, in
    that order. Colour and scalar maps are smooth fields in [0.1, 0.9];
    normal maps decode (2·v − 1) to unit vectors within ~17° of +z. With
    ``alpha``, one more page, ("rusted_iron", "opacity"): bands of opacity 0
    and 1 with smooth edges, for the alpha test."""
    import numpy as np

    from physically_based_renderer_tpu_torch.scenes import TEXTURED_SPHERES

    rng = np.random.default_rng(seed)
    keys = [(set_name, slot) for set_name, slots, _ in TEXTURED_SPHERES.values() for slot in slots]
    pages = {}
    for key in keys + ([("rusted_iron", "opacity")] if alpha else []):
        field = _seeded_field(rng, size, 3)
        if key[1] == "normal":
            v = np.concatenate([0.3 * field[..., :2], np.ones_like(field[..., :1])], axis=-1)
            img = 0.5 + 0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
        elif key[1] == "opacity":
            img = np.repeat(np.clip(0.5 + 4.0 * field[..., :1], 0.0, 1.0), 3, axis=-1)
        else:
            img = 0.5 + 0.4 * field
        pages[key] = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return pages


def fill_asset_cache(cache, pages: dict):
    """Pre-populate an ``AssetCache`` (the port's or the JAX package's) with
    ``pages`` as its decoded images, as ``obj_scene`` does; returns it."""
    for (set_name, slot), img in pages.items():
        cache._page_index[f"{set_name}/{slot}"] = len(cache.pages)
        cache.pages.append(img)
        cache.srgb.append(slot in ("diffuse", "specular"))
    return cache


def alpha_test_fields(materials, cache, index: int = 0) -> dict:
    """The bank fields (NumPy) that make material ``index`` of ``materials``
    (either package's bank) alpha-tested through the cache's ("rusted_iron",
    "opacity") page: ``has_tex``, ``tex_index`` and ``alpha_test``."""
    import numpy as np

    slot = 11  # SLOT_OPACITY
    has = np.array(materials.has_tex.cpu() if hasattr(materials.has_tex, "cpu") else materials.has_tex)
    tex = np.array(materials.tex_index.cpu() if hasattr(materials.tex_index, "cpu") else materials.tex_index)
    at = np.array(materials.alpha_test.cpu() if hasattr(materials.alpha_test, "cpu") else materials.alpha_test)
    has[index, slot], tex[index, slot], at[index] = 1.0, cache._page_index["rusted_iron/opacity"], 1.0
    return dict(has_tex=has, tex_index=tex, alpha_test=at)


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


def bench_loss_grads(pbr, scene, cam, width, height, fields, render=None):
    """Gradients of mean(render[..., :3]²) w.r.t. ``fields`` (names of
    material fields, or "strength", "eye", "worlds"); ``render`` defaults to
    ``pbr.render``."""
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
    loss = torch.mean((render or pbr.render)(s, cam_, width=width, height=height)[..., :3] ** 2)
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
    dev = torch.device(DEVICE)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = cuda_build.build_libraries(["raster_shade_row", "shade_backward", "shade_forward"])
    raster_row.kernel_library()
    raster_pallas.kernel_library()
    raster_pallas.shade_forward_library()
    print(f"build: raster_shade_row.cu + shade_backward.cu + shade_forward.cu (parallel) "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"ptxas, {name}.cu: " + "; ".join(ptxas_summary(log)))

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
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    k1_bound = bound(raster_read_bytes(*args[:3], num_ch=7, **kw) + nbytes(table, uni, code_k2, rgba_k2),
                     raster_tests(binned.starts, 8 * 128) * RASTER_TEST_FLOPS
                     + hits * (plane_flops(7, False) + shade_flops(*counts, True, False)))
    print(f"fused raster+shade step at 1080p: kernel {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, "
          f"bound {k1_bound[0]:.4f} ms ({k1_bound[1]}) [{smi}]")

    # 2. Stage times of the frame.
    setup_ms = cuda_ms(setup_and_bin, 10)

    def decode_and_compose():
        tri_id, _ = raster_row.decode_codes(code_k, mat_stride, geom.face_material)
        return compose(rgba_k, tri_id >= 0, scene.clear_color)

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
    s_scene = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
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
    # two forward shades and the adjoint's ~3x per hit pixel (csrc/shade_backward.cu)
    k3_bound = bound(nbytes(g_chan, attrs, mat_id, hit, table, uni, *got),
                     hits * 5 * shade_flops(*counts, True, False))
    print(f"shade backward at 1080p: kernel (table sum included) {bwd_ms:.3f} ms, plain version "
          f"{bwd_plain_ms:.3f} ms, of which the plain material scatter (bincount) {scatter_ms:.3f} ms, "
          f"bound {k3_bound[0]:.4f} ms ({k3_bound[1]}) [{smi}]")

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
    sharded_kernels = sharded_phases(pbr, scene, cam, dev, smi)
    textured_kernels = textured_phases(pbr, dev, smi, [line for log in logs.values() for line in ptxas_summary(log)])

    print(json.dumps({"kernels": [
        kernel_entry("raster_shade_row", "raster_shade_row.cu", "ops/raster_row.py:59", train_launches[0],
                     rgba_err, kernel_ms, plain_ms, k1_bound),
        kernel_entry("shade_backward", "shade_backward.cu", "ops/raster_pallas.py:1660", train_launches[1],
                     bwd_err, bwd_ms, bwd_plain_ms, k3_bound),
        *ibl_kernels, *sharded_kernels, *textured_kernels,
    ]}))
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
    from physically_based_renderer_tpu_torch.renderer import background, binning_params, compose_ibl
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
    tol = IBL_ATOL + IBL_RTOL * chan_p.abs()
    assert bool((err <= tol).all()), f"IBL channels: max abs err {float(err.max()):.3e}"
    chan_err = float(err.max())
    gbuf_err = float((gbuf_k - gbuf_p).abs().max())
    assert gbuf_err <= GBUF_ATOL, gbuf_err
    per_ch = [f"{float(err[..., c].max()):.1e}" for c in range(11)]
    ibl_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_cuda(*args, want_gbuf=False, **kw), 20)
    ibl_plain_ms = cuda_ms(lambda: raster_row.raster_shade_tiles_plain(*args, want_gbuf=False, **kw), 3, 1)
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    hits = int(hit.sum())
    k1b_bound = bound(raster_read_bytes(*args[:3], num_ch=7, **kw) + nbytes(table, uni, code_k, chan_k),
                      raster_tests(binned.starts, 8 * 128) * RASTER_TEST_FLOPS
                      + hits * (plane_flops(7, False) + shade_flops(*counts, False, True)))
    print(f"b. IBL forward kernel vs plain at 1080p: hit pixels {int(hit.sum())}, codes exact, channel max abs "
          f"err {chan_err:.3e} (per channel {per_ch}; |hdr| max {float(chan_p[..., :3].abs().max()):.2f}), "
          f"gbuf {gbuf_err:.3e}; kernel {ibl_ms:.3f} ms, plain version {ibl_plain_ms:.3f} ms, bound "
          f"{k1b_bound[0]:.4f} ms ({k1b_bound[1]}) [{smi}]")

    # c. The adjoint's IBL mode against its plain version, with the cotangent
    #    of the bench loss (all four image channels) through the epilogue.
    dirs = camera_ray_directions(math3d.inverse(vp), WIDTH, HEIGHT)
    sky_bg = background(scene, vp, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0, apply_tonemap=True)
    assert torch.equal(sky_bg, tonemap(sample_sky(bg, dirs))), "the background is not the sky"
    chan_leaf = chan_k.detach().requires_grad_()
    img = compose_ibl(chan_leaf, code_k, scene, sky_bg, True)
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
    k3b_bound = bound(nbytes(*bwd_args, *got), hits * 5 * shade_flops(*counts, False, True))
    print(f"c. IBL adjoint vs plain at 1080p: max abs err g_attrs {errs[0]:.3e}, g_props {errs[1]:.3e}, g_uni "
          f"{errs[2]:.3e} (SH9 slots {sh_err:.3e}; |g_sh9| max {float(ref[2][:, s0:].abs().max()):.3e}), table "
          f"{errs[3]:.3e}; kernel {bwd_ibl_ms:.3f} ms, plain version {bwd_ibl_plain_ms:.3f} ms, bound "
          f"{k3b_bound[0]:.4f} ms ({k3b_bound[1]}) [{smi}]")

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
    epilogue = lambda: compose_ibl(chan_k, code_k, scene, background(
        scene, vp, width=WIDTH, height=HEIGHT, rows=HEIGHT, y_offset=0, apply_tonemap=True), True)
    epilogue_ms = cuda_ms(epilogue, 10)
    assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
    assert float((frame - epilogue()).abs().max()) == 0.0
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
    s_grid = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
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

    return [
        kernel_entry("raster_shade_row_ibl", "raster_shade_row.cu", "ops/raster_row.py:59", ibl_launches[1],
                     chan_err, ibl_ms, ibl_plain_ms, k1b_bound),
        kernel_entry("shade_backward_ibl", "shade_backward.cu", "ops/raster_pallas.py:1660", ibl_launches[3],
                     bwd_ibl_err, bwd_ibl_ms, bwd_ibl_plain_ms, k3b_bound),
    ]


def world_of_one(dev: torch.device) -> None:
    """A one-process group for the sharded paths: NCCL on the card (gloo for
    CPU tensors), its store a file under build/ (no sockets)."""
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_world1.store")
    if os.path.exists(path):
        os.remove(path)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)


def wall_ms(fns: dict, runs: int = RATIO_RUNS) -> dict:
    """Host-clock ms of 2·``runs`` runs of each function (work ending in a
    synchronize), after two warm-up runs each, interleaved run by run in
    alternating order (a b, b a, a b, ...): a drift of the shared host's
    speed falls on both sides alike."""
    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(2 * runs):
        for k in keys if i % 2 == 0 else keys[::-1]:
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def overhead(times: dict, plain: str, sharded: str) -> tuple[float, float, float]:
    """(median sharded / median plain, the quartiles of the run-by-run
    ratios): the ratio and its spread."""
    q = statistics.quantiles([b / a for a, b in zip(times[plain], times[sharded])], n=4)
    return statistics.median(times[sharded]) / statistics.median(times[plain]), q[0], q[2]


def sharded_phases(pbr, scene, cam, dev, smi):
    """Phases h-l: the sharded paths on the 1080p grid. Returns the JSON
    entries of kernels 2 and 6."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.shade_core import pack_shading_uniforms
    from physically_based_renderer_tpu_torch.parallel import sharded

    mats, lights = scene.materials, scene.lights
    counts = (lights.num_dir, lights.num_point, lights.num_spot)
    geom = pbr.flatten_scene_corners(scene)
    clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
    fm = geom.face_material

    # h. Kernel 2 against its plain version.
    def gbuffer_case(name, clip, attrs, fm, rows=HEIGHT, y_offset=0, z_floor=None, cull=True):
        binned = raster_row.bin_for_shade(clip, attrs, fm, width=WIDTH, height=HEIGHT, rows=rows,
                                          y_offset=y_offset, cull_backface=cull, **TRI_BINS)
        assert not bool(binned.overflowed), f"{name}: binning overflowed its pair cap"
        kw = dict(width=WIDTH, rows=rows, y_offset=y_offset, tile_h=8, tile_w=128, z_floor=z_floor,
                  mat_stride=raster_row.material_stride(mats.num_materials, clip.shape[0]),
                  num_ch=attrs.shape[-1] + 1)
        args = (binned.starts, binned.packed, binned.pair_tri)
        code_k, gb_k = raster_row.raster_gbuffer_tiles_cuda(*args, **kw)
        code_p, gb_p = raster_row.raster_gbuffer_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        assert int((code_k != code_p).sum()) == 0, f"{name}: G-buffer codes differ from the plain version's"
        attr_err = float((gb_k[..., :-1] - gb_p[..., :-1]).abs().max())
        depth_err = float((gb_k[..., -1] - gb_p[..., -1]).abs().max())
        assert attr_err <= GBUF_ATOL and depth_err <= DEPTH_ATOL, (name, attr_err, depth_err)
        hits = int((code_k >= 0).sum())
        assert not gb_k[code_k < 0].any(), f"{name}: nonzero background"
        print(f"h. {name}: {rows}x{WIDTH} at y_offset {y_offset}, {clip.shape[0]} triangles, C = "
              f"{attrs.shape[-1]}: hit pixels {hits}, pairs {int(binned.starts[-1])}, codes exact, attrs max abs "
              f"err {attr_err:.3e}, depth {depth_err:.3e}")
        return dict(args=args, kw=kw, code=code_k, gbuf=gb_k, hits=hits, err=max(attr_err, depth_err))

    full = gbuffer_case("full frame", clip, geom.attrs, fm)
    quarter = sharded.triangle_shard(scene, cam, 0, 4)
    pad = -(-quarter.clip.shape[0] // 1024) * 1024 - quarter.clip.shape[0]
    padded = [torch.nn.functional.pad(t, (0,) * (2 * (t.ndim - 1)) + (0, pad))
              for t in (quarter.clip, quarter.attrs, quarter.face_material)]
    band = gbuffer_case(f"band over the first quarter of the triangles + {pad} zero rows", *padded,
                        rows=HEIGHT // 4, y_offset=HEIGHT // 2)
    gen = torch.Generator(device=dev).manual_seed(14)
    extra = torch.randn((geom.num_triangles, 3, 8), generator=gen, device=dev)
    c14 = gbuffer_case("C = 14, seeded attributes", clip, torch.cat([geom.attrs, extra], dim=-1), fm)
    first = gbuffer_case("first layer, no culling", clip, geom.attrs, fm, cull=False)
    z_floor = torch.where(first["code"] >= 0, first["gbuf"][..., -1], -torch.inf).contiguous()
    peel = gbuffer_case("peel behind the first layer", clip, geom.attrs, fm, z_floor=z_floor, cull=False)
    peeled = peel["code"] >= 0
    assert peel["hits"] > 0.5 * first["hits"], "the peel found no back faces"
    assert bool((peel["gbuf"][..., -1][peeled] > z_floor[peeled]).all())
    k2_err = max(c["err"] for c in (full, band, c14, first, peel))
    k2_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_cuda(*full["args"], **full["kw"]), 20)
    k2_plain_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_plain(*full["args"], **full["kw"]), 3, 1)
    k2_c14_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_cuda(*c14["args"], **c14["kw"]), 20)
    k2_bound = bound(raster_read_bytes(*full["args"], **full["kw"]) + nbytes(full["code"], full["gbuf"]),
                     raster_tests(full["args"][0], 8 * 128) * RASTER_TEST_FLOPS
                     + full["hits"] * plane_flops(7, True))
    print(f"h. G-buffer kernel at 1080p (full frame, C = 6): kernel {k2_ms:.3f} ms, plain version "
          f"{k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); C = 14 kernel {k2_c14_ms:.3f} ms; "
          f"max abs err {k2_err:.3e} [{smi}]")

    # i. Kernel 6 against its plain version on the full frame's G-buffer, both modes.
    hit = full["code"] >= 0
    _, mat_id = raster_row.decode_codes(full["code"], full["kw"]["mat_stride"], fm)
    attrs = full["gbuf"][..., :6]  # the (rows, W, 7) G-buffer, read with its stride
    table = mats.props_table().contiguous()
    sh9 = torch.as_tensor(np.random.default_rng(9).normal(0.0, 0.3, (9, 3)).astype(np.float32), device=dev)
    k6 = {}
    for ibl in (False, True):
        uni = pack_shading_uniforms(lights.strength, lights.direction, lights.position, lights.spot_power,
                                    scene.ambient, cam.position, sh9 if ibl else None)
        args = (attrs, mat_id, hit, table, uni)
        kw = dict(num_dir=counts[0], num_point=counts[1], num_spot=counts[2], ibl=ibl)
        got = raster_pallas.shade_forward_cuda(*args, **kw)
        ref = raster_pallas.shade_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = IBL_ATOL + IBL_RTOL * ref.abs() if ibl else RGBA_ATOL
        assert bool((err <= tol).all()), f"shade_forward (ibl={ibl}): max abs err {float(err.max()):.3e}"
        assert not got[~hit].any() and bool(torch.isfinite(got).all())
        ms = cuda_ms(lambda: raster_pallas.shade_forward_cuda(*args, **kw), 20)
        plain = cuda_ms(lambda: raster_pallas.shade_forward_plain(*args, **kw), 3, 1)
        k6[ibl] = dict(err=float(err.max()), ms=ms, plain_ms=plain, bound=bound(
            nbytes(*args, got), int(hit.sum()) * shade_flops(*counts, not ibl, ibl)))
        print(f"i. G-buffer shading kernel ({'IBL' if ibl else 'shade'} mode) vs plain at 1080p: max abs err "
              f"{k6[ibl]['err']:.3e}; kernel {ms:.3f} ms, plain version {plain:.3f} ms, bound "
              f"{k6[ibl]['bound'][0]:.4f} ms ({k6[ibl]['bound'][1]}) [{smi}]")

    frame = lambda fn: (lambda: fn(scene, cam, width=WIDTH, height=HEIGHT))
    solo = statistics.median(wall_ms({"render": frame(pbr.render)})["render"])  # before the group exists
    world_of_one(dev)
    try:
        # j. The triangle-sharded bench step: material gradients through render_tri_sharded.
        counters = ((raster_row, "GBUF_KERNEL_LAUNCHES"), (raster_pallas, "SHADE_FWD_LAUNCHES"),
                    (raster_pallas, "SHADE_BWD_LAUNCHES"), (raster_row, "KERNEL_LAUNCHES"))
        mat_fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
        step = lambda: bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, mat_fields, pbr.render_tri_sharded)
        step()  # warm
        torch.cuda.synchronize()
        for mod, name in counters:
            setattr(mod, name, 0)
        step_ms, first_grads = [], None
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = tuple(getattr(mod, name) for mod, name in counters)
            assert launches == (i + 1, i + 1, i + 1, 0), launches
            first_grads = first_grads or grads
            assert all(torch.equal(grads[k], first_grads[k]) for k in grads), "tri-sharded gradients differ"
        tri_launches = launches
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        assert float(grads["roughness"].abs().sum()) > 0 and float(grads["diffuse"].abs().sum()) > 0
        print(f"j. tri-sharded bench step (world of 1, NCCL) at 1080p: median {statistics.median(step_ms):.3f} ms "
              f"over 5, steps {[round(t, 3) for t in step_ms]}, loss {float(loss):.6f}; launches over the 5 "
              f"steps (G-buffer, G-buffer shading, adjoint, fused forward) {tri_launches} [{smi}]")

        # k. bench.py's three overhead ratios, the two sides interleaved run by run.
        fwd = wall_ms({"render": frame(pbr.render), "render_sharded": frame(pbr.render_sharded)})
        tri = wall_ms({"render": frame(pbr.render), "render_tri_sharded": frame(pbr.render_tri_sharded)})
        target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
        sh_step = pbr.make_train_step(width=WIDTH, height=HEIGHT, learning_rate=0.1)  # the world-1 group

        def plain_step():  # bench.py's plain step: the loss, its material gradients, the SGD update
            params = {k: getattr(mats, k).detach().requires_grad_() for k in mat_fields}
            s = dataclasses.replace(scene, materials=dataclasses.replace(mats, **params))
            loss = torch.mean((pbr.render(s, cam, width=WIDTH, height=HEIGHT)[..., :3] - target) ** 2)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            new = {k: p.detach() if g is None else p.detach() - 0.1 * g for (k, p), g in zip(params.items(), grads)}
            return dataclasses.replace(mats, **new), loss.detach()

        train = wall_ms({"plain step": plain_step, "make_train_step": lambda: sh_step(scene, cam, target)})
        pairs = {"sharded_overhead_1chip": (fwd, "render", "render_sharded"),
                 "sharded_train_overhead_1chip": (train, "plain step", "make_train_step"),
                 "tri_sharded_overhead_1chip": (tri, "render", "render_tri_sharded")}
        ratios = {k: overhead(*p) for k, p in pairs.items()}
        print(f"k. overhead ratios at 1080p (world of 1, NCCL; {2 * RATIO_RUNS} runs a side, interleaved; medians, ms; "
              f"render before the group existed {solo:.3f}): "
              + "; ".join(f"{k} {ratios[k][0]:.4f} = {s} {statistics.median(t[s]):.3f} / {p} "
                          f"{statistics.median(t[p]):.3f} (run-by-run quartiles {ratios[k][1]:.4f}-{ratios[k][2]:.4f})"
                          for k, (t, p, s) in pairs.items()) + f" [{smi}]")
        assert all(math.isfinite(v[0]) and v[0] > 0 for v in ratios.values())

        # l. A 128x64 frame on the card against the CPU through both sharded renders.
        s_grid = pbr.scenes.red_sphere_grid_scene(8, 4, device="cpu")
        s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
        fields = ["diffuse", "roughness", "metallic", "fresnel_r0"]
        errs = {}
        for fn in (pbr.render_sharded, pbr.render_tri_sharded):
            img_cpu = fn(s_grid, s_cam, width=128, height=64)
            img_dev = fn(s_grid.to(dev), s_cam.to(dev), width=128, height=64).cpu()
            img_err = float((img_dev - img_cpu).abs().max())
            assert img_err <= SMALL_ATOL, (fn.__name__, img_err)
            _, g_cpu = bench_loss_grads(pbr, s_grid, s_cam, 128, 64, fields, fn)
            _, g_dev = bench_loss_grads(pbr, s_grid.to(dev), s_cam.to(dev), 128, 64, fields, fn)
            errs[fn.__name__] = [img_err] + [close(g_dev[k], g_cpu[k], GRAD_RTOL, GRAD_ATOL_FRAC, k) for k in fields]
        print("l. 128x64 frame, card vs CPU, max abs err (image, then material gradients): "
              + "; ".join(f"{k} {[f'{e:.2e}' for e in v]}" for k, v in errs.items()))
    finally:
        dist.destroy_process_group()

    return [
        kernel_entry("raster_gbuffer_row", "raster_shade_row.cu", "ops/raster_row.py:59", tri_launches[0],
                     k2_err, k2_ms, k2_plain_ms, k2_bound),
        kernel_entry("shade_forward", "shade_forward.cu", "ops/raster_pallas.py:1469", tri_launches[1],
                     k6[False]["err"], k6[False]["ms"], k6[False]["plain_ms"], k6[False]["bound"]),
    ]


def textured_phases(pbr, dev, smi, ptxas):
    """Phases m-r: the textured deferred path at 1080p (seeded pages in
    place of the absent asset files). Returns the JSON entry of kernel 4."""
    import numpy as np

    from physically_based_renderer_tpu_torch import math3d
    from physically_based_renderer_tpu_torch.ops import raster_pallas, raster_row
    from physically_based_renderer_tpu_torch.ops.texture import sky_u8
    from physically_based_renderer_tpu_torch.renderer import binning_params
    from physically_based_renderer_tpu_torch.utils.image_io import save_png

    def v1_binning(scene, cam, z_floor=None):
        """Kernel 4's inputs for ``render``'s textured frame: the v1 binning
        at 1080p (16×128 tiles), as ``render`` bins it."""
        geom = pbr.flatten_scene_corners(scene, textured=True)
        clip = math3d.transform_points_h(geom.pos_w, cam.view_proj())
        params = binning_params(geom.num_triangles, WIDTH, HEIGHT, row_layout=False)
        binned = raster_row.bin_for_shade(clip, geom.attrs, geom.face_material, width=WIDTH, height=HEIGHT,
                                          rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, cull_backface=True,
                                          **params)
        assert not bool(binned.overflowed), "binning overflowed its pair cap"
        kw = dict(width=WIDTH, rows=HEIGHT, y_offset=0, tile_h=16, tile_w=128, num_ch=15, z_floor=z_floor,
                  mat_stride=raster_row.material_stride(scene.materials.num_materials, geom.num_triangles))
        return geom, params, binned, kw

    def textured_scene(make_scene, cache, mode, **kw):
        s = make_scene(cache, texture_size=TEXTURE_SIZE, device=dev, **kw)
        return s.with_combined_textures(mode=mode)

    def frame_ms(fn, n=5):
        times = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), times, out

    def bench_steps(scene, cam, counters, n=5, texel=None):
        """``n`` bench steps (material gradients, or the gradient to the
        quad pages with ``texel``): their host-clock ms, the peak memory
        above the scene, whether every step gave the same gradient bits,
        and the launches of each counter over the ``n`` steps."""
        fields = [k for k in scene.materials.tensor_fields() if getattr(scene.materials, k).is_floating_point()]

        def step():
            if texel is None:
                return bench_loss_grads(pbr, scene, cam, WIDTH, HEIGHT, fields)[1]
            pages = scene.combined_atlas.pages.detach().clone().requires_grad_()
            s = dataclasses.replace(scene, combined_atlas=dataclasses.replace(scene.combined_atlas, pages=pages))
            loss = torch.mean(pbr.render(s, cam, width=WIDTH, height=HEIGHT, mip_lod=False)[..., :3] ** 2)
            return {"pages": torch.autograd.grad(loss, pages)[0]}

        step()  # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for mod, name in counters:
            setattr(mod, name, 0)
        times, first, same = [], None, True
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            first = first or grads
            same = same and all(torch.equal(grads[k], first[k]) for k in grads)
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        assert any(float(g.abs().sum()) > 0 for g in grads.values())
        launches = tuple(getattr(mod, name) for mod, name in counters)
        return statistics.median(times), times, (torch.cuda.max_memory_allocated() - base) / 2**20, same, launches

    os.makedirs("build", exist_ok=True)
    k4 = ((raster_row, "GBUF_V1_KERNEL_LAUNCHES"), (raster_row, "GBUF_KERNEL_LAUNCHES"),
          (raster_row, "KERNEL_LAUNCHES"), (raster_row, "IBL_KERNEL_LAUNCHES"))

    # m. pbr_scene from the seeded pages, its quad combined pages, on the card.
    t0 = time.perf_counter()
    pages = seeded_texture_pages(5, TEXTURE_SIZE, alpha=True)
    cache = fill_asset_cache(pbr.scenes.AssetCache(texture_size=TEXTURE_SIZE), pages)
    seed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = textured_scene(pbr.scenes.pbr_scene, cache, "quad")
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    cam = pbr.Camera.create(position=CAMERA_POS, aspect=WIDTH / HEIGHT, device=dev)
    comb = scene.combined_atlas
    geom, params, binned, kw = v1_binning(scene, cam)
    assert scene.materials.num_materials == 58 and comb.num_pages == 9
    print(f"m. pbr_scene (58 spheres 64x32, 9 textured, {len(cache.pages)} seeded {TEXTURE_SIZE}² pages in "
          f"{seed_s:.2f} s on the host) + quad combined pages, built on the card in {build_ms:.1f} ms: atlas "
          f"{nbytes(*scene.atlas.mips) / 2**20:.1f} MiB, combined pages {nbytes(comb.taps, comb.pages, comb.mips_taps, comb.mips_stack) / 2**20:.1f} MiB "
          f"({comb.num_levels} levels); T {geom.num_triangles}, max span {params['max_span']}, pairs "
          f"{int(binned.starts[-1])}, jumbo {int(binned.starts[0])} [{smi}]")

    # n. Kernel 4 against its plain version on the frame's binning; 5 frames; mip_lod off and on.
    args = (binned.starts, binned.packed, binned.pair_tri)
    code_k, gb_k = raster_row.raster_gbuffer_tiles_cuda(*args, v1=True, **kw)
    code_p, gb_p = raster_row.raster_gbuffer_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert int((code_k != code_p).sum()) == 0, "kernel 4 codes differ from the plain version's"
    attr_err = float((gb_k[..., :-1] - gb_p[..., :-1]).abs().max())
    depth_err = float((gb_k[..., -1] - gb_p[..., -1]).abs().max())
    assert attr_err <= GBUF_ATOL and depth_err <= DEPTH_ATOL, (attr_err, depth_err)
    hits = int((code_k >= 0).sum())
    k4_err = max(attr_err, depth_err)
    k4_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_cuda(*args, v1=True, **kw), 20)
    k4_plain_ms = cuda_ms(lambda: raster_row.raster_gbuffer_tiles_plain(*args, **kw), 3, 1)
    k4_bound = bound(raster_read_bytes(*args, **kw) + nbytes(code_k, gb_k),
                     raster_tests(binned.starts, 16 * 128) * RASTER_TEST_FLOPS + hits * plane_flops(15, True))
    regs = [line for line in ptxas if line.startswith("raster_gbuffer_row_kernel<8,15>")]
    print(f"n. kernel 4 (G-buffer mode, 16x128 tiles, C = 14) vs plain at 1080p: hit pixels {hits}, codes exact, "
          f"attrs max abs err {attr_err:.3e}, depth {depth_err:.3e}; kernel {k4_ms:.3f} ms, plain version "
          f"{k4_plain_ms:.3f} ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]}); ptxas {regs} [{smi}]")
    pbr.render(scene, cam, width=WIDTH, height=HEIGHT)  # warm
    for mod, name in k4:
        setattr(mod, name, 0)
    tex_ms, tex_times, frame = frame_ms(lambda: pbr.render(scene, cam, width=WIDTH, height=HEIGHT))
    launches = tuple(getattr(mod, name) for mod, name in k4)
    assert launches == (5, 0, 0, 0), launches
    assert frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
    img = frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_textured.png"), img)
    top = img[: HEIGHT // 2, :, :3].reshape(-1, 3)
    print(f"n. 5 textured frames via render() at 1080p (quad pages, mip_lod off by the 2^20-texel rule): median "
          f"{tex_ms:.3f} ms ({WIDTH * HEIGHT / tex_ms / 1e3:.1f} Mpix/s), frames {[round(t, 3) for t in tex_times]}, "
          f"launches of kernels (4, 2, 1, 1b) {launches}; build/chip_smoke_textured.png mean RGB "
          f"{img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()} [{smi}]")
    assert top.std(0).max() > 0.01, "the textured row is flat"
    mips = {False: [], True: []}
    for i in range(6):  # interleaved: off, on, on, off, ...
        for flag in ((False, True) if i % 2 == 0 else (True, False)):
            mips[flag].append(frame_ms(lambda: pbr.render(scene, cam, width=WIDTH, height=HEIGHT,
                                                          mip_lod=flag), 1)[0])
    print(f"n. mip_lod at 1080p, 6 frames each, interleaved: off median {statistics.median(mips[False]):.3f} ms, "
          f"on (trilinear, 2 fetches a sample) {statistics.median(mips[True]):.3f} ms [{smi}]")
    s_cache = fill_asset_cache(pbr.scenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32))
    s_scene = pbr.scenes.pbr_scene(s_cache, texture_size=32, slices=16, stacks=8, device="cpu")
    s_scene = s_scene.with_combined_textures(mode="quad")
    s_cam = pbr.Camera.create(position=CAMERA_POS, aspect=128 / 64, device="cpu")
    ref = pbr.render(s_scene, s_cam, width=128, height=64).numpy()
    got = pbr.render(s_scene.to(dev), s_cam.to(dev), width=128, height=64).cpu().numpy()
    d = np.abs(got - ref)
    frac, med, q999 = float((d > 1e-5).mean()), float(np.median(d)), float(np.quantile(d, 0.999))
    print(f"n. 128x64 textured frame, card vs CPU: values off by > 1e-5 {frac:.5f}, median {med:.2e}, "
          f"0.999-quantile {q999:.2e}, max {float(d.max()):.2e}")
    assert frac < 5e-3 and med < 1e-6 and q999 < 1e-2, (frac, med, q999)

    # o. The bench step, material gradients: quad pages, then half.
    o = {}
    for mode in ("quad", "half"):
        s = scene if mode == "quad" else textured_scene(pbr.scenes.pbr_scene, cache, "half")
        o[mode] = bench_steps(s, cam, k4)
        step_med, times, peak, same, launches = o[mode]
        print(f"o. textured bench step ({mode} pages, material grads) at 1080p: median {step_med:.3f} ms over 5 "
              f"({WIDTH * HEIGHT / step_med / 1e3:.1f} Mpix/s), steps {[round(t, 3) for t in times]}, peak "
              f"{peak:.1f} MiB above the scene, the same gradient bits every step: {same}, launches of kernels "
              f"(4, 2, 1, 1b) {launches} [{smi}]")
        assert same and launches == (5, 0, 0, 0), (same, launches)
    k4_launches = o["quad"][4][0]

    # p. The texel-gradient step: the gradient to the quad pages.
    step_med, times, peak, same, launches = bench_steps(scene, cam, k4, texel=True)
    print(f"p. texel-gradient step (quad pages, mip_lod off) at 1080p: median {step_med:.3f} ms, steps "
          f"{[round(t, 3) for t in times]}, peak {peak:.1f} MiB above the scene, the same bits every step: "
          f"{same} [{smi}]")
    assert same and launches[0] == 5, (same, launches)

    # q. rustediron under the seeded HDR env and u8 background, IBL, quad pages.
    env = torch.as_tensor(seeded_env(7, 256, 512), device=dev)
    bg = sky_u8(seeded_background(8, 1536, 3072)).to(dev)
    rust = pbr.scenes.rustediron_sphere_scene(cache, texture_size=TEXTURE_SIZE, device=dev)
    rust = dataclasses.replace(rust, env_map=env, sky_map=bg).with_ibl().with_combined_textures(mode="quad")
    r_cam = pbr.Camera.create(position=(0.0, 0.0, -2.5), aspect=WIDTH / HEIGHT, device=dev)
    _, r_params, r_binned, _ = v1_binning(rust, r_cam)
    pbr.render(rust, r_cam, width=WIDTH, height=HEIGHT)  # warm
    for mod, name in k4:
        setattr(mod, name, 0)
    ibl_ms, ibl_times, r_frame = frame_ms(lambda: pbr.render(rust, r_cam, width=WIDTH, height=HEIGHT))
    launches = tuple(getattr(mod, name) for mod, name in k4)
    assert launches == (5, 0, 0, 0) and bool(torch.isfinite(r_frame).all()), launches
    r_img = r_frame.cpu().numpy()
    save_png(os.path.join("build", "chip_smoke_rustediron_ibl.png"), r_img)
    step_med, times, peak, same, step_launches = bench_steps(rust, r_cam, k4)
    print(f"q. rustediron + IBL (quad pages, mip_lod on by the rule, merged-IBL tail) at 1080p: T "
          f"{rust.draws[0].mesh.num_triangles}, max span {r_params['max_span']}, pairs {int(r_binned.starts[-1])}, "
          f"jumbo {int(r_binned.starts[0])}; 5 frames median {ibl_ms:.3f} ms, launches (4, 2, 1, 1b) {launches}; "
          f"bench step median {step_med:.3f} ms, peak {peak:.1f} MiB, same bits {same}, launches {step_launches}; "
          f"build/chip_smoke_rustediron_ibl.png mean RGB {r_img[..., :3].reshape(-1, 3).mean(0).round(4).tolist()} "
          f"[{smi}]")
    assert same and step_launches[0] == 5, (same, step_launches)

    # r. An alpha-tested 1080p frame: one peel, so kernel 4 launches twice a frame.
    f = alpha_test_fields(scene.materials, cache, 0)
    mats = dataclasses.replace(scene.materials, any_alpha_test=True,
                               **{k: torch.as_tensor(v, device=dev) for k, v in f.items()})
    cut = dataclasses.replace(scene, materials=mats).with_combined_textures(mode="quad")
    pbr.render(cut, cam, width=WIDTH, height=HEIGHT)  # warm
    for mod, name in k4:
        setattr(mod, name, 0)
    cut_ms, _, cut_frame = frame_ms(lambda: pbr.render(cut, cam, width=WIDTH, height=HEIGHT))
    launches = tuple(getattr(mod, name) for mod, name in k4)
    assert launches == (10, 0, 0, 0), launches
    killed = int(((cut_frame - frame).abs().amax(-1) > 1e-3).sum())
    assert killed > 100, killed
    s_cache_a = fill_asset_cache(pbr.scenes.AssetCache(texture_size=32), seeded_texture_pages(5, 32, alpha=True))
    s_cut = pbr.scenes.pbr_scene(s_cache_a, texture_size=32, slices=16, stacks=8, device="cpu")
    fa = alpha_test_fields(s_cut.materials, s_cache_a, 0)
    s_cut = dataclasses.replace(s_cut, materials=dataclasses.replace(
        s_cut.materials, any_alpha_test=True, **{k: torch.as_tensor(v) for k, v in fa.items()}))
    s_cut = s_cut.with_combined_textures(mode="quad")
    a_cam = pbr.Camera.create(position=(0.0, 0.0, -4.0), aspect=128 / 64, device="cpu")
    ref = pbr.render(s_cut, a_cam, width=128, height=64).numpy()
    got = pbr.render(s_cut.to(dev), a_cam.to(dev), width=128, height=64).cpu().numpy()
    d = np.abs(got - ref)
    assert (d > 1e-5).mean() < 5e-3 and np.median(d) < 1e-6 and np.quantile(d, 0.999) < 1e-2
    world_of_one(dev)
    try:
        for mod, name in k4:
            setattr(mod, name, 0)
        tri = pbr.render_tri_sharded(scene, cam, width=WIDTH, height=HEIGHT)
        tri_launches = tuple(getattr(mod, name) for mod, name in k4)
    finally:
        dist.destroy_process_group()
    # the ring's band tail samples mip 0, as the JAX package's does
    tri_err = float((tri - pbr.render(scene, cam, width=WIDTH, height=HEIGHT, mip_lod=False)).abs().max())
    print(f"r. alpha-tested 1080p frame (material 0 through a seeded opacity page): median {cut_ms:.3f} ms, "
          f"launches (4, 2, 1, 1b) {launches} over 5 frames, {killed} pixels show the peeled layer; 128x64 card vs "
          f"CPU max abs err {float(d.max()):.2e}; textured render_tri_sharded (world of 1, NCCL) vs render() max "
          f"abs err {tri_err:.2e}, launches {tri_launches} [{smi}]")
    assert tri_launches == (0, 1, 0, 0) and tri_err <= GBUF_ATOL, (tri_launches, tri_err)

    return [kernel_entry("raster_gbuffer_v1", "raster_shade_row.cu", "ops/raster_pallas.py:225", k4_launches,
                         k4_err, k4_ms, k4_plain_ms, k4_bound)]


if __name__ == "__main__":
    sys.exit(main())
