"""Where the time of one forward frame, or one training step, goes on the
card (PyTorch port).

    python scripts/profile_torch_render.py [--train] [--ibl | --tri | --layered | --soft | --textured [--alpha]
                                           | --obj {atlas,f32,quad,half,packed}]
                                           [--frames 10] [--width 1920 --height 1080]

Renders the 7×7 sphere grid (``red_sphere_grid_scene(64, 32)``, the
``bench.py`` camera) through ``physically_based_renderer_tpu_torch.render``
under ``torch.profiler``; with ``--ibl`` under ``chip_smoke.py``'s seeded
256×512 HDR environment (IBL maps built on the card) and 1536×3072 u8
background, the fused IBL path; with ``--tri`` through ``render_tri_sharded``
as one rank (no process group: kernel 2's G-buffer, the merge, kernel 6's
shading); with ``--textured`` the textured deferred path on ``pbr_scene``
with ``chip_smoke.py``'s seeded 512² pages and quad combined pages (kernel
4, then ``shade_pixels``), with ``--textured --ibl`` on the rustediron
sphere under the IBL environment (camera (0, 0, −2.5)), with ``--textured
--alpha`` the alpha-tested ``pbr_scene`` (two kernel-4 passes); with ``--layered``
the grid under ``chip_smoke.py``'s layer mix through ``render_layered`` 2+2
(four kernel-5 peels, four shades); with ``--soft`` the grid through
``render_soft`` at its defaults (K 3, σ 1: three kernel-5b peels, three
``shade_fused`` layers, the composite); with ``--obj MODE`` the grid written
as one OBJ with its MTL and 1024² JPEG / PNG maps (``chip_smoke.write_grid_obj``,
into a temporary directory under ``build/``) and loaded by ``obj_scene`` at a
512 atlas, sampled through the per-slot atlas (``atlas``) or that mode's
combined pages. With ``--train`` each iteration is the bench step
instead: the forward, the loss ``mean(img[..., :3]**2)`` and its gradient
with respect to the material bank's float fields. Prints: the card and its
power limit, the median iteration time (CUDA events), device time summed by
kernel, the device busy share of the profiled window (summed kernel time
over wall time; kernels on one stream do not overlap) and the host's time
by operator (self CPU time, the launch and dispatch cost of the host-bound
frame). With ``--train`` it
then times the step again with the world matrices and the eye requiring
grad too (the geometry VJP through the ``interpolate_corners`` recompute),
and prints both steps' peak device memory above the scene's. Writes a Chrome
trace to ``chiprun_out/torch_render_trace.json`` (``torch_train`` with
``--train``, an ``_ibl``, ``_tri``, ``_layered``, ``_soft`` or ``_obj_<mode>``
suffix). Needs a CUDA card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--train", action="store_true", help="profile the fwd+bwd bench step")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--ibl", action="store_true", help="the grid under chip_smoke.py's IBL environment")
    mode.add_argument("--tri", action="store_true", help="through render_tri_sharded, as one rank")
    mode.add_argument("--layered", action="store_true", help="render_layered 2+2 on the layer-mixed grid")
    mode.add_argument("--soft", action="store_true", help="render_soft (K 3, sigma 1) on the grid")
    ap.add_argument("--textured", action="store_true", help="the textured deferred path (seeded pages)")
    ap.add_argument("--alpha", action="store_true", help="with --textured: the alpha-tested pbr_scene")
    ap.add_argument("--obj", choices=("atlas", "f32", "quad", "half", "packed"),
                    help="the grid as an OBJ through obj_scene, sampled through this mode's pages")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_render: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import physically_based_renderer_tpu_torch as pbr

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda:0")
    scene = pbr.scenes.red_sphere_grid_scene(64, 32, device=dev)
    cam = pbr.Camera.create(position=(0.0, -3.0, -18.0), aspect=args.width / args.height, device=dev)
    if args.textured:
        from chip_smoke import alpha_test_fields, fill_asset_cache, seeded_texture_pages, with_fields

        cache = fill_asset_cache(pbr.scenes.AssetCache(), seeded_texture_pages(5, 512, alpha=args.alpha))
        if args.ibl:
            scene = pbr.scenes.rustediron_sphere_scene(cache, device=dev)
            cam = pbr.Camera.create(position=(0.0, 0.0, -2.5), aspect=args.width / args.height, device=dev)
        else:
            scene = pbr.scenes.pbr_scene(cache, device=dev)
        if args.alpha:
            scene = with_fields(scene, alpha_test_fields(scene.materials, cache, 0), dev, any_alpha_test=True)
    if args.ibl:
        from chip_smoke import seeded_background, seeded_env
        from physically_based_renderer_tpu_torch.ops.texture import sky_u8

        env = torch.as_tensor(seeded_env(7, 256, 512), device=dev)
        bg = sky_u8(seeded_background(8, 1536, 3072)).to(dev)
        scene = dataclasses.replace(scene, env_map=env, sky_map=bg).with_ibl()
    if args.textured:
        scene = scene.with_combined_textures(mode="quad")
    if args.obj:
        import shutil
        import tempfile

        from chip_smoke import write_grid_obj

        os.makedirs("build", exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="profile_obj_", dir="build")
        try:
            scene = pbr.scenes.obj_scene(write_grid_obj(tmp, pbr), texture_size=512, device=dev)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if args.obj != "atlas":
            scene = scene.with_combined_textures(mode=args.obj)
    if args.layered:
        from chip_smoke import layer_mix_fields, with_fields

        scene = with_fields(scene, layer_mix_fields(scene.materials, 11), dev, any_alpha_test=True)

    mats = scene.materials
    fields = [k for k in mats.tensor_fields() if getattr(mats, k).is_floating_point()]
    render = (pbr.render_tri_sharded if args.tri else pbr.renderer.render_layered if args.layered
              else pbr.renderer.render_soft if args.soft else pbr.render)

    def forward():
        return render(scene, cam, width=args.width, height=args.height)

    def train_step(geometry=False):
        leaves = {k: getattr(mats, k).detach().requires_grad_() for k in fields}
        s = dataclasses.replace(scene, materials=dataclasses.replace(mats, **leaves))
        c = cam
        if geometry:
            leaves["worlds"] = scene.draws[0].worlds.detach().requires_grad_()
            leaves["eye"] = cam.position.detach().requires_grad_()
            draws = (dataclasses.replace(scene.draws[0], worlds=leaves["worlds"]), *scene.draws[1:])
            s = dataclasses.replace(s, draws=draws)
            c = dataclasses.replace(cam, position=leaves["eye"])
        img = render(s, c, width=args.width, height=args.height)
        loss = torch.mean(img[..., :3] ** 2)
        return torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)

    def timed(fn):
        """Per-iteration ms of ``fn`` after 3 warm-up calls: CUDA events and
        the host clock (synchronised), and the peak memory above the start."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev, host = [], []
        for _ in range(args.frames):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            ev.append(s.elapsed_time(e))
        return ev, host, (torch.cuda.max_memory_allocated() - base) / 2**20

    frame = train_step if args.train else forward
    ev_ms, host_ms, peak_mib = timed(frame)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs("chiprun_out", exist_ok=True)
    suffix = ("_textured" if args.textured else "") + ("_alpha" if args.alpha else "") + (
        "_ibl" if args.ibl else "_tri" if args.tri else "_layered" if args.layered else "_soft" if args.soft else "") + (
        f"_obj_{args.obj}" if args.obj else "")
    trace = ("torch_train" if args.train else "torch_render") + suffix + "_trace.json"
    prof.export_chrome_trace(os.path.join("chiprun_out", trace))

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    print(smi)
    what = "training steps (fwd+bwd)" if args.train else "frames"
    print(f"{args.width}x{args.height}, {args.frames} {what}: median {statistics.median(ev_ms):.3f} ms "
          f"(CUDA events), {statistics.median(host_ms):.3f} ms (host clock, synchronised)")
    print(f"profiled window: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {len(kernels) / args.frames:.0f} device ops per iteration")
    print("device time per iteration by kernel (ms):")
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in rows[:25]:
        print(f"  {sum(ts) / args.frames:9.4f}  x{len(ts) // args.frames:<3d} {name[:110]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"host self time per iteration by operator (ms; all operators "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3 / args.frames:.3f}):")
    for e in host[:15]:
        print(f"  {e.self_cpu_time_total / 1e3 / args.frames:9.4f}  x{e.count // args.frames:<4d} {e.key[:100]}")
    if args.train:
        geo_ev, geo_host, geo_mib = timed(lambda: train_step(geometry=True))
        print(f"peak device memory above the scene: {peak_mib:.1f} MiB with material grads; "
              f"{geo_mib:.1f} MiB with world matrices and eye too, whose step takes median "
              f"{statistics.median(geo_ev):.3f} ms (CUDA events), "
              f"{statistics.median(geo_host):.3f} ms (host clock, synchronised)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
