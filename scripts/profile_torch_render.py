"""Where the time of one forward frame goes, on the card (PyTorch port).

    python scripts/profile_torch_render.py [--frames 10] [--width 1920 --height 1080]

Renders the 7×7 sphere grid (``red_sphere_grid_scene(64, 32)``, the
``bench.py`` camera) through ``physically_based_renderer_tpu_torch.render``
under ``torch.profiler`` and prints: the card and its power limit, the
median frame time (CUDA events), device time summed by kernel, and the
device busy share of the profiled window (summed kernel time over wall
time; kernels on one stream do not overlap). Writes a Chrome trace to
``chiprun_out/torch_render_trace.json``. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
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

    def frame():
        return pbr.render(scene, cam, width=args.width, height=args.height)

    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    ev_ms, host_ms = [], []
    for _ in range(args.frames):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        frame()
        e.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(s.elapsed_time(e))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            frame()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", "torch_render_trace.json"))

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    print(smi)
    print(f"{args.width}x{args.height}, {args.frames} frames: median frame {statistics.median(ev_ms):.3f} ms "
          f"(CUDA events), {statistics.median(host_ms):.3f} ms (host clock, synchronised)")
    print(f"profiled window: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {len(kernels) / args.frames:.0f} device ops per frame")
    print("device time per frame by kernel (ms):")
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in rows[:25]:
        print(f"  {sum(ts) / args.frames:9.4f}  x{len(ts) // args.frames:<3d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
