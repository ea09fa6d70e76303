"""Process-group set-up, frame assembly and the scaling harness — the
counterpart of ``physically_based_renderer_tpu/parallel/distributed.py`` on
``torch.distributed``: one process per device, the caller names the group's
address, size and rank (nothing in the environment announces a cluster).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE
from .sharded import process_group, rank_and_size, render_sharded


def initialize_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    device: torch.device | str = DEFAULT_DEVICE,
) -> None:
    """``torch.distributed.init_process_group`` for a world of
    ``world_size`` processes: NCCL when the ranks render on CUDA devices,
    gloo on the CPU. ``init_method`` is a ``tcp://host:port`` or
    ``file://path`` rendezvous. A no-op for one process, as in the JAX
    package: the sharded functions then run as a world of one."""
    if world_size is None or world_size <= 1:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def fetch_image(band: torch.Tensor, group=None) -> torch.Tensor:
    """Assemble this rank's (H/n, W, C) band and the others' into the (H,
    W, C) frame on every rank (``all_gather``) — the "present" step."""
    grp = process_group(group)
    _, n = rank_and_size(grp)
    if grp is None:
        return band
    bands = [torch.empty_like(band) for _ in range(n)]
    dist.all_gather(bands, band.contiguous(), group=grp)
    return torch.cat(bands)


@dataclasses.dataclass
class ScalingResult:
    devices: int
    ms_per_frame: float
    pixels_per_s: float
    efficiency: float  # vs 1-device rate × N


def measure_scaling(
    scene,
    camera,
    *,
    width: int,
    height: int,
    device_counts: list[int] | None = None,
    iters: int = 8,
    group=None,
    **render_kwargs: Any,
) -> list[ScalingResult]:
    """Pixel-throughput sweep of ``render_sharded`` over the first n ranks
    of the group for each n of ``device_counts`` (default 1, 2, 4, 8 and the
    group's size, as far as it goes). Every process of the default group
    calls it (``new_group`` is collective); the ranks of a subgroup render
    ``iters`` frames of (height rounded down to a multiple of 8n) rows after
    one warm-up, and a frame's time is the slowest rank's: CUDA events on
    the card, ``perf_counter`` on the CPU. Returns the sweep on the ranks of
    each subgroup (rank 0 is in every one)."""
    grp = process_group(group)
    rank, size = rank_and_size(grp)
    if device_counts is None:
        device_counts = sorted({n for n in (1, 2, 4, 8, size) if n <= size})
    device = camera.device
    ranks = list(range(size)) if grp is None else dist.get_process_group_ranks(grp)
    results: list[ScalingResult] = []
    base_rate = None
    for n in device_counts:
        sub = None if grp is None else dist.new_group(ranks[:n])
        if rank >= n:
            continue
        h = (height // (n * 8)) * (n * 8)

        def frame():
            return render_sharded(scene, camera, width=width, height=h, group=sub, **render_kwargs)

        frame()  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                frame()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                frame()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        if sub is not None:
            slowest = torch.tensor([ms], dtype=torch.float64, device=device)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=sub)
            ms = float(slowest)
        rate = width * h / (ms * 1e-3)
        base_rate = rate if base_rate is None else base_rate
        results.append(ScalingResult(devices=n, ms_per_frame=ms, pixels_per_s=rate,
                                     efficiency=rate / (base_rate * n)))
    return results
