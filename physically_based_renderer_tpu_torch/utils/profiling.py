"""Timing and tracing — the counterpart of
``physically_based_renderer_tpu/utils/profiling.py`` (``D3DApp::
CalculateFrameStats``, ``d3dApp.cpp:598-628``, plus device-side timing).

``time_device_loop`` times a function on the card with CUDA events around a
run of calls after a warm-up (PyTorch returns before the card finishes, so a
host clock without a synchronise would time the enqueue); it needs a card
and raises without one. ``trace`` records a ``torch.profiler`` trace of the
host and the card; ``device_summary`` lists the devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import torch


@dataclasses.dataclass
class TimingResult:
    ms_per_iter: float
    iters: int
    pixels: int | None = None

    @property
    def fps(self) -> float:
        return 1000.0 / self.ms_per_iter

    @property
    def pixels_per_s(self) -> float | None:
        if self.pixels is None:
            return None
        return self.pixels / (self.ms_per_iter / 1000.0)

    def __str__(self) -> str:
        s = f"{self.ms_per_iter:.2f} ms/iter ({self.fps:.1f} it/s)"
        if self.pixels is not None:
            s += f", {self.pixels_per_s / 1e6:.1f} Mpix/s"
        return s


def time_device_loop(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                     pixels: int | None = None) -> TimingResult:
    """Milliseconds per call of ``fn(*args)`` on the current CUDA stream:
    ``warmup`` calls, then one CUDA event before and one after ``iters``
    calls, a synchronise, and the elapsed time over ``iters``. Raises
    ``RuntimeError`` where there is no card: a CPU time is no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_device_loop needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return TimingResult(ms_per_iter=start.elapsed_time(end) / iters, iters=iters, pixels=pixels)


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("build", "pbr_trace")):
    """``torch.profiler`` over the scope, host and (where there is one) card
    activity; writes a Chrome trace ``trace.json`` into ``log_dir`` and
    yields the profiler (``.key_averages()`` sums time by op and kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_summary() -> str:
    """The devices — the ``D3DApp::LogAdapters`` analog (``d3dApp.cpp:630-703``)."""
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    lines = [f"torch {torch.__version__}, backend={backend}"]
    for i in range(torch.cuda.device_count() if backend == "cuda" else 0):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"  device {i}: {p.name} ({p.total_memory / 2**30:.1f} GiB, {p.multi_processor_count} SMs)")
    return "\n".join(lines)
