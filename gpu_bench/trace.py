"""The traced run: spans around the calls into the program's layers, the
profiler over a bounded stretch of the window, and the trace read back as
device intervals, launches and spans.

Spans are ``torch.profiler.record_function`` ranges named ``gpu_bench/<layer>``,
opened by wrapping the module attributes the program looks up at call time
(``renderer.raster_gbuffer``, ``renderer.shade_pixels``,
``renderer.ibl_compose``, ``torch.autograd.grad``). The program is not edited,
and outside a traced run nothing is wrapped."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import json
import os
import threading

import torch

from .stats import merged, union_length

PREFIX = "gpu_bench/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _wrap(fn, name: str):
    local = threading.local()

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if getattr(local, "depth", 0):  # nested calls (a backward inside a backward) share the outer span
            return fn(*args, **kwargs)
        local.depth = 1
        try:
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        finally:
            local.depth = 0

    return spanned


@contextlib.contextmanager
def layer_spans(port):
    """Wrap the program's layer entry points in spans for the scope."""
    targets = [
        (port.renderer, "raster_gbuffer", "raster"),
        (port.renderer, "shade_pixels", "ps_stage"),
        (port.renderer, "ibl_compose", "ibl_tail"),
        (torch.autograd, "grad", "backward"),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    try:
        for mod, attr, name in targets:
            setattr(mod, attr, _wrap(getattr(mod, attr), name))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


@dataclasses.dataclass
class Trace:
    """A profiled window, in microseconds on the profiler's clock.

    ``device``: (start, end, name) of each kernel, copy and fill;
    ``launch``: the host time each device operation was enqueued at (by
    correlation id, aligned with ``device_corr``); ``spans``: name →
    [(start, end)] of the benchmark's spans; ``host``: the main thread's
    top-level operations (start, end, name); ``window``: (start, end);
    ``units``: frames or steps inside the window."""

    device: list
    device_corr: list
    launch: dict
    spans: dict
    host: list
    window: tuple
    units: int

    @staticmethod
    def from_chrome(path: str, units: int) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        device, corr, launch, spans, cpu_ops = [], [], {}, {}, []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, ts, dur = ev.get("cat", ""), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, ev.get("name", "")))
                corr.append(args.get("correlation"))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launch[args["correlation"]] = ts
            elif cat == "user_annotation" and ev.get("name", "").startswith(PREFIX):
                spans.setdefault(ev["name"][len(PREFIX):], []).append((ts, ts + dur))
            elif cat == "cpu_op":
                cpu_ops.append((ts, ts + dur, ev.get("name", ""), ev.get("tid")))
        windows = spans.get("window", [])
        if not windows:
            raise ValueError("the trace holds no window span")
        window = (windows[0][0], windows[0][1])
        main_tid = None
        tids: dict = {}
        for s, e, _, tid in cpu_ops:
            tids[tid] = tids.get(tid, 0.0) + (e - s)
        if tids:
            main_tid = max(tids, key=tids.get)
        host = _top_level([(s, e, n) for s, e, n, tid in cpu_ops if tid == main_tid])
        keep = [i for i, d in enumerate(device) if window[0] <= d[0] < window[1]]
        return Trace(device=[device[i] for i in keep], device_corr=[corr[i] for i in keep], launch=launch,
                     spans=spans, host=host, window=window, units=units)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        """Union of the device's operations inside the window."""
        return union_length((max(s, self.window[0]), min(e, self.window[1])) for s, e, _ in self.device)

    def launches(self) -> int:
        return len(self.device)

    def span_us(self, name: str) -> float:
        """Host time inside the spans of ``name`` (overlaps counted once)."""
        return union_length(self.spans.get(name, []))

    def device_us_under(self, name: str) -> float:
        """Device time of the operations enqueued inside a span of ``name``
        (on any host thread: autograd runs its backward on its own)."""
        ranges = merged(self.spans.get(name, []))
        if not ranges:
            return 0.0
        starts = [r[0] for r in ranges]
        total = 0.0
        for (s, e, _), c in zip(self.device, self.device_corr):
            t = self.launch.get(c)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += e - s
        return total

    def device_us_named(self, fragment: str) -> float:
        """Device time of the operations whose name holds ``fragment``
        (spaces ignored: demanglers differ in ``<8, 15>`` and ``<8,15>``)."""
        frag = fragment.replace(" ", "")
        return sum(e - s for s, e, n in self.device if frag in n.replace(" ", ""))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing (the innermost benchmark span
        at the gap's start, then the main thread's top-level operation that
        covers most of the gap), in seconds."""
        ops: dict = {}
        for s, e, n in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s)
        busy = merged((max(s, self.window[0]), min(e, self.window[1])) for s, e, _ in self.device)
        gaps, prev = [], self.window[0]
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.window[1] > prev:
            gaps.append((prev, self.window[1]))
        host_starts = [h[0] for h in self.host]
        idle: dict = {}
        for s, e in gaps:
            span = self._innermost_span(s)
            op, most = "python", 0.0  # the top-level host operation that covers most of the gap
            i = max(0, bisect.bisect_right(host_starts, s) - 1)
            while i < len(self.host) and self.host[i][0] < e:
                cover = min(e, self.host[i][1]) - max(s, self.host[i][0])
                if cover > most:
                    op, most = self.host[i][2], cover
                i += 1
            key = f"{span} > {op}" if span else op
            idle[key] = idle.get(key, 0.0) + (e - s)
        order = lambda d: sorted(([k, v * 1e-6] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(ops), "idle_gaps": order(idle)}

    def _innermost_span(self, t: float) -> str:
        best, best_len = "", float("inf")
        for name, ranges in self.spans.items():
            for s, e in ranges:
                if s <= t <= e and e - s < best_len:
                    best, best_len = name, e - s
        return best


def _top_level(ops):
    """The operations not nested in another of the same thread."""
    out, end = [], -float("inf")
    for s, e, n in sorted(ops, key=lambda x: (x[0], -x[1])):
        if s >= end:
            out.append((s, e, n))
            end = e
    return out


def export(prof, directory: str, name: str) -> str:
    """Write the profiler's Chrome trace to a fixed path of ``directory``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-{name}.json")
    prof.export_chrome_trace(path)
    return path
