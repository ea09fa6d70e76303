"""The harness: finds a cell's configuration, traffic mix, limits and
metric readers by name, runs the cell and assembles its result line."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time

import torch

from . import check, loops, stats, trace
from .roofline import frame_work
from .scene import make_inputs, reference_scene

PACKAGE = "physically_based_renderer_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))
TRACE_DIR = os.path.join("build", "gpu_bench")


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    path = os.path.join(HERE, "traffic", f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no traffic mix named {name!r} (traffic/{name}.json)")
    with open(path) as f:
        mix = json.load(f)
    if mix.get("loop") not in loops.LOOPS:
        raise ValueError(f"traffic mix {name!r} names an unknown loop {mix.get('loop')!r}")
    return mix


def load_metric(name: str):
    """The reader module of the per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no reader for the per-layer metric {name!r} (metrics/{name}.py)")
    spec = importlib.util.spec_from_file_location(f"gpu_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


class Context:
    """What a per-layer reader gets besides the trace: the configuration,
    the traced units, and (computed at first use) the work the reference
    counts for each traced frame."""

    def __init__(self, loop, first: int, units: int, scene_fn):
        self.loop, self.cfg, self.first, self.units = loop, loop.cfg, first, units
        self._scene_fn, self._work = scene_fn, None

    def work(self) -> list:
        if self._work is None:
            rs = self._scene_fn()
            w, h = self.cfg["width"], self.cfg["height"]
            self._work = [frame_work(rs, self.loop.pose_of(k), w, h) for k in range(self.first, self.first + self.units)]
        return self._work


def run_cell(root: str, bench: dict, cell: dict, *, seed: int, seconds: float, traced: bool, device,
             t_start: float, cfg_overrides: dict | None = None) -> dict:
    """Set up, measure (or trace), release the program, check → the result
    line as a dict (``checks`` last). ``cfg_overrides`` replaces keys of the
    configuration (the CPU tests' small sizes)."""
    port = importlib.import_module(PACKAGE)
    cfg = load_config(root, bench, cell["config"])
    cfg.update(cfg_overrides or {})
    mix = load_traffic(cell["traffic"])
    limits = check.load_limits(HERE, cell["name"])
    readers = {m["name"]: load_metric(m["name"]) for m in cell_metrics(bench, cell["name"], "per_layer")} if traced else {}
    cuda = torch.device(device).type == "cuda"

    loop = loops.LOOPS[mix["loop"]](port, cfg, mix, seed, device)
    loop.setup()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    prof = None
    if traced:
        prof = trace.profiler()
        with trace.layer_spans(port), prof:
            with torch.profiler.record_function(trace.PREFIX + "window"):
                win = loop.run(units=int(mix["trace_units"]), span=trace.PREFIX + "unit")
    else:
        win = loop.run(seconds=seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    out_metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": cell["chips"],
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    breakdown = None
    if traced:
        path = trace.export(prof, os.path.join(root, TRACE_DIR), cell["name"])
        del prof
        tr = trace.Trace.from_chrome(path, win.units)
        os.remove(path)
        device_info["busy_s"] = tr.busy_us() * 1e-6
        device_info["window_s"] = tr.window_us * 1e-6
        ctx = Context(loop, win.first_index, win.units,
                      lambda: reference_scene(cfg, make_inputs(cfg, seed, device), device))
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            value = readers[m["name"]].read(tr, ctx)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown()
    else:
        values = {
            "setup_s": setup_s,
            "frame_rate": stats.rate(win.units, win.seconds),
            "frame_p95_ms": stats.percentile(win.latencies, 95) * 1e3,
            "step_rate": stats.rate(win.units, win.seconds),
            "train_peak_mib": window_peak / 2**20,
        }
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            out_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    numbers = loop.check_numbers(check)
    correct, checks = check.judge(numbers, limits)
    result = {"correct": correct and win.failed == 0, "attempted": win.units, "failed": win.failed,
              "metrics": out_metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
