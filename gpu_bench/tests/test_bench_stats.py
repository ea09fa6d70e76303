"""The rate, tail and idle arithmetic: on a synthetic trace, and on a loop
whose window holds a stall."""

from __future__ import annotations

import json
import statistics
import time

import pytest

from gpu_bench import loops, stats
from gpu_bench.trace import Trace


def test_rate_percentile_spread_union():
    assert stats.rate(300, 10.0) == 30.0
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95 and stats.percentile(vals, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    q1, _, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / 3.5)
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def _chrome(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_synthetic_trace_busy_idle_launches_spans(tmp_path):
    ev = [
        _x("user_annotation", "gpu_bench/window", 0, 1000),
        _x("user_annotation", "gpu_bench/ps_stage", 100, 200),
        _x("cpu_op", "aten::mul", 100, 20), _x("cpu_op", "aten::nonzero", 500, 300),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 250, 5, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 5, correlation=3),
        _x("kernel", "mul_kernel", 120, 100, tid=7, correlation=1),
        _x("kernel", "void raster_gbuffer_row_kernel<8, 15>(GbufParams)", 200, 50, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoH", 420, 30, tid=7, correlation=3),
        _x("kernel", "outside_window", 2000, 10, tid=7, correlation=4),
    ]
    tr = Trace.from_chrome(_chrome(tmp_path, ev), units=2)
    assert tr.window_us == 1000 and tr.launches() == 3
    assert tr.busy_us() == pytest.approx(130 + 30)  # [120, 250) and [420, 450)
    assert tr.device_us_under("ps_stage") == pytest.approx(150)  # launched at 110 and 250, inside [100, 300]
    assert tr.device_us_named("raster_gbuffer_row_kernel<8, 15>") == 50
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["mul_kernel", pytest.approx(100e-6)]
    gaps = dict(bd["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx((1000 - 160) * 1e-6)
    assert gaps["window > aten::nonzero"] == pytest.approx(550e-6)  # [450, 1000) while nonzero ran from 500
    from gpu_bench import harness

    assert harness.load_metric("device_idle_pct.fwd").read(tr, None) == pytest.approx(84.0)
    assert harness.load_metric("launches_per_frame.fwd").read(tr, None) == 1.5
    assert harness.load_metric("ps_stage_ms.fwd").read(tr, None) == pytest.approx(0.075)
    assert harness.load_metric("ibl_tail_ms.fwd").read(tr, None) is None  # no span: nothing to read


class _Sleeper(loops.Loop):
    """A loop whose unit sleeps: 2 ms, or 30 ms inside the stall."""

    def __init__(self, stall: range):
        self.next_index, self.device, self.stall = 0, "cpu", stall

    def unit(self, k):
        time.sleep(0.030 if k in self.stall else 0.002)


def test_a_stall_in_the_window_moves_rate_and_tail():
    calm = _Sleeper(range(0)).run(units=100)
    stalled = _Sleeper(range(40, 55)).run(units=100)
    assert calm.units == stalled.units == 100 and calm.failed == 0
    assert stats.rate(stalled.units, stalled.seconds) < 0.5 * stats.rate(calm.units, calm.seconds)
    assert stats.percentile(stalled.latencies, 95) > 5 * stats.percentile(calm.latencies, 95)
    timed = _Sleeper(range(0)).run(seconds=0.05)
    assert timed.seconds >= 0.05 and timed.units == len(timed.latencies) >= 10
