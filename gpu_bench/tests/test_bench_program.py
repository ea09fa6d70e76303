"""``program.py`` and the readers built on it, on a synthetic trace and
recorder: each number, the clock check that reads nothing, a program without
a recorder. On the card (``-m cuda``): the program's sync counter over one
frame of each forward cell and one training step equals the number of
``torch.cuda.set_sync_debug_mode(1)`` warnings."""

from __future__ import annotations

import types
import warnings

import pytest
import torch

import physically_based_renderer_tpu_torch as port
from gpu_bench import harness, loops, program
from gpu_bench.trace import Trace
from physically_based_renderer_tpu_torch.utils import profiling

from .conftest import ROOT, SEED

T0_NS = program.base_ns(1_790_000_000 * 10**9) + 1000 * 10**9  # 10⁹ µs on the trace's clock
T0_US = 1e9
UNIT_US = 20_000.0
MAIN = 1  # the thread of every synthetic span

# (name, parent, start, end) a frame, µs from the frame's unit start
FRAME_SPANS = [
    ("frame", None, 10, 19_000), ("sky", "frame", 100, 1_000), ("raster", "frame", 1_000, 5_000),
    ("raster/bin", "raster", 1_100, 4_000), ("sync/edge_index", "raster/bin", 3_000, 3_900),
    ("ps_stage", "frame", 5_000, 15_000), ("ps_stage/fetch", "ps_stage", 5_100, 6_000),
    ("ps_stage/sample", "ps_stage", 6_000, 10_000), ("ps_stage/light", "ps_stage", 10_000, 14_000),
    ("sync/x", "ps_stage", 14_650, 14_800), ("sync/overflow", "frame", 15_000, 18_000),
    ("ibl_tail", "frame", 18_000, 18_900),
]
# (launch, start, end) a frame: sky, bin, fetch, sample, light, the PS stage's own, the IBL tail
FRAME_OPS = [(200, 300, 800), (1_200, 1_300, 2_300), (5_200, 5_300, 5_500), (6_100, 6_200, 8_200),
             (10_100, 10_200, 11_200), (14_500, 14_600, 14_700), (18_100, 18_200, 18_700)]
# a step: its frame, then the backward, whose work autograd launches from its own thread
STEP_SPANS = [("step", None, 10, 19_000), ("frame", "step", 100, 8_000), ("step/backward", "step", 8_000, 18_000)]
STEP_OPS = [(200, 300, 5_000), (8_100, 8_200, 9_000), (9_500, 12_000, 13_000)]


def _ns(us: float) -> int:
    return T0_NS + int(round((us - T0_US) * 1000))


def synthetic(spans, ops, units=2, shift_frame_us=0.0, syncs=True):
    """A trace of ``units`` units and a recorder of the same window."""
    rec = profiling.Recorder()
    device, corr, launch = [], [], {}
    for u in range(units):
        o = T0_US + u * UNIT_US
        for name, parent, s, e in spans:
            d = shift_frame_us if name in program.ROOTS else 0.0
            rec.spans.append(profiling.SpanRecord(name, parent, MAIN, _ns(o + s + d), _ns(o + e + d)))
            if syncs and name.startswith("sync/"):
                rec.increments.append((_ns(o + s), name, 1))
        for i, (t, s, e) in enumerate(ops):
            c = u * 100 + i
            device.append((o + s, o + e, f"kernel{i}"))
            corr.append(c)
            launch[c] = o + t
    unit_spans = [(T0_US + u * UNIT_US, T0_US + (u + 1) * UNIT_US) for u in range(units)]
    window = (T0_US, T0_US + units * UNIT_US)
    tr = Trace(device=device, device_corr=corr, launch=launch, spans={"unit": unit_spans, "window": [window]},
               host=[], window=window, units=units)
    return tr, rec


def _read(name, tr, rec, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", rec)
    ctx = types.SimpleNamespace(loop=types.SimpleNamespace(port=port))
    return harness.load_metric(name).read(tr, ctx)


FRAME_WANT = {
    "host_syncs_per_frame.fwd": 3.0,  # edge_index, x, overflow
    "sync_wait_ms.fwd": 4.05,  # 0.9 + 0.15 + 3.0
    "bin_ms.fwd": 1.0,
    "ps_fetch_ms.fwd": 0.2,
    "ps_sample_ms.fwd": 2.0,
    "ps_light_ms.fwd": 1.0,
    "sky_ms.fwd": 0.5,
    # gaps opening in fetch (0.7), sample (2.0), light (3.4); the one opening in sync/x is left out
    "ps_idle_ms.fwd": 6.1,
}


@pytest.mark.parametrize("name", sorted(FRAME_WANT))
def test_frame_readers_on_a_synthetic_window(name, monkeypatch):
    tr, rec = synthetic(FRAME_SPANS, FRAME_OPS)
    assert _read(name, tr, rec, monkeypatch) == pytest.approx(FRAME_WANT[name])


def test_step_readers_on_a_synthetic_window(monkeypatch):
    tr, rec = synthetic(STEP_SPANS, STEP_OPS, syncs=False)
    # gaps opening in the backward: 3.0 + 7.3 (to the next unit's first work), 3.0 + 7.0 (to the window's end)
    assert _read("backward_idle_ms.train", tr, rec, monkeypatch) == pytest.approx(10.15)
    assert _read("host_syncs_per_step.train", tr, rec, monkeypatch) == 0.0


def test_work_launched_from_another_thread_is_placed_by_time(monkeypatch):
    tr, rec = synthetic(STEP_SPANS, STEP_OPS, syncs=False)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    prog = program.load(tr, types.SimpleNamespace(loop=types.SimpleNamespace(port=port)))
    assert prog.device_us_in("step/backward") == pytest.approx(2 * (800 + 1_000))
    assert prog.idle_us_by_innermost()[""] == pytest.approx(300)  # before the first step's span


@pytest.mark.parametrize("fault", ["frame_outside_its_unit", "no_recorder", "dropped", "nothing_recorded"])
def test_nothing_is_read_when_the_clock_or_the_recorder_fails(fault, monkeypatch):
    tr, rec = synthetic(FRAME_SPANS, FRAME_OPS, shift_frame_us=1_500.0 if fault == "frame_outside_its_unit" else 0.0)
    if fault == "no_recorder":
        rec = None
    elif fault == "dropped":
        rec.dropped = 1
    elif fault == "nothing_recorded":
        rec.spans.clear()
    for name in list(FRAME_WANT) + ["backward_idle_ms.train", "host_syncs_per_step.train"]:
        assert _read(name, tr, rec, monkeypatch) is None, name


def test_device_readers_read_nothing_without_device_work(monkeypatch):
    tr, rec = synthetic(FRAME_SPANS, [])
    assert _read("bin_ms.fwd", tr, rec, monkeypatch) is None
    assert _read("host_syncs_per_frame.fwd", tr, rec, monkeypatch) == 3.0


def test_spans_of_an_earlier_window_are_left_out(monkeypatch):
    tr, rec = synthetic(FRAME_SPANS, FRAME_OPS)
    early = [profiling.SpanRecord(r.name, r.parent, r.thread, r.t0 - 10**11, r.t1 - 10**11) for r in rec.spans]
    rec.spans[:0] = early
    rec.increments[:0] = [(t - 10**11, n, k) for t, n, k in rec.increments]
    assert _read("host_syncs_per_frame.fwd", tr, rec, monkeypatch) == 3.0
    assert _read("ps_idle_ms.fwd", tr, rec, monkeypatch) == pytest.approx(6.1)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pbr_scene.fwd", "rustediron_ibl.fwd", "pbr_scene.train"])
def test_the_sync_counter_equals_the_sync_warnings(cuda_device, cell):
    bench = harness.load_benchmark(ROOT)
    c = harness.find_cell(bench, cell)
    mix = harness.load_traffic(c["traffic"])
    loop = loops.LOOPS[mix["loop"]](port, harness.load_config(ROOT, bench, c["config"]), mix, SEED, "cuda")
    loop.setup()
    torch.cuda.synchronize()
    before = dict(profiling.RECORDER.totals)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            loop.unit(loop.next_index)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = sum(n - before.get(k, 0) for k, n in profiling.RECORDER.totals.items() if k.startswith("sync/"))
    warned = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    loop.release()
    assert counted == warned > 0, (counted, warned)
