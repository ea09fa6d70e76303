"""The ``rustediron_ibl.train`` cell: inverse rendering of the rusted-iron
sphere's maps under IBL (configuration ``rustediron_ibl_inverse``: the
``rustediron_ibl`` scene, unchanged, as an inverse-rendering deployment).

On the CPU: the configuration holds the IBL sample's scene; at 128×64, the
port against the reference's SGD steps through the whole harness; the
control (TF32 operands) over the cell's limits; the two readers of the IBL
tail's backward on a synthetic window whose span is open on autograd's own
thread, and reading nothing where the program has no such span; a traced
small run that records the span once a step. On the card (``-m cuda``): a
traced run at the test size reads both metrics, and 60 steps at 1080p on
seed 5, where a reflect direction meets a pole, keep every loss finite."""

from __future__ import annotations

import math
import time
import types

import pytest
import torch

import physically_based_renderer_tpu_torch as port
from gpu_bench import check, harness, loops, program
from gpu_bench.control import control_numbers
from physically_based_renderer_tpu_torch.utils import profiling

from .conftest import ROOT, SEED, run_small, small
from .test_bench_program import MAIN, T0_US, UNIT_US, _ns, synthetic

CELL = "rustediron_ibl.train"
SPAN = "step/backward/ibl_tail"
READERS = ["ibl_backward_ms.train", "ibl_backward_idle_ms.train"]
AUTOGRAD = 2  # the thread autograd runs the card's backward on


def test_the_cells_configuration_is_the_ibl_sample_scene_number_for_number():
    """The deployment adds what inverse rendering states (what it optimises,
    what is known, the loss) to ``rustediron_ibl``'s scene and changes none
    of it."""
    bench = harness.load_benchmark(ROOT)
    cfg = harness.load_config(ROOT, bench, harness.find_cell(bench, CELL)["config"])
    scene = harness.load_config(ROOT, bench, "rustediron_ibl")
    assert cfg["name"] != scene["name"] and cfg["inverse"]
    described = {"name", "source", "assumed", "inverse"}
    assert {k: v for k, v in cfg.items() if k not in described} == {
        k: v for k, v in scene.items() if k not in described}


def test_port_matches_reference():
    res = run_small(CELL)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    checks = {k: c["value"] for k, c in res["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap_median"] < 1e-4 and checks["change_gap_median"] < 1e-4
    assert checks["non_finite"] == 0.0


def test_control_fails_the_limits():
    numbers = control_numbers(ROOT, CELL, SEED, "cpu", small(CELL))
    limits = check.load_limits(f"{ROOT}/gpu_bench", CELL)
    above = [k for k in ("loss_gap", "grad_gap_median", "change_gap_median") if numbers[k] > limits[k]]
    assert above, (numbers, limits)


# a step: its frame, then the backward (main thread) and inside it the IBL
# tail's share, which autograd's thread opens and closes
STEP_SPANS = [("step", None, 10, 19_000), ("frame", "step", 100, 8_000), ("step/backward", "step", 8_000, 18_000)]
TAIL = (8_200, 11_000)
# (launch, start, end): the forward; two launches in the tail; one after it
STEP_OPS = [(200, 300, 5_000), (8_300, 8_400, 9_000), (9_500, 9_600, 10_000), (12_000, 12_500, 13_000)]


def _window(with_tail: bool):
    tr, rec = synthetic(STEP_SPANS, STEP_OPS, syncs=False)
    if with_tail:
        for u in range(tr.units):
            o = T0_US + u * UNIT_US
            rec.spans.append(profiling.SpanRecord(SPAN, None, AUTOGRAD, _ns(o + TAIL[0]), _ns(o + TAIL[1])))
    return tr, rec


def _read(name, tr, rec, monkeypatch):
    monkeypatch.setattr(profiling, "RECORDER", rec)
    ctx = types.SimpleNamespace(loop=types.SimpleNamespace(port=port))
    return harness.load_metric(name).read(tr, ctx)


def test_readers_place_the_tails_work_and_gaps_by_time_on_any_thread(monkeypatch):
    tr, rec = _window(with_tail=True)
    assert all(r.thread != MAIN for r in rec.spans if r.name == SPAN)
    # device: 0.6 + 0.4 ms launched inside the tail; idle: the gaps opening at 9.0 (0.6 ms) and at 10.0
    # (2.5 ms) ms into the step, not the one at 13.0 ms, which opens after the tail has closed
    assert _read("ibl_backward_ms.train", tr, rec, monkeypatch) == pytest.approx(1.0)
    assert _read("ibl_backward_idle_ms.train", tr, rec, monkeypatch) == pytest.approx(3.1)
    # the main thread's view, program.idle_us_opening_in, sees none of it
    prog = program.load(tr, types.SimpleNamespace(loop=types.SimpleNamespace(port=port)))
    assert prog.idle_us_opening_in(SPAN) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_span(name, monkeypatch):
    """A program without the span (one older than it) reads nothing."""
    tr, rec = _window(with_tail=False)
    assert _read(name, tr, rec, monkeypatch) is None
    tr, rec = _window(with_tail=True)
    assert _read(name, tr, None, monkeypatch) is None


def test_a_traced_small_run_records_the_tails_span_once_a_step():
    """On the CPU the readers find no device work, so the line leaves both
    metrics out; what they read is there: one tail span inside each traced
    step's backward, and one ``grad/ibl_tail`` a step."""
    profiling.RECORDER.clear()
    res = run_small(CELL, traced=True)
    assert res["correct"], res["checks"]
    assert not set(READERS) & set(res["metrics"])
    units = int(harness.load_traffic("train")["trace_units"])
    tails = [r for r in profiling.RECORDER.spans if r.name == SPAN]
    backs = [r for r in profiling.RECORDER.spans if r.name == "step/backward"]
    assert len(tails) == len(backs) == units
    assert all(b.t0 <= t.t0 and t.t1 <= b.t1 for t, b in zip(tails, backs))
    assert profiling.RECORDER.counts().get("grad/ibl_tail") == units


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_both_metrics(cuda_device):
    bench = harness.load_benchmark(ROOT)
    res = harness.run_cell(ROOT, bench, harness.find_cell(bench, CELL), seed=SEED, seconds=0.0, traced=True,
                           device="cuda", t_start=time.perf_counter(), cfg_overrides=small(CELL))
    assert res["correct"], res["checks"]
    for name in READERS:
        assert res["metrics"].get(name) is not None, res["metrics"]
    assert res["metrics"]["ibl_backward_ms.train"]["value"] > 0.0


@pytest.mark.cuda
def test_sixty_steps_at_1080p_on_a_pole_seed_stay_finite(cuda_device):
    """Seed 5 met a pole at step 8 before the sky mapping had a gradient of
    its own (NaN material gradients, then a device assert in the mip-LOD
    fetch)."""
    bench = harness.load_benchmark(ROOT)
    c = harness.find_cell(bench, CELL)
    mix = harness.load_traffic(c["traffic"])
    loop = loops.LOOPS[mix["loop"]](port, harness.load_config(ROOT, bench, c["config"]), mix, 5, "cuda")
    before = profiling.RECORDER.totals.get("grad/ibl_tail", 0)
    loop.setup()
    losses = list(loop.losses)
    while len(losses) < 60:
        loop.unit(loop.next_index)
        loop.next_index += 1
        losses.append(float(loop.loss))
    bank = loop._bank()
    loop.release()
    assert all(math.isfinite(x) for x in losses), losses
    assert all(bool(torch.isfinite(v).all()) for v in bank.values())
    assert profiling.RECORDER.totals["grad/ibl_tail"] - before == 60
