"""The port's recorder (``utils/profiling``): spans and counters inside the
renderer, on the profiler's clock.

On the CPU at 128×64 (32² pages, 16×8 spheres): with recording off nothing
is recorded and no ``record_function`` is entered; a textured frame, an IBL
frame with its sky and one training step record the span tree the module
docstring names; an IBL training step brackets the tail's backward in
``step/backward/ibl_tail`` and counts ``grad/ibl_tail`` once, and an IBL
frame without a gradient applies none of the tail's autograd Functions; the spans match the exported Chrome trace's ``pbr/``
events (each start and end within 1 ms, the medians within 20 µs, the
export's base the Unix time floored to 7,889,238-s intervals); the sync
count a frame is the same every frame; the buffer stays bounded and counts
what it drops; every launch counter reads and sets under its old module
name. No JAX."""

from __future__ import annotations

import dataclasses
import json
import statistics
import threading
import time

import pytest
import torch

import physically_based_renderer_tpu_torch as pbr
from chip_smoke import fill_asset_cache, seeded_background, seeded_env, seeded_texture_pages
from physically_based_renderer_tpu_torch.ops import ps_light, raster_bin, raster_pallas, raster_row
from physically_based_renderer_tpu_torch.ops.texture import sky_u8
from physically_based_renderer_tpu_torch.utils import profiling

W, H, TEX = 128, 64, 32
REC = profiling.RECORDER
FRAME_SYNCS = {"sync/world_up": 1, "sync/projection": 1, "sync/edge_index": 4, "sync/overflow": 1}
TEXTURED_TREE = {
    ("frame", None), ("raster", "frame"), ("raster/bin", "raster"), ("sync/edge_index", "raster/bin"),
    ("ps_stage", "frame"), ("ps_stage/fetch", "ps_stage"), ("ps_stage/sample", "ps_stage"),
    ("ps_stage/light", "ps_stage"), ("sync/overflow", "frame"), ("sync/world_up", "frame"),
    ("sync/projection", "frame"),
}


@pytest.fixture(scope="module")
def cache():
    return fill_asset_cache(pbr.scenes.AssetCache(texture_size=TEX), seeded_texture_pages(5, TEX))


@pytest.fixture(scope="module")
def textured(cache):
    scene = pbr.scenes.pbr_scene(cache, texture_size=TEX, slices=16, stacks=8, device="cpu")
    return scene.with_combined_textures(mode="quad")


@pytest.fixture(scope="module")
def ibl_scene(cache):
    scene = pbr.scenes.rustediron_sphere_scene(cache, texture_size=TEX, device="cpu")
    sky = sky_u8(torch.as_tensor(seeded_background(4, 32, 64)))
    scene = dataclasses.replace(scene, env_map=torch.as_tensor(seeded_env(3, 32, 64)), sky_map=sky)
    return scene.with_ibl().with_combined_textures(mode="quad")


def _camera(z=-18.0, yaw=0.0):
    return pbr.Camera.create(position=(0.0, -3.0 if z < -5 else 0.0, z), yaw=yaw, aspect=W / H, device="cpu")


@pytest.fixture(autouse=True)
def _clean():
    REC.clear()
    yield
    REC.clear()


def _tree():
    return {(r.name, r.parent) for r in REC.spans}


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_records_nothing_and_enters_no_record_function(textured, monkeypatch):
    _no_record_function(monkeypatch)
    before = dict(REC.totals)
    pbr.render(textured, _camera(), width=W, height=H)
    assert REC.spans == [] and REC.increments == [] and REC.dropped == 0 and REC.forced == 0
    # the counters count with recording off
    assert {k: REC.totals[k] - before.get(k, 0) for k in FRAME_SYNCS} == FRAME_SYNCS


def test_recording_without_a_profiler_enters_no_record_function(textured, monkeypatch):
    _no_record_function(monkeypatch)
    with profiling.recording():
        pbr.render(textured, _camera(), width=W, height=H)
    assert _tree() == TEXTURED_TREE


@pytest.mark.parametrize("kind", ["textured", "ibl"])
def test_a_frame_records_the_span_tree(textured, ibl_scene, kind):
    scene, cam = (textured, _camera()) if kind == "textured" else (ibl_scene, _camera(-2.5))
    with profiling.recording():
        pbr.render(scene, cam, width=W, height=H)
    want = TEXTURED_TREE | ({("sky", "frame"), ("ibl_tail", "frame")} if kind == "ibl" else set())
    assert _tree() == want
    for r in REC.spans:  # each child inside its parent, in time
        if r.parent is not None:
            assert any(p.name == r.parent and p.t0 <= r.t0 and r.t1 <= p.t1 for p in REC.spans), r
    assert REC.counts() == FRAME_SYNCS


def test_a_train_step_records_the_span_tree(textured):
    step = pbr.make_train_step(width=W, height=H)
    target = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(0))
    with profiling.recording():
        step(textured, _camera(), target)
    tree = _tree()
    assert {("step", None), ("frame", "step"), ("step/backward", "step")} <= tree
    assert tree - {("step", None), ("frame", "step"), ("step/backward", "step")} == TEXTURED_TREE - {("frame", None)}
    assert REC.counts() == FRAME_SYNCS  # the material step's backward waits for nothing


def _innermost_at_backward(monkeypatch, cls, seen: list, key: str):
    """Patch ``cls``'s backward to note the innermost span open on its thread."""
    inner = cls.backward

    def backward(ctx, *grads):
        stack = REC._stack()
        seen.append((key, stack[-1] if stack else None))
        return inner(ctx, *grads)

    monkeypatch.setattr(cls, "backward", staticmethod(backward))


def test_an_ibl_train_step_brackets_the_tails_backward(ibl_scene, monkeypatch):
    """The IBL tail's share of the backward is the span
    ``step/backward/ibl_tail`` (on the CPU autograd runs it on the caller's
    thread, inside ``step/backward``): the sky mapping's derivative runs
    inside it, the material fetch's backward after it has closed, and
    ``grad/ibl_tail`` counts one a step."""
    from physically_based_renderer_tpu_torch.ops import fetch, sky

    seen: list = []
    _innermost_at_backward(monkeypatch, sky._WorldToSkyUV, seen, "sky")
    _innermost_at_backward(monkeypatch, fetch._FetchColumns, seen, "fetch")
    step = pbr.make_train_step(width=W, height=H)
    target = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(0))
    before = REC.totals.get("grad/ibl_tail", 0)
    with profiling.recording():
        scene, _ = step(ibl_scene, _camera(-2.5), target)
        step(scene, _camera(-2.5, yaw=0.4), target)
    tails = [r for r in REC.spans if r.name == "step/backward/ibl_tail"]
    backs = [r for r in REC.spans if r.name == "step/backward"]
    assert len(tails) == len(backs) == 2 and all(r.parent == "step/backward" for r in tails)
    assert all(b.t0 <= t.t0 and t.t1 <= b.t1 for t, b in zip(tails, backs))
    assert REC.counts().get("grad/ibl_tail") == 2 == REC.totals["grad/ibl_tail"] - before
    assert {k for k, _ in seen} == {"sky", "fetch"}
    assert all(inner == ("step/backward/ibl_tail" if k == "sky" else "step/backward") for k, inner in seen), seen


@pytest.mark.parametrize("grad", ["disabled", "nothing_tracked"])
def test_an_ibl_frame_without_a_gradient_adds_nothing_to_the_tail(ibl_scene, monkeypatch, grad):
    """Without a gradient to track, the tail applies no autograd Function,
    the sky mapping runs its plain formula, and nothing is counted."""
    from physically_based_renderer_tpu_torch.ops import sky

    def refuse(*a, **k):
        raise AssertionError("an autograd Function applied")

    for cls in (profiling._SpanOpen, profiling._SpanClose, sky._WorldToSkyUV):
        monkeypatch.setattr(cls, "apply", refuse)
    before = REC.totals.get("grad/ibl_tail", 0)
    with profiling.recording(), torch.set_grad_enabled(grad != "disabled"):
        img = pbr.render(ibl_scene, _camera(-2.5), width=W, height=H)
    assert img.grad_fn is None and not img.requires_grad
    assert ("step/backward/ibl_tail", None) not in _tree() and "grad/ibl_tail" not in REC.counts()
    assert REC.totals.get("grad/ibl_tail", 0) == before


def test_the_sync_count_a_frame_is_deterministic(textured):
    counts = []
    for yaw in (0.0, 0.0, 0.3):
        with profiling.recording():
            t0 = time.time_ns()
            pbr.render(textured, _camera(yaw=yaw), width=W, height=H)
            counts.append(REC.counts(t0, time.time_ns()))
    assert counts == [FRAME_SYNCS] * 3


def test_spans_match_the_chrome_trace(textured, ibl_scene, tmp_path):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        for _ in range(2):
            pbr.render(textured, _camera(), width=W, height=H)
        pbr.render(ibl_scene, _camera(-2.5), width=W, height=H)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc["baseTimeNanoseconds"]
    assert base == (REC.spans[0].t0 // 10**9 // 7_889_238) * 7_889_238 * 10**9
    events: dict = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("name", "").startswith(profiling.PREFIX):
            events.setdefault(ev["name"][len(profiling.PREFIX):], []).append((float(ev["ts"]), float(ev["dur"])))
    spans: dict = {}
    for r in REC.spans:
        spans.setdefault(r.name, []).append(((r.t0 - base) / 1000.0, (r.t1 - base) / 1000.0))
    assert {k: len(v) for k, v in events.items()} == {k: len(v) for k, v in spans.items()}
    starts, ends = [], []
    for name, evs in events.items():
        for (ts, dur), (s, e) in zip(sorted(evs), sorted(spans[name])):
            starts.append(ts - s)
            ends.append(e - (ts + dur))
    assert all(abs(d) < 1000.0 for d in starts + ends), (min(starts + ends), max(starts + ends))
    assert abs(statistics.median(starts)) < 20.0 and abs(statistics.median(ends)) < 20.0


def test_the_buffer_stays_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(REC, "capacity", 5)
    with profiling.recording():
        for _ in range(8):
            with profiling.span("x"):
                profiling.count("test/bounded")
    assert len(REC.spans) == 5 and len(REC.increments) == 5 and REC.dropped == 6
    REC.clear()
    assert REC.spans == [] and REC.dropped == 0


def test_the_parent_is_the_same_threads_open_span():
    seen = []

    def worker():
        with profiling.span("other"):
            seen.append(threading.get_ident())

    with profiling.recording():
        with profiling.span("outer"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            with profiling.span("inner"):
                pass
    assert not t.is_alive()
    assert {(r.name, r.parent) for r in REC.spans} == {("outer", None), ("other", None), ("inner", "outer")}
    assert next(r.thread for r in REC.spans if r.name == "other") == seen[0] != threading.get_ident()


COUNTER_NAMES = [(mod, k, v) for mod in (raster_row, raster_pallas, ps_light, raster_bin)
                 for k, v in mod.COUNTERS.items()]


@pytest.mark.parametrize("module, attr, counter", COUNTER_NAMES, ids=[c[1] for c in COUNTER_NAMES])
def test_every_launch_counter_reads_and_sets_under_its_module_name(module, attr, counter):
    saved = getattr(module, attr)
    try:
        setattr(module, attr, 0)
        assert REC.totals[counter] == 0 and attr not in vars(module)
        profiling.count(counter, 2)
        assert getattr(module, attr) == 2
        setattr(module, attr, getattr(module, attr) + 1)  # a caller's own bump
        assert REC.totals[counter] == 3
    finally:
        setattr(module, attr, saved)
