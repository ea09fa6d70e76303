"""Timing and tracing — the counterpart of
``physically_based_renderer_tpu/utils/profiling.py`` (``D3DApp::
CalculateFrameStats``, ``d3dApp.cpp:598-628``, plus device-side timing).

``time_device_loop`` times a function on the card with CUDA events around a
run of calls after a warm-up (PyTorch returns before the card finishes, so a
host clock without a synchronise would time the enqueue); it needs a card
and raises without one. ``device_summary`` lists the devices.

**The recorder** (one per process, :data:`RECORDER`) holds the renderer's
own spans and counters:

* ``with span(name):`` marks a stretch of host work. Recording is on while a
  ``torch.profiler`` records (``torch.autograd._profiler_enabled()``) or
  inside :func:`recording`; off, a span costs one check and enters nothing.
  On, it keeps ``(name, parent, thread, t0, t1)`` in ``RECORDER.spans``
  (bounded; ``RECORDER.dropped`` counts what did not fit), the parent being
  the innermost span open on the same thread (autograd runs the card's
  backward on a thread of its own), and under a profiler it also opens
  ``record_function("pbr/<name>")``, so the span shows in the trace.
* The times are ``time.time_ns()``, Unix nanoseconds: the profiler's clock.
  A Chrome export writes ``ts = (t − baseTimeNanoseconds) / 1000`` µs, the
  base being Unix time floored to 7,889,238-s intervals, so every device
  operation and idle gap of a trace can be placed in the span that was open
  when it was launched or began.
* ``with sync(site):`` wraps one call that waits for the card: it counts
  ``sync/<site>`` every time and is the span ``sync/<site>`` (the wait).
* ``count(name, n)`` adds to ``RECORDER.totals`` always (no device read);
  while recording each increment is also logged with its time, so
  ``RECORDER.counts(t0, t1)`` reads a window. The kernels' launch counters
  are such counters (``launch/kernel<k>``), readable and settable under
  their old module names (``ops/raster_row.KERNEL_LAUNCHES`` …) through
  :func:`counters_as_attributes`.

Spans: ``frame`` (``renderer.render``), ``step`` and ``step/backward``
(``parallel/sharded.make_train_step``), ``sky`` (``renderer.background``),
``raster`` (the deferred path's G-buffer raster), ``raster/bin``
(``ops/raster_row.bin_for_shade``: setup, corner channels, binning; on the
card the kernel chain of ``csrc/raster_bin.cu``, counter ``launch/bin``),
``ps_stage`` with ``ps_stage/fetch``, ``ps_stage/sample`` and
``ps_stage/light`` (``renderer.shade_pixels``), ``ibl_tail``
(``renderer.ibl_compose``), and ``step/backward/ibl_tail``, the IBL tail's
share of a backward (a :class:`backward_span`, which also counts
``grad/ibl_tail`` once a backward through the tail). Sync sites:
``sync/world_up`` and ``sync/projection`` (the camera's matrices copied
from the host), ``sync/edge_index`` (``ops/raster._edge_coeffs``' index
lists: four a binning on the CPU path, none on the card, where only the
oracles ``rasterize`` / ``rasterize_brute`` reach it) and ``sync/overflow`` (the binning's overflow flag
read back by ``render``). ``PERF.md`` names the metric each is for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
import types
from typing import Callable, NamedTuple

import torch

PREFIX = "pbr/"  # the spans' names in a profiler trace
CAPACITY = 1 << 16  # spans (and, apart, logged counter increments) the recorder keeps
_profiler_enabled = torch.autograd._profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    parent: str | None  # the innermost span open on the same thread at entry
    thread: int  # threading.get_ident()
    t0: int  # time.time_ns() at entry (under a profiler, the middle of record_function's entry call)
    t1: int  # time.time_ns() after exit


class Recorder:
    """The spans and counters of one process (see the module docstring)."""

    def __init__(self):
        self.capacity = CAPACITY
        self.forced = 0  # depth of open recording() scopes
        self.totals: dict[str, int] = {}
        self.spans: list[SpanRecord] = []
        self.increments: list[tuple[int, str, int]] = []  # (time_ns, name, n), logged while recording
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def clear(self) -> None:
        """Forget the recorded spans and increments (the totals stay)."""
        with self._lock:
            self.spans.clear()
            self.increments.clear()
            self.dropped = 0

    def counts(self, t0: int | None = None, t1: int | None = None) -> dict[str, int]:
        """Sum of each counter's increments logged while recording, within
        [t0, t1] (``time.time_ns()``; None: unbounded)."""
        out: dict[str, int] = {}
        for t, name, n in list(self.increments):
            if (t0 is None or t >= t0) and (t1 is None or t <= t1):
                out[name] = out.get(name, 0) + n
        return out

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, buf: list, item) -> None:
        with self._lock:
            if len(buf) < self.capacity:
                buf.append(item)
            else:
                self.dropped += 1


RECORDER = Recorder()


@contextlib.contextmanager
def recording():
    """Record spans and counter increments in the scope without a profiler
    (no ``record_function`` is entered then)."""
    with RECORDER._lock:
        RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        with RECORDER._lock:
            RECORDER.forced -= 1


class span:
    """``with span(name):`` — a recorded stretch of host work (module
    docstring); a no-op unless recording is on at entry."""

    __slots__ = ("name", "_t0", "_parent", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0

    def __enter__(self):
        rec = RECORDER
        profiled = _profiler_enabled()
        if not (profiled or rec.forced):
            return self
        stack = rec._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._rf = torch.profiler.record_function(PREFIX + self.name) if profiled else None
        self._t0 = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
            self._t0 = (self._t0 + time.time_ns()) // 2  # the profiler stamps the range inside that call
        return self

    def __exit__(self, *exc) -> bool:
        if not self._t0:
            return False
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.time_ns()
        rec = RECORDER
        rec._stack().pop()
        rec._keep(rec.spans, SpanRecord(self.name, self._parent, threading.get_ident(), self._t0, t1))
        return False


class sync(span):
    """``with sync(site):`` around one call that waits for the card: counts
    ``sync/<site>`` always, and is the span ``sync/<site>`` while recording."""

    __slots__ = ()

    def __init__(self, site: str):
        super().__init__("sync/" + site)

    def __enter__(self):
        count(self.name)
        return super().__enter__()


class backward_span:
    """The span ``name`` over the autograd backward of a differentiable
    region of the forward, with the counter ``counter`` counted once a
    backward through it. :meth:`enter` takes the region's inputs and
    :meth:`exit` its output, each through an identity autograd Function
    (views, no launch) while grad is enabled: the output's backward opens
    the span, and the inputs' one backward, which runs after every node of
    the region has passed its gradient on, closes it. Both run on the
    thread autograd runs the region's backward on. With grad disabled,
    enter and exit hand back what they were given; with recording off the
    span costs its one check."""

    __slots__ = ("name", "counter", "_span", "_routed")

    def __init__(self, name: str, counter: str):
        self.name, self.counter = name, counter
        self._span = None
        self._routed = False

    def enter(self, *xs):
        """The region's inputs, those that need a gradient routed through
        the node that closes the span (None and the rest as they are)."""
        if not torch.is_grad_enabled():
            return xs
        at = [i for i, x in enumerate(xs) if x is not None and x.requires_grad]
        if not at:
            return xs
        self._routed = True
        out = list(xs)
        for i, y in zip(at, _SpanClose.apply(self, *(xs[i] for i in at))):
            out[i] = y
        return tuple(out)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """The region's output, through the node that opens the span."""
        if not (self._routed and torch.is_grad_enabled() and y.requires_grad):
            return y
        return _SpanOpen.apply(self, y)

    def _open(self) -> None:
        count(self.counter)
        self._span = span(self.name)
        self._span.__enter__()

    def _close(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None


class _SpanOpen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, region, y):
        ctx.region = region
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.region._open()
        return None, g


class _SpanClose(torch.autograd.Function):
    @staticmethod
    def forward(ctx, region, *xs):
        ctx.region = region
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.region._close()
        return (None, *gs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; while recording, log the increment."""
    rec = RECORDER
    rec.totals[name] = rec.totals.get(name, 0) + n
    if rec.forced or _profiler_enabled():
        rec._keep(rec.increments, (time.time_ns(), name, n))


def counters_as_attributes(module_name: str, names: dict[str, str]) -> None:
    """Give the module ``module_name`` attributes (the keys of ``names``) that
    read and set the recorder's counters (the values): ``mod.X`` is
    ``RECORDER.totals[names["X"]]``, and ``mod.X = 0`` resets it."""
    module = sys.modules[module_name]

    class CounterModule(types.ModuleType):
        def __getattr__(self, attr):  # only for names the module itself lacks
            if attr in names:
                return RECORDER.totals.get(names[attr], 0)
            raise AttributeError(f"module {module_name!r} has no attribute {attr!r}")

        def __setattr__(self, attr, value):
            if attr in names:
                RECORDER.totals[names[attr]] = value
            else:
                super().__setattr__(attr, value)

    module.__class__ = CounterModule


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


def device_summary() -> str:
    """The devices — the ``D3DApp::LogAdapters`` analog (``d3dApp.cpp:630-703``)."""
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    lines = [f"torch {torch.__version__}, backend={backend}"]
    for i in range(torch.cuda.device_count() if backend == "cuda" else 0):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"  device {i}: {p.name} ({p.total_memory / 2**30:.1f} GiB, {p.multi_processor_count} SMs)")
    return "\n".join(lines)
