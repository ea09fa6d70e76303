"""The program's own spans and counters, read beside the profiler's trace.

The program records them itself (``utils/profiling`` of the port: spans
``(name, parent, thread, t0, t1)`` in Unix nanoseconds and counter
increments, kept while a profiler records). The readers reach that recorder
through ``ctx.loop.port``; a program without one reads nothing, and every
reader built on this module then returns None.

The spans' clock is the profiler's: the Chrome export writes
``ts = (t − base) / 1000`` µs, the base being Unix time floored to
7,889,238-s intervals. Before anything is read the clock is checked: every
``frame`` or ``step`` span of the window must lie inside exactly one of the
benchmark's ``unit`` spans, or nothing is read. Each device operation is
placed under the program spans open at its launch time (on any thread:
autograd launches the backward from its own), each idle gap of the card
under the main thread's spans open where the gap begins.

    python3 -m gpu_bench.program --workload <cell> --seed <n>

runs the cell traced and prints, a unit, the idle time of the card and the
device time by the innermost program span."""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib
import json
import os
import sys
import time

from .stats import merged, union_length

TRIMONTH_S = 7_889_238  # the Chrome export's base: Unix time floored to these intervals
ROOTS = ("frame", "step")  # the program's spans of one unit


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    parent: str | None
    thread: int
    start: float  # µs on the trace's clock
    end: float


def recorder(port):
    """The port's recorder, or None where the program has none."""
    try:
        profiling = importlib.import_module(port.__name__ + ".utils.profiling")
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def base_ns(t_ns: int) -> int:
    """The Chrome export's base for a time ``t_ns`` (Unix ns)."""
    return (t_ns // 10**9 // TRIMONTH_S) * TRIMONTH_S * 10**9


def clock_holds(spans: list, units: list) -> bool:
    """Every ``frame``/``step`` span lies inside exactly one ``unit`` span
    (and there is at least one)."""
    roots = [s for s in spans if s.name in ROOTS]
    return bool(roots) and all(sum(u0 <= s.start and s.end <= u1 for u0, u1 in units) == 1 for s in roots)


class Program:
    """The recorded spans and counts of one traced window, on the trace's clock."""

    def __init__(self, trace, spans: list, counts: dict):
        self.trace, self.spans, self.counts = trace, spans, counts
        threads: dict = {}
        for s in spans:
            if s.name in ROOTS:
                threads[s.thread] = threads.get(s.thread, 0) + 1
        self.main = max(threads, key=threads.get)
        # outermost spans of the main thread, and every span (any thread) inside each
        outer = sorted((s for s in spans if s.thread == self.main and s.parent is None), key=lambda s: s.start)
        self._outer_starts = [s.start for s in outer]
        self._outer = outer
        self._members = [[m for m in spans if o.start <= m.start and m.end <= o.end] for o in outer]
        self._gaps = None

    def containing(self, t: float, main_only: bool = False) -> list:
        """The spans open at ``t``, innermost first."""
        i = bisect.bisect_right(self._outer_starts, t) - 1
        if i < 0 or t > self._outer[i].end:
            return []
        out = [m for m in self._members[i] if m.start <= t <= m.end and (not main_only or m.thread == self.main)]
        return sorted(out, key=lambda m: m.end - m.start)

    def device_us_in(self, name: str) -> float:
        """Device time of the operations launched inside a span of ``name``."""
        ranges = merged((s.start, s.end) for s in self.spans if s.name == name)
        if not ranges:
            return 0.0
        starts = [r[0] for r in ranges]
        total = 0.0
        for (s, e, _), c in zip(self.trace.device, self.trace.device_corr):
            t = self.trace.launch.get(c)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += e - s
        return total

    def device_us_by_innermost(self) -> dict:
        """Device time by the innermost span open at each operation's launch."""
        out: dict = {}
        for (s, e, _), c in zip(self.trace.device, self.trace.device_corr):
            t = self.trace.launch.get(c)
            inner = self.containing(t) if t is not None else []
            key = inner[0].name if inner else ""
            out[key] = out.get(key, 0.0) + (e - s)
        return out

    def gaps(self) -> list:
        """The card's idle gaps inside the window: (start, end, the main
        thread's spans open at the start, innermost first)."""
        if self._gaps is None:
            w0, w1 = self.trace.window
            busy = merged((max(s, w0), min(e, w1)) for s, e, _ in self.trace.device)
            gaps, prev = [], w0
            for s, e in busy:
                if s > prev:
                    gaps.append((prev, s))
                prev = max(prev, e)
            if w1 > prev:
                gaps.append((prev, w1))
            self._gaps = [(s, e, self.containing(s, main_only=True)) for s, e in gaps]
        return self._gaps

    def idle_us_opening_in(self, name: str, not_prefix: str | None = None) -> float:
        """Idle time of the gaps that open inside a span of ``name``, less
        those whose innermost span starts with ``not_prefix``."""
        total = 0.0
        for s, e, open_spans in self.gaps():
            if any(o.name == name for o in open_spans):
                if not_prefix is None or not open_spans[0].name.startswith(not_prefix):
                    total += e - s
        return total

    def idle_us_by_innermost(self) -> dict:
        out: dict = {}
        for s, e, open_spans in self.gaps():
            key = open_spans[0].name if open_spans else ""
            out[key] = out.get(key, 0.0) + (e - s)
        return out

    def host_us(self, prefix: str) -> float:
        """Host time inside the spans whose name starts with ``prefix``."""
        return union_length((s.start, s.end) for s in self.spans if s.name.startswith(prefix))

    def count(self, prefix: str) -> int:
        return sum(n for name, n in self.counts.items() if name.startswith(prefix))


_LAST: list = [None, None]  # (trace, Program) of the last window read


def load(trace, ctx) -> Program | None:
    """The program's spans and counts of ``trace``'s window, or None where
    the program records none, dropped some, or the clock check fails."""
    if _LAST[0] is trace:
        return _LAST[1]
    prog = None
    rec = recorder(ctx.loop.port)
    if rec is not None and not rec.dropped and rec.spans:
        base = base_ns(rec.spans[-1].t1)  # the latest span, nearest the export
        w0, w1 = trace.window
        spans = [Span(r.name, r.parent, r.thread, (r.t0 - base) / 1000.0, (r.t1 - base) / 1000.0) for r in rec.spans]
        spans = [s for s in spans if s.end >= w0 and s.start <= w1]
        if clock_holds(spans, trace.spans.get("unit", [])):
            counts = rec.counts(base + int(w0 * 1000), base + int(w1 * 1000))
            prog = Program(trace, spans, counts)
    _LAST[0], _LAST[1] = trace, prog
    return prog


def per_unit_ms(trace, us: float) -> float:
    return us / trace.units * 1e-3


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, root)
    from gpu_bench import harness, program

    bench = harness.load_benchmark(root)
    line = harness.run_cell(root, bench, harness.find_cell(bench, args.workload), seed=args.seed, seconds=0.0,
                            traced=True, device="cuda", t_start=time.perf_counter())
    trace, prog = program._LAST
    if prog is None:
        print("gpu_bench: the program recorded nothing, or its clock failed the check", file=sys.stderr)
        return 1
    table = {
        "idle_ms_a_unit": {k: per_unit_ms(trace, v) for k, v in prog.idle_us_by_innermost().items()},
        "device_ms_a_unit": {k: per_unit_ms(trace, v) for k, v in prog.device_us_by_innermost().items()},
        "units": trace.units, "window_ms": trace.window_us * 1e-3, "metrics": line["metrics"],
    }
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
