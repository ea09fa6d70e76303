"""Idle time of the card a step in the gaps that open while the program's
``step/backward/ibl_tail`` span is open: the card waiting for autograd to
enqueue the IBL tail's backward. The span is open on autograd's own thread,
so a gap is placed by time against the span on any thread (``program``'s
``idle_us_opening_in`` looks at the main thread's spans only). A program
without the span reads nothing."""

import bisect

from gpu_bench import program
from gpu_bench.stats import merged

SOURCE = "device_trace"
SPAN = "step/backward/ibl_tail"


def read(trace, ctx):
    prog = program.load(trace, ctx)
    if prog is None or not trace.device:
        return None
    ranges = merged((s.start, s.end) for s in prog.spans if s.name == SPAN)
    if not ranges:
        return None
    starts = [r[0] for r in ranges]
    total = 0.0
    for s, e, _ in prog.gaps():
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= ranges[i][1]:
            total += e - s
    return program.per_unit_ms(trace, total)
