"""The arithmetic of the end-to-end metrics and of their spread."""

from __future__ import annotations

import math
import statistics


def rate(units: int, window_s: float) -> float:
    """Units completed in the window over the window's length."""
    if window_s <= 0.0:
        raise ValueError("an empty window has no rate")
    return units / window_s


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least q%
    of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def spread(values) -> float:
    """Distance between the first and third quartiles (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    """(start, end) intervals merged where they overlap, in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
