"""Arithmetic of the metrics: percentiles of latencies and the union of
device intervals."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between closest
    ranks (numpy's default), of a non-empty sequence."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of intervals, clipped to [lo, hi] where given."""
    total = 0.0
    for s, e in merge(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        total += max(0.0, e - s)
    return total


def gaps(intervals) -> list[tuple[float, float]]:
    """The idle stretches between the union's pieces."""
    m = merge(intervals)
    return [(a[1], b[0]) for a, b in zip(m, m[1:]) if b[0] > a[1]]
