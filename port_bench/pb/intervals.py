"""Interval arithmetic over a device trace.

The idle share of `profile_run` in `juicer_tpu_torch/harness/
profile_decode.py` (commit 103de7f) is 1 - (sum of kernel durations) /
wall time; that leaves out copies and counts twice the time in which two
kernels overlap. Here the device is busy where any kernel, copy or set
runs: the union of their intervals.
"""

from __future__ import annotations


def union(intervals):
    """Sorted, disjoint (start, end) covering the same time as
    `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    """The parts of `intervals` inside [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals, lo, hi) -> float:
    """Time within [lo, hi] covered by at least one interval."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals, lo, hi):
    """The (start, end) of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out
