"""The arithmetic of the end-to-end metrics and of the device's busy
time."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over every value given."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
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


def idle_gaps(intervals, start: float, end: float):
    """The (start, end) gaps inside [start, end] that no interval covers."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(a, b) for a, b in gaps if b > a]
