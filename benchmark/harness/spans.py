"""Interval arithmetic over a traced sub-window's reduction: the device's
idle intervals (the complement of the union of its kernels', memcpys' and
memsets' intervals) and the host intervals of the program's named spans
(``utils/profiling.annotate`` regions), so that a reader can say how much
of the idle time lies inside which spans. Times in seconds from the
sub-window's start."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from harness.trace import Reduction

Intervals = List[Tuple[float, float]]


def union(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    """Sorted, disjoint ``(start, end)`` covering ``intervals``."""
    out: Intervals = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def minus(a: Intervals, b: Intervals) -> Intervals:
    """``a`` less ``b``, both as :func:`union` gives them."""
    out: Intervals = []
    for lo, hi in a:
        for blo, bhi in b:
            if bhi <= lo or blo >= hi:
                continue
            if blo > lo:
                out.append((lo, blo))
            lo = max(lo, bhi)
            if lo >= hi:
                break
        if lo < hi:
            out.append((lo, hi))
    return out


def overlap(a: Intervals, b: Intervals) -> float:
    """Length of ``a`` intersected with ``b``, both disjoint and sorted."""
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            total += min(hi, b[k][1]) - max(lo, b[k][0])
            k += 1
    return total


def idle(red: Reduction) -> Intervals:
    """The sub-window less the union of its device operations."""
    return minus([(0.0, red.window_s)],
                 union((s, s + d) for _, s, d in red.ops))


def named(red: Reduction, *names: str) -> Intervals:
    """Union of the host intervals of the spans called one of ``names``."""
    return union((s, s + d) for n, s, d in red.host if n in names)


def idle_share_in(red: Optional[Reduction], inside: Iterable[str],
                  less: Iterable[str] = ()) -> Optional[float]:
    """100 x the idle time inside the spans ``inside`` (less those of
    ``less``) over the sub-window; None where no span of ``inside`` was
    recorded (a program without them) or there is no trace."""
    if red is None or red.window_s <= 0:
        return None
    region = named(red, *inside)
    if not region:
        return None
    region = minus(region, named(red, *less))
    return 100.0 * overlap(idle(red), region) / red.window_s
