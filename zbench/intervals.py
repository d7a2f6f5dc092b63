"""Interval arithmetic of the measurement: rates, tails, unions and the
host phase open at each moment.  Times are seconds (host clock) or
microseconds (trace clock); nothing here cares which."""

from __future__ import annotations

import math


def p95(values) -> float:
    """The 95th percentile by the nearest rank: the smallest value with at
    least 95% of all values at or below it, over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, merged ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def overlap(a, b) -> float:
    """Total length of the intersection of two interval sets."""
    ua, ub = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(ua) and j < len(ub):
        s = max(ua[i][0], ub[j][0])
        e = min(ua[i][1], ub[j][1])
        if e > s:
            total += e - s
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return total


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out = []
    at = lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def innermost(spans) -> list[tuple[float, float, str]]:
    """Cut nested ``(start, end, name)`` spans (one thread's, so each pair
    is nested or apart) into pieces that do not overlap, each named by the
    innermost span open there."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    at = 0.0

    def emit(upto, name):
        if upto > at:
            out.append((at, upto, name))

    for span in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= span[0]:
            top = stack.pop()
            emit(top[1], top[2])
            at = max(at, top[1])
        if stack:
            emit(span[0], stack[-1][2])
        at = span[0]
        stack.append(span)
    while stack:
        top = stack.pop()
        emit(top[1], top[2])
        at = max(at, top[1])
    return out


def labelled_overlap(pieces, intervals) -> dict[str, float]:
    """Length of ``intervals`` under each name of :func:`innermost` pieces."""
    out: dict[str, float] = {}
    iv = union(intervals)
    j = 0
    for s, e, name in pieces:
        while j < len(iv) and iv[j][1] <= s:
            j += 1
        k = j
        while k < len(iv) and iv[k][0] < e:
            d = min(e, iv[k][1]) - max(s, iv[k][0])
            if d > 0:
                out[name] = out.get(name, 0.0) + d
            k += 1
    return out
