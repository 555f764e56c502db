"""Metric arithmetic on timelines: unions of intervals, the drain rule, a
percentile, and the operations of the steps in a window.  Plain Python
over numbers the harness recorded; no device and no program.  A model's
useful operations are its architecture's (``archs/<arch>.py``,
``step_flops``)."""
from __future__ import annotations

import bisect
import math
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def overlap(a: float, b: float, merged: Sequence[Interval]) -> float:
    """Length of [a, b] covered by ``merged`` (a ``union``)."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def overlaps(spans: Sequence[Interval], merged: Sequence[Interval]
             ) -> List[float]:
    """``overlap(a, b, merged)`` of each span [a, b], each found by
    bisection: the intervals that end at or before a, or start at or after
    b, add a term of 0 to ``overlap``'s sum, so the sum of the others, in
    the same order, is the same number."""
    ends = [y for _, y in merged]
    out = []
    for a, b in spans:
        i = bisect.bisect_right(ends, a)
        j = i
        while j < len(merged) and merged[j][0] < b:
            j += 1
        out.append(sum(max(0.0, min(b, y) - max(a, x))
                       for x, y in merged[i:j]))
    return out


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile as the ceil(q n)-th smallest value."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def rows_per_s(queries: Sequence[Dict], t0: float) -> float:
    """Closed loop: every row of the queries the window submitted, over
    the time from the window's start to the end of the last of them (the
    drain included, so no query is cut at the edge)."""
    done = [q for q in queries if q["ok"]]
    end = max(q["end"] for q in queries)
    return sum(q["rows"] for q in done) / (end - t0)


def window_flops(steps: Sequence[tuple], lo: float, hi: float) -> float:
    """The operations of the steps (kind, t0, t1, tokens, ops) that fall in
    [lo, hi], a step across an edge counted for its share inside."""
    total = 0.0
    for _, a, b, _, ops in steps:
        inside = max(0.0, min(b, hi) - max(a, lo))
        total += ops * (inside / (b - a) if b > a else float(lo <= a <= hi))
    return total

