"""The device's timeline from ``torch.profiler``: its raw device events
(``kineto_results.events()``: building ``key_averages()`` over ~10^5
launches takes minutes, and it counts a kernel under its op and again as
itself), their union as the busy time, the operations that took most of
it, and the idle gaps named by what the host was doing."""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Sequence, Tuple

from aisqlbench import timeline


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, duration ns) of each kernel and copy recorded."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class HostClock:
    """perf_counter seconds as the profiler's Unix-epoch nanoseconds."""

    def __init__(self):
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def ns(self, t: float) -> float:
        return t * 1e9 + self.offset_ns


def clip(events, lo_ns: float, hi_ns: float):
    return [(n, max(a, lo_ns), min(a + d, hi_ns)) for n, a, d in events
            if a + d > lo_ns and a < hi_ns]


def busy_s(clipped) -> float:
    return timeline.length((a, b) for _, a, b in clipped) / 1e9


def top_ops(clipped, n: int = 10) -> List[List]:
    by: Dict[str, float] = {}
    for name, a, b in clipped:
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
    return [[k[:120], v] for k, v in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:n]]


def idle_gaps(clipped, host: Sequence[Tuple[str, Sequence]],
              lo_ns: float, hi_ns: float, n: int = 10) -> List[List]:
    """The device's idle time in [lo, hi], summed by what the host was
    doing at each gap's middle: ``host`` is (label, intervals in ns) from
    the innermost activity out; a gap in none reads "outside the engine"."""
    busy = timeline.union((a, b) for _, a, b in clipped)
    gaps, t = [], lo_ns
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi_ns > t:
        gaps.append((t, hi_ns))
    merged = [(label, timeline.union(iv)) for label, iv in host]
    starts = [[a for a, _ in iv] for _, iv in merged]
    by: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "outside the engine"
        for (name, iv), st in zip(merged, starts):
            i = bisect.bisect_right(st, mid) - 1
            if i >= 0 and iv[i][1] >= mid:
                label = name
                break
        by[label] = by.get(label, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
