"""Share of the traced window in which the card sat idle while the host was
inside a step's ``step.forward`` phase (%): the host launching the layers
and the card waiting on it.  The complement of the union of the profiler's
device events, inside the union of the forward spans mapped to the
profiler's clock, over the window; at most ``idle_share.batch``."""
from aisqlbench import spans, timeline


def read(run):
    if run.window_ns is None or spans.window_steps(run) is None:
        return None
    lo, hi = run.window_ns
    off = spans.offset_ns(run)
    fwd = timeline.union(
        (max(p["t0"] * 1e9 + off, lo), min(p["t1"] * 1e9 + off, hi))
        for w in spans.covering_waves(run) for s in w["children"]
        for p in s["children"] if p["kind"] == "step.forward"
        and p["t1"] * 1e9 + off > lo and p["t0"] * 1e9 + off < hi)
    busy = timeline.union((a, b) for _, a, b in run.events)
    cover = timeline.overlaps(fwd, busy)
    idle = sum(b - a - c for (a, b), c in zip(fwd, cover))
    return 100.0 * idle / (hi - lo)
