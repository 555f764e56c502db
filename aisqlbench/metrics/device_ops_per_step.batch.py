"""Kernels and copies a prefill step puts on the card (ops): the device
events that start between a window step's start and the start of the next
step of its wave, averaged over the window's prefill steps whose next step
starts inside the window.  In a traced run the harness synchronises after
each step, so no step's work spills into the next one's count."""
import bisect

from aisqlbench import spans


def read(run):
    steps = spans.window_steps(run)
    if steps is None or run.events is None:
        return None
    a, b = run.clock_window
    off = spans.offset_ns(run)
    starts = sorted(s for _, s, _ in run.events)
    counts = []
    for w in spans.covering_waves(run):
        ws = [s for s in w["children"] if s["kind"] == "engine.step"]
        for s, nxt in zip(ws, ws[1:]):
            if (s["attrs"].get("kind") != "prefill" or s["t0"] < a
                    or s["t1"] > b or nxt["t0"] > b):
                continue
            lo, hi = s["t0"] * 1e9 + off, nxt["t0"] * 1e9 + off
            counts.append(bisect.bisect_left(starts, hi)
                          - bisect.bisect_left(starts, lo))
    return sum(counts) / len(counts) if counts else None
