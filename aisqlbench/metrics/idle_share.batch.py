"""Share of the traced window in which no kernel or copy ran on the card
(%), from the union of the profiler's device events."""
from aisqlbench import devtrace


def read(run):
    if run.window_ns is None:
        return None
    lo, hi = run.window_ns
    return 100.0 * (1.0 - devtrace.busy_s(run.events) / ((hi - lo) / 1e9))
