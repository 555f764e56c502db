"""Share of the window during which an engine ``submit_batch`` call was in
progress: whether the layers above starve the engine (%)."""
from aisqlbench import timeline


def read(run):
    busy = timeline.union((a, b) for a, b, _ in run.dispatches)
    return 100.0 * timeline.overlap(run.t0, run.t1, busy) / (run.t1 - run.t0)
