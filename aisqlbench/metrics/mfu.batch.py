"""The whole step's share of the card's peak (%): the benchmark's own count
of the model's useful operations in the steps of the traced window
(``timeline.step_flops``: the active weights a token multiplies through,
attention over valid keys, the output head where logits are needed), over
the traced window times the data sheet's dense rate in the configuration's
type."""
from aisqlbench import timeline


def read(run):
    if run.window_ns is None:
        return None
    lo, hi = run.window_ns
    a, b = run.clock_window
    peak = timeline.PEAK_FLOPS[run.model["dtype"]]
    return 100.0 * timeline.window_flops(run.steps, a, b) / (
        (hi - lo) / 1e9 * peak)
