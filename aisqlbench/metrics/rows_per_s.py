"""Rows the window's queries handed to their AI operator and got answers
for, over the time from the window's start to the end of its last query
(closed loop: tenants submit until the window's length has passed; the
queries then in flight finish and count)."""
from aisqlbench import timeline


def read(run):
    return timeline.rows_per_s(run.queries, run.t0)
