"""The paged KV pool's copies a prefill step (ms): the mean over the traced
window's prefill steps of the CUDA stream time of their ``step.gather`` and
``step.scatter`` phases (the program's own spans)."""
from aisqlbench import spans


def read(run):
    return spans.mean_device_ms(run, ("step.gather", "step.scatter"))
