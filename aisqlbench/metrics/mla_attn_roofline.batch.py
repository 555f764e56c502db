"""Latent attention's share of its roofline (%): over the traced window's
prefill steps, the least time of their MLA layers' attention (the
architecture's ``attn_bound_s`` of each step's prefilling rows, once a
layer) over the CUDA stream time of those layers' ``layer.attn`` spans
(the program's own, inside ``step.forward``).  None where the steps carry
no such spans or the architecture has no ``attn_bound_s``."""
from aisqlbench import layer_spans, spans, spec


def read(run):
    steps = spans.window_steps(run)
    if steps is None or "arch" not in run.conf:
        return None
    bound_s = getattr(spec.load_arch(run.conf["arch"]), "attn_bound_s", None)
    least = took = 0.0
    for s in steps:
        layers = layer_spans.layers(s, "layer.attn")
        if not layers or bound_s is None:
            return None
        least += len(layers) * bound_s(run.model, s["attrs"]["rows_at"])
        took += sum(c["attrs"]["device_ms"] for c in layers) / 1e3
    return 100.0 * least / took
