"""The mixture of experts' share of its roofline (%): over the traced
window's prefill steps, the least time of their MoE layers (the
architecture's ``moe_bound_s`` of the step's tokens and the experts they
reached, which each layer's ``layer.ffn`` span notes) over the CUDA stream
time of those spans (the program's own, inside ``step.forward``).  None
where the steps carry no such spans or the architecture has no
``moe_bound_s``."""
from aisqlbench import layer_spans, spans, spec


def read(run):
    steps = spans.window_steps(run)
    if steps is None or "arch" not in run.conf:
        return None
    bound_s = getattr(spec.load_arch(run.conf["arch"]), "moe_bound_s", None)
    least = took = 0.0
    for s in steps:
        layers = [c for c in layer_spans.layers(s, "layer.ffn") or ()
                  if "experts_hit" in c["attrs"]]
        if not layers or bound_s is None:
            return None
        for c in layers:
            least += bound_s(run.model, s["attrs"]["tokens"],
                             c["attrs"]["experts_hit"])
            took += c["attrs"]["device_ms"] / 1e3
    return 100.0 * least / took
