"""A throwaway mixture-of-experts architecture for the CPU tests, added to
a copy of the benchmark as ``archs/<name>.py`` the way a later change
adds an architecture: a new file, loaded by the name a configuration
gives.  It runs from there only (it loads ``qwen3`` from its own folder).

A layer is qwen3's (``archs/qwen3.py``) with the dense feed-forward
replaced as the port's ``blocks.moe_init`` lays it out: a router
``moe.router.w`` fp32 [d, E], E the padded count of experts; stacked
routed experts ``moe.experts.wi`` / ``wg`` [E, d, f] and ``wo`` [E, f,
d]; and one fused shared expert, the SwiGLU ``moe.shared``.  The
reference routes each token by a softmax over the real experts, takes
its top k renormalised, adds each chosen expert's SwiGLU by its gate,
then the shared expert ungated.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import torch
import torch.nn.functional as F

from aisqlbench import spec, weights

qwen3 = spec.load_arch("qwen3", Path(__file__).resolve().parents[1])


def layer_leaves(m: Dict, i: int = 0) -> List[weights.Leaf]:
    d, mo = m["d_model"], m["moe"]
    e, f = mo["padded_num_experts"], mo["expert_d_ff"]
    out = qwen3.attn_leaves(m) + [
        weights.dense("moe.router.w", d, e, "float32"),
        weights.stacked("moe.experts.wi", e, d, f),
        weights.stacked("moe.experts.wg", e, d, f),
        weights.stacked("moe.experts.wo", e, f, d)]
    if mo["num_shared_experts"]:
        out += weights.swiglu("moe.shared", d, mo["shared_d_ff"])
    return out


def groups(m: Dict) -> List[weights.Group]:
    return weights.decoder_groups(m, layer_leaves)


def matmul_params(m: Dict) -> int:
    """Weights a token multiplies through in one layer: the attention
    projections, the router over the real experts, its k experts and the
    shared expert."""
    d, hd, mo = m["d_model"], m["head_dim"], m["moe"]
    shared = mo["shared_d_ff"] if mo["num_shared_experts"] else 0
    return (2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd
            + d * mo["num_experts"]
            + 3 * d * (mo["num_experts_per_tok"] * mo["expert_d_ff"] + shared))


def step_flops(m: Dict, start: int, count: int, logits: int) -> float:
    layers = m["num_layers"]
    keys = count * start + count * (count + 1) / 2
    return (2.0 * matmul_params(m) * count * layers
            + 4.0 * m["num_heads"] * m["head_dim"] * keys * layers
            + 2.0 * m["d_model"] * m["vocab_size"] * logits)


class Reference(qwen3.Reference):
    def _groups(self) -> List[weights.Group]:
        return groups(self.m)

    def _ffn(self, h, w):
        mo = self.m["moe"]
        n = mo["num_experts"]
        probs = torch.softmax(self._mm(h, w["moe.router.w"][:, :n]), -1)
        gate, idx = probs.topk(mo["num_experts_per_tok"], -1)
        gate = gate / gate.sum(-1, keepdim=True)
        wi, wg, wo = (w[f"moe.experts.{k}"] for k in ("wi", "wg", "wo"))
        y = torch.zeros_like(h)
        for e in range(n):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            x = h[tok]
            y[tok] += gate[tok, slot, None] * self._mm(
                F.silu(self._mm(x, wg[e])) * self._mm(x, wi[e]), wo[e])
        if mo["num_shared_experts"]:
            y = y + self._swiglu(h, w, "moe.shared")
        return y
