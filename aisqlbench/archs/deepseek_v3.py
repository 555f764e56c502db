"""The DeepSeek-V3 decoder (``model_type`` deepseek_v3: Moonlight-16B-A3B
and the models that share its block): its seeded weights, its plain
reference, its count of useful operations and the least times of its
latent attention and its experts, for a configuration file that says
``"arch": "deepseek_v3"``.

Weights (``groups``), named as the port's parameter tree, each matrix
[in, out]: a layer's pre-RMSNorms ``ln1`` / ``ln2``; its attention
``attn.wq`` [d, H (nope + rope)] (no q latent: ``q_lora_rank`` null),
``attn.wkv_a`` [d, r + rope] (the latent c, then the RoPE key all heads
share), ``attn.kv_norm.scale`` [r], ``attn.wkv_b`` [r, H (nope + v)] (a
head's k_nope, then its v) and ``attn.wo`` [H v, d]; below
``first_k_dense`` a dense SwiGLU ``mlp`` of ``d_ff``, from it on the
router ``moe.router.w`` fp32 [d, E], its correction bias
``moe.router.bias`` fp32 [E] (N(0, 0.1^2): an assumed law, the published
weights are trained), the stacked routed experts and the fused shared
SwiGLU ``moe.shared``.

The reference is plain PyTorch in fp32, TF32 off (``qwen3.Reference.run``
sets it), layer by layer, each layer's weights made again from the seed.
It takes the full-sequence form of the ``deepseek_v3`` modelling code:

* q = x W_q, a head [q_nope | q_pe]; [c | k_pe] = x W_kva; c_n =
  RMSNorm(c) with that code's default eps (``latent_norm_eps``); [k_nope
  | v] = c_n W_kvb, a head;
* RoPE on q_pe and on the shared k_pe.  That code permutes each head's
  rotary dims [x0, x1, x2, x3, ...] to [x0, x2, ..., x1, x3, ...] before
  its ``rotate_half``: the interleaved pairs (x[2i], x[2i+1]) turn by
  angle i;
* scores (q_nope . k_nope + q_pe . k_pe) / sqrt(nope + rope), causal,
  softmax in fp32, then sum p v, then W_o; in blocks of ``Q_BLOCK``
  queries, so that a row of 8,000 tokens fits;
* the experts: s = sigmoid(h W_r), the top k of s + b chosen (``n_group``
  = ``topk_group`` = 1: no group limit), weighted by s over the chosen
  s' sum times ``routed_scale``, each chosen expert's SwiGLU, plus the
  shared SwiGLU ungated.

``precision="fp8"`` is ``qwen3.Reference``'s control (every matrix
product of the layers and the head on e4m3-rounded operands).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from aisqlbench import spec, weights

qwen3 = spec.load_arch("qwen3", Path(__file__).resolve().parents[1])

Q_BLOCK = 1024
# NVIDIA H100 SXM data sheet: HBM bytes a second, dense rates at 700 W
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _dims(m: Dict) -> Tuple[int, int, int, int, int]:
    return (m["num_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"])


def layer_leaves(m: Dict, i: int) -> List[weights.Leaf]:
    d = m["d_model"]
    H, r, dn, dr, dv = _dims(m)
    out = [weights.norm("ln1.scale", d), weights.norm("ln2.scale", d),
           weights.dense("attn.wq", d, H * (dn + dr)),
           weights.dense("attn.wkv_a", d, r + dr),
           weights.norm("attn.kv_norm.scale", r),
           weights.dense("attn.wkv_b", r, H * (dn + dv)),
           weights.dense("attn.wo", H * dv, d)]
    if i < m["first_k_dense"]:
        return out + weights.swiglu("mlp", d, m["d_ff"])
    mo = m["moe"]
    e, f = mo["padded_num_experts"], mo["expert_d_ff"]
    out += [weights.dense("moe.router.w", d, e, "float32"),
            weights.stacked("moe.experts.wi", e, d, f),
            weights.stacked("moe.experts.wg", e, d, f),
            weights.stacked("moe.experts.wo", e, f, d)]
    if mo["correction_bias"]:
        out.append(("moe.router.bias", (e,), 0.0, 0.1, "float32"))
    if mo["num_shared_experts"]:
        out += weights.swiglu("moe.shared", d, mo["shared_d_ff"])
    return out


def groups(m: Dict) -> List[weights.Group]:
    return weights.decoder_groups(m, layer_leaves)


# -- the model's useful operations ------------------------------------------

def matmul_params(m: Dict, i: int) -> int:
    """Weights a token multiplies through in layer ``i``: the attention's
    q, latent and output projections (``wkv_b`` is the attention's own,
    in ``attn_flops``), then the dense SwiGLU or the router, k experts and
    the shared expert."""
    d = m["d_model"]
    H, r, dn, dr, dv = _dims(m)
    n = d * H * (dn + dr) + d * (r + dr) + H * dv * d
    if i < m["first_k_dense"]:
        return n + 3 * d * m["d_ff"]
    mo = m["moe"]
    shared = mo["shared_d_ff"] if mo["num_shared_experts"] else 0
    return n + d * mo["num_experts"] + 3 * d * (
        mo["num_experts_per_tok"] * mo["expert_d_ff"] + shared)


def attn_flops(m: Dict, start: int, count: int) -> float:
    """One layer's attention for ``count`` tokens at positions ``start``
    .. ``start + count - 1`` of a row, each over the keys up to its own,
    in the lesser of the two forms: absorbed (a token's q_nope through
    W_UK and its context through W_UV, 2 H r (nope + v); a key and head
    2 (r + rope) for the score and 2 r for the context) or decompressed
    (every key's k_nope and v from its latent, 2 r H (nope + v) a key of
    the prefix; a key and head 2 (nope + rope) + 2 v)."""
    H, r, dn, dr, dv = _dims(m)
    keys = count * start + count * (count + 1) / 2
    absorbed = (count * 2.0 * H * r * (dn + dv)
                + keys * 2.0 * H * (r + dr + r))
    decompressed = ((start + count) * 2.0 * r * H * (dn + dv)
                    + keys * 2.0 * H * (dn + dr + dv))
    return min(absorbed, decompressed)


def step_flops(m: Dict, start: int, count: int, logits: int) -> float:
    """Useful operations of one row in one step: 2 x the active weights a
    token, each layer's attention (``attn_flops``), the output head at
    ``logits`` positions."""
    layers = m["num_layers"]
    w = sum(matmul_params(m, i) for i in range(layers))
    return (2.0 * w * count + layers * attn_flops(m, start, count)
            + 2.0 * m["d_model"] * m["vocab_size"] * logits)


# -- least times, for the per-layer roofline shares --------------------------

def attn_bound_s(m: Dict, rows_at: Sequence[Sequence[int]]) -> float:
    """The least time of one latent-attention layer in a step whose
    prefilling rows are ``rows_at`` ([start, count, last] each): the
    larger of its bytes over the HBM rate and its operations
    (``attn_flops``) over the peak.  Bytes: each row's latent prefix read
    once (``start`` positions of r + rope), and the new tokens' q (H (nope
    + rope)), latent (r + rope) and output (H v), once each."""
    H, r, dn, dr, dv = _dims(m)
    es = BYTES[m["dtype"]]
    nbytes = ops = 0.0
    for start, count, _ in rows_at:
        nbytes += es * (start * (r + dr)
                        + count * (H * (dn + dr) + (r + dr) + H * dv))
        ops += attn_flops(m, start, count)
    return max(nbytes / HBM_BPS, ops / PEAK_FLOPS[m["dtype"]])


def moe_bound_s(m: Dict, tokens: int, experts_hit: int) -> float:
    """The least time of one MoE layer over ``tokens`` tokens that reached
    ``experts_hit`` experts: bytes are those experts' weights, the shared
    expert's and the fp32 router's (its bias too), each read once;
    operations 2 x (k experts + the shared expert + the router) a
    token."""
    d, mo = m["d_model"], m["moe"]
    f, E = mo["expert_d_ff"], mo["num_experts"]
    shared = mo["shared_d_ff"] if mo["num_shared_experts"] else 0
    es = BYTES[m["dtype"]]
    nbytes = (es * 3 * d * (experts_hit * f + shared)
              + 4 * E * (d + int(mo["correction_bias"])))
    ops = tokens * 2.0 * (3 * d * (mo["num_experts_per_tok"] * f + shared)
                          + d * E)
    return max(nbytes / HBM_BPS, ops / PEAK_FLOPS[m["dtype"]])


# -- the plain reference ------------------------------------------------------

def _rope_pairs(x: torch.Tensor, pos: torch.Tensor, theta: float
                ) -> torch.Tensor:
    """x [S, ..., rope] rotated as the ``deepseek_v3`` code does: the
    interleaved dims permuted to halves, then ``x cos + rotate_half(x)
    sin`` with cos, sin of cat(freqs, freqs)."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.cat([pos.float()[:, None] * inv] * 2, -1)     # [S, d]
    ang = ang.view((x.shape[0],) + (1,) * (x.dim() - 2) + (d,))
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * torch.cos(ang) + half * torch.sin(ang)


class Reference(qwen3.Reference):
    def _groups(self) -> List[weights.Group]:
        return groups(self.m)

    def _attention(self, h, w, bounds):
        m = self.m
        H, r, dn, dr, dv = _dims(m)
        q = self._mm(h, w["attn.wq"]).view(-1, H, dn + dr)
        kv = self._mm(h, w["attn.wkv_a"])
        c = kv[:, :r]
        c = c * torch.rsqrt(c.square().mean(-1, keepdim=True)
                            + m["latent_norm_eps"]) * w["attn.kv_norm.scale"]
        kvb = self._mm(c, w["attn.wkv_b"]).view(-1, H, dn + dv)
        out = h.new_empty(h.shape[0], H, dv)
        scale = 1.0 / math.sqrt(dn + dr)
        for lo, hi in bounds:
            S = hi - lo
            pos = torch.arange(S, device=h.device)
            q_pe = _rope_pairs(q[lo:hi, :, dn:], pos, m["rope_theta"])
            k_pe = _rope_pairs(kv[lo:hi, r:], pos, m["rope_theta"])
            k_nope, v = kvb[lo:hi, :, :dn], kvb[lo:hi, :, dn:]
            for a in range(0, S, Q_BLOCK):
                b = min(S, a + Q_BLOCK)
                s = (torch.einsum("qhd,khd->hqk", q[lo + a:lo + b, :, :dn],
                                  k_nope[:b])
                     + torch.einsum("qhd,kd->hqk", q_pe[a:b], k_pe[:b]))
                keep = pos[None, :b] <= pos[a:b, None]
                p = torch.softmax((s * scale).masked_fill(~keep,
                                                          float("-inf")), -1)
                out[lo + a:lo + b] = torch.einsum("hqk,khd->qhd", p, v[:b])
        return self._mm(out.reshape(-1, H * dv), w["attn.wo"])

    def _ffn(self, h, w):
        if "mlp.wi" in w:                       # a leading dense layer
            return self._swiglu(h, w, "mlp")
        mo = self.m["moe"]
        n = mo["num_experts"]
        s = torch.sigmoid(self._mm(h, w["moe.router.w"][:, :n]))
        choice = s + w["moe.router.bias"][:n] if mo["correction_bias"] else s
        idx = choice.topk(mo["num_experts_per_tok"], -1).indices
        gate = s.gather(-1, idx)
        if mo["norm_topk_prob"]:
            gate = gate / gate.sum(-1, keepdim=True)
        gate = gate * mo["routed_scale"]
        wi, wg, wo = (w[f"moe.experts.{k}"] for k in ("wi", "wg", "wo"))
        y = torch.zeros_like(h)
        for e in range(n):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if tok.numel():
                x = h[tok]
                y[tok] += gate[tok, slot, None] * self._mm(
                    F.silu(self._mm(x, wg[e])) * self._mm(x, wi[e]), wo[e])
        if mo["num_shared_experts"]:
            y = y + self._swiglu(h, w, "moe.shared")
        return y
