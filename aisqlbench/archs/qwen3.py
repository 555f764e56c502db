"""The Qwen3 decoder: its seeded weights, its plain reference and its
count of useful operations, for a configuration file that says
``"arch": "qwen3"``.

Weights (``groups``): each layer pre-RMSNorm ``ln1`` / ``ln2``, the
attention projections, qk-norm scales where the model has them, and a
dense SwiGLU ``mlp``; drawn by ``weights.draw``.

The reference is plain PyTorch in fp32, layer by layer.  It holds nothing
of the program: it makes each layer's weights again from the seed, reads
token ids, and returns logits at the positions asked for.  No cache, no
batching of steps: every row runs whole, causal attention over its own
tokens, tokens packed without padding.  The equations are the published
Qwen3 decoder layer: pre-RMSNorm, GQA with RoPE on the half-split rotary
layout, qk-norm, SwiGLU.  Another architecture may subclass ``Reference``
and replace ``_groups`` (its weights), ``_layer`` (a whole layer, given
its index) or ``_ffn`` (the feed-forward alone).

``precision="fp8"`` is the control: every matrix product of the layers
and of the output head takes its weights per output column and its inputs
per token rounded to float8 e4m3 (scaled to its largest finite value),
the rest as in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from aisqlbench import weights

E4M3_MAX = 448.0


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale for each slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def attn_leaves(m: Dict) -> List[weights.Leaf]:
    """A layer's two pre-norms and its attention, for the ``model``
    section of a configuration file."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    out = [weights.norm("ln1.scale", d), weights.norm("ln2.scale", d),
           weights.dense("attn.wq", d, q), weights.dense("attn.wk", d, kv),
           weights.dense("attn.wv", d, kv), weights.dense("attn.wo", q, d)]
    if m.get("qk_norm"):
        out += [weights.norm("attn.q_norm.scale", hd),
                weights.norm("attn.k_norm.scale", hd)]
    return out


def layer_leaves(m: Dict, i: int = 0) -> List[weights.Leaf]:
    """Layer ``i``'s leaves: ``attn_leaves`` and a dense SwiGLU ``mlp``."""
    return attn_leaves(m) + weights.swiglu("mlp", m["d_model"], m["d_ff"])


def groups(m: Dict) -> List[weights.Group]:
    """Every group of leaves in drawing order: (group name, its leaves
    with names relative to the parameter tree's root)."""
    return weights.decoder_groups(m, layer_leaves)


# -- the model's useful operations ------------------------------------------

def matmul_params(m: Dict) -> int:
    """Weights a token multiplies through in one layer: the attention
    projections and the SwiGLU feed-forward."""
    d, hd = m["d_model"], m["head_dim"]
    return (2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd
            + 3 * d * m["d_ff"])


def step_flops(m: Dict, start: int, count: int, logits: int) -> float:
    """Useful operations of one row in one step: ``count`` tokens taken in
    at positions ``start`` .. ``start + count - 1``, 2 x the active weights
    each, attention over the valid keys (position + 1 of them, 4 hd a key
    and head: q.k and p.v), and the output head at ``logits`` positions
    (a prompt's last token)."""
    layers = m["num_layers"]
    keys = count * start + count * (count + 1) / 2
    return (2.0 * matmul_params(m) * count * layers
            + 4.0 * m["num_heads"] * m["head_dim"] * keys * layers
            + 2.0 * m["d_model"] * m["vocab_size"] * logits)


# -- the plain reference ------------------------------------------------------

class Reference:
    def __init__(self, model: Dict, seed: int, device, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = model
        self.seed = seed
        self.device = torch.device(device)
        self.precision = precision

    # -- pieces ------------------------------------------------------------
    def _groups(self) -> List[weights.Group]:
        return groups(self.m)

    def _w(self, group) -> Dict[str, torch.Tensor]:
        out = {}
        for name, x in weights.draw(self.m, self.seed, group, self.device):
            x = x.float()
            if self.precision == "fp8" and x.dim() >= 2:
                x = _q8(x, dim=-2)          # one scale per output column
            out[name.split(".", 2)[-1] if name.startswith("layers.")
                else name] = x
        return out

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = _q8(x, dim=-1)              # one scale per token
        return x @ w

    def _rms(self, x, scale):
        eps = self.m["norm_eps"]
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale

    def _rope(self, x, pos):
        """x [S, n, hd], pos [S]: half-split rotation."""
        hd = x.shape[-1]
        inv = 1.0 / (self.m["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _swiglu(self, x, w, p):
        return self._mm(F.silu(self._mm(x, w[p + ".wg"]))
                        * self._mm(x, w[p + ".wi"]), w[p + ".wo"])

    def _attention(self, h, w, bounds):
        m = self.m
        H, KV, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = self._mm(h, w["attn.wq"]).view(-1, H, hd)
        k = self._mm(h, w["attn.wk"]).view(-1, KV, hd)
        v = self._mm(h, w["attn.wv"]).view(-1, KV, hd)
        if m.get("qk_norm"):
            q = self._rms(q, w["attn.q_norm.scale"])
            k = self._rms(k, w["attn.k_norm.scale"])
        out = torch.empty_like(q)
        for lo, hi in bounds:
            S = hi - lo
            pos = torch.arange(S, device=h.device)
            qr = self._rope(q[lo:hi], pos).transpose(0, 1)      # [H,S,hd]
            kr = self._rope(k[lo:hi], pos).transpose(0, 1)      # [KV,S,hd]
            vr = v[lo:hi].transpose(0, 1)
            g = H // KV
            mask = torch.ones(S, S, dtype=torch.bool,
                              device=h.device).tril()
            for c in range(KV):                 # one kv head at a time
                s = (qr[c * g:(c + 1) * g] @ kr[c].T) / math.sqrt(hd)
                s = s.masked_fill(~mask, float("-inf"))
                out[lo:hi, c * g:(c + 1) * g] = (
                    torch.softmax(s, -1) @ vr[c]).transpose(0, 1)
        return self._mm(out.reshape(-1, H * hd), w["attn.wo"])

    def _ffn(self, h, w):
        """The feed-forward of a block of tokens' normed states."""
        return self._swiglu(h, w, "mlp")

    def _layer(self, x, w, bounds, i: int):
        """Layer ``i`` over the packed rows x [T, d]; returns x after it."""
        x = x + self._attention(self._rms(x, w["ln1.scale"]), w, bounds)
        h = self._rms(x, w["ln2.scale"])
        for a in range(0, h.shape[0], 2048):
            x[a:a + 2048] += self._ffn(h[a:a + 2048], w)
        return x

    # -- the pass ----------------------------------------------------------
    @torch.no_grad()
    def run(self, rows: Sequence[Sequence[int]],
            positions: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """rows: token ids of each row; positions: where each row's logits
        are wanted.  Returns a [len(positions[i]), V] fp32 tensor a row."""
        dev = self.device
        m = self.m
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            groups = self._groups()
            bounds, lo = [], 0
            for r in rows:
                bounds.append((lo, lo + len(r)))
                lo += len(r)
            tokens = torch.tensor([t for r in rows for t in r],
                                  dtype=torch.long, device=dev)
            emb = dict(weights.draw(m, self.seed, groups[0], dev))["embed.w"]
            x = emb[tokens].float()
            del emb
            for i, g in enumerate(groups[1:1 + m["num_layers"]]):
                w = self._w(g)
                x = self._layer(x, w, bounds, i)
                del w
            tail = {}
            for g in groups[1 + m["num_layers"]:]:
                tail.update(self._w(g))
            head = tail.get("lm_head.w")
            if head is None:            # tied: the embedding's transpose
                head = dict(weights.draw(m, self.seed, groups[0], dev)
                            )["embed.w"].float().T
            x = self._rms(x, tail["final_norm.scale"])
            idx = [lo + p for (lo, _), ps in zip(bounds, positions)
                   for p in ps]
            picked = self._mm(x[torch.tensor(idx, device=dev)], head)
            out, a = [], 0
            for ps in positions:
                out.append(picked[a:a + len(ps)])
                a += len(ps)
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
