"""Shared model-building primitives: init, norms, projections, RoPE.

The PyTorch counterpart of ``repro.models.common``.  Parameters are plain
dicts of tensors; every function takes tensors and returns tensors.  Matmuls
run in the config dtype (bf16 by default) with fp32 norm statistics and an
fp32 SiLU, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers (same distributions as the JAX package, drawn from a
# torch.Generator: the numbers differ, the laws do not)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype
               ) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def norm_init(d: int, dtype, device, use_layernorm: bool) -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if use_layernorm:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def apply_norm(params: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm depending on whether a bias is present;
    statistics in fp32, result cast back to x's dtype."""
    xf = x.float()
    if "bias" in params:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm of RWKV-6: x [..., H, hd] -> [..., H * hd],
    statistics and affine in fp32, result cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(y.shape[:-2] + (y.shape[-2] * y.shape[-1],))
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# linear / mlp
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] (biases are not ported yet)."""
    return x @ w


def mlp_init(gen: torch.Generator, d: int, f: int, dtype) -> Params:
    return {"wi": dense_init(gen, d, f, dtype),
            "wg": dense_init(gen, d, f, dtype),
            "wo": dense_init(gen, f, d, dtype)}


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated (SwiGLU) MLP: SiLU in fp32, cast back before the gate product."""
    h = linear(x, params["wi"])
    g = linear(x, params["wg"])
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    return linear(h, params["wo"])


# ---------------------------------------------------------------------------
# RoPE (half-split, llama convention)
# ---------------------------------------------------------------------------


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate x [..., S, H, hd] by positions [..., S]; math in fp32."""
    half = x.shape[-1] // 2
    inv = rope_inv_freq(x.shape[-1], theta, x.device)          # [half]
    angles = positions.float()[..., None] * inv                # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return (torch.tanh(logits.float() / cap) * cap).to(logits.dtype)
    return logits
