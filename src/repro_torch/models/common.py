"""Shared model-building primitives: init, norms, projections, RoPE and
M-RoPE.

The PyTorch counterpart of ``repro.models.common``.  Parameters are plain
dicts of tensors; every function takes tensors and returns tensors.  Matmuls
run in the config dtype (bf16 by default) with fp32 norm statistics and an
fp32 SiLU, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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


def lookup(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``w[ids]`` of a table w [V, D].

    On the mesh (w a DTensor) each rank looks up its own ids in the table
    gathered to whole rows over every axis but ``model``; where ``model``
    splits the vocabulary, a rank's rows are its slice, ids outside it
    give zeros, and the partial results are summed over ``model`` when
    the output is next redistributed (Megatron's vocab-parallel
    embedding, the partitioning XLA gives the JAX package's gather).  The
    output keeps the ids' placements on the other axes.  DTensor's own
    rule for the gather fails on ids whose batch is split over two axes
    (the multi-pod mesh) in some torch versions."""
    if not (hasattr(w, "device_mesh") and hasattr(w, "placements")):
        return w[ids.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    names = tuple(mesh.mesh_dim_names)
    split = [n == "model" and p == Shard(0)
             for n, p in zip(names, w.placements)]
    want = [Shard(0) if s else Replicate() for s in split]
    # each rank's gradient of the gathered table is its own ids' part
    grads = [Shard(0) if s else Partial() for s in split]
    wl = w.redistribute(mesh, want).to_local(grad_placements=grads)
    if isinstance(ids, DTensor):
        ids_pl, ids = list(ids.placements), ids.to_local()
    else:                                   # the same ids on every rank
        ids_pl = [Replicate()] * len(names)
    ids = ids.long()
    if any(split):
        n = wl.shape[0]
        loc = ids - mesh.get_local_rank("model") * n
        ok = ((loc >= 0) & (loc < n))[..., None]
        rows = wl[loc.clamp(0, n - 1)]
        rows = torch.where(ok, rows, torch.zeros_like(rows))
    else:
        rows = wl[ids]
    out_pl = [Partial() if s else p for s, p in zip(split, ids_pl)]
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def last_rows(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] at each row's last valid position (lengths [B]) ->
    [B, D].  On the mesh each rank takes its own rows' positions
    (``kernels.local``): DTensor's own gather would first gather the
    whole [B, S, D] to every rank."""
    def take(x, lengths):
        last = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), last]
    if hasattr(x, "device_mesh"):
        from repro_torch.kernels import local
        return local.run_local(take, (x, lengths),
                               (("dp", None, None), ("dp",)), ("dp", None))
    return take(x, lengths)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] (+ b [out])."""
    y = x @ w
    return y if b is None else y + b


def mlp_init(gen: torch.Generator, d: int, f: int, dtype,
             use_bias: bool = False) -> Params:
    """``wi``, ``wg`` [d, f] and ``wo`` [f, d]; with ``use_bias`` zero
    biases ``bi``, ``bg`` [f] and ``bo`` [d], as in the JAX package."""
    p = {"wi": dense_init(gen, d, f, dtype),
         "wg": dense_init(gen, d, f, dtype),
         "wo": dense_init(gen, f, d, dtype)}
    if use_bias:
        dev = gen.device
        p["bi"] = torch.zeros((f,), dtype=dtype, device=dev)
        p["bg"] = torch.zeros((f,), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated (SwiGLU) MLP: SiLU in fp32, cast back before the gate product."""
    h = linear(x, params["wi"], params.get("bi"))
    g = linear(x, params["wg"], params.get("bg"))
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    return linear(h, params["wo"], params.get("bo"))


# ---------------------------------------------------------------------------
# RoPE / M-RoPE (half-split, llama convention)
# ---------------------------------------------------------------------------


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 mrope_sections: Tuple[int, ...] = ()):
    """The fp32 rotation tables (cos, sin) [..., S, head_dim / 2] of
    positions [..., S] (or [..., S, 3] with M-RoPE: rotary dim i takes the
    (t, h, w) stream of its section, sections of ``mrope_sections`` dims
    in order)."""
    half = head_dim // 2
    inv = rope_inv_freq(head_dim, theta, positions.device)     # [half]
    if mrope_sections:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to the rotary half {half}")
        sec = torch.cat([torch.full((n,), i, dtype=torch.long,
                                    device=positions.device)
                         for i, n in enumerate(mrope_sections)])   # [half]
        angles = positions.float()[..., sec] * inv             # [..., S, half]
    else:
        angles = positions.float()[..., None] * inv            # [..., S, half]
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """The half-split rotation of x [..., hd] by fp32 tables cos, sin
    that broadcast to [..., hd / 2]; math in fp32, result in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """The rotation of x [..., hd] whose rotary pairs are interleaved,
    (x[2i], x[2i+1]) turned by angle i, as the ``deepseek_v3`` code does
    it: the pairs permuted to the half-split layout, then :func:`rotate`
    (the result stays in the half-split layout; q and k both so, their
    dot products are those of the interleaved rotation)."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return rotate(x, cos, sin)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """Rotate x [..., S, H, hd] by positions [..., S], or with M-RoPE by
    positions [..., S, 3] (see :func:`rope_cos_sin`).  Math in fp32."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta,
                            mrope_sections)
    return rotate(x, cos[..., None, :], sin[..., None, :])  # [..., S, 1, half]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return (torch.tanh(logits.float() / cap) * cap).to(logits.dtype)
    return logits
