"""Model blocks: the PyTorch counterpart of ``repro.models.blocks``.

The port implements the global- and sliding-window attention blocks
(``ATTN``, ``LOCAL_ATTN``) with the dense gated MLP, the RG-LRU recurrent
block (``RGLRU``, recurrentgemma) and the RWKV-6 block (``RWKV``).  Every
block has three entry points behind one interface:

    block_init(blk, gen, cfg, dtype)          -> params
    block_cache_init(blk, cfg, batch, smax)   -> cache (decode state)
    block_apply(blk, params, x, ctx)          -> (y, new_cache)

``ctx.mode`` is one of "train" (no cache), "prefill" (full sequence, writes
the cache), "decode" (new tokens against the cache).  Caches are updated in
place and returned.

The sequence scans of the recurrent blocks go through hand-written CUDA
kernels on the card: the RG-LRU's h = a*h + b through
``kernels/rglru_scan`` (K4) in train and prefill mode (a decode step is
one elementwise update, as in the JAX package), and RWKV-6's wkv
recurrence through ``kernels/rwkv6_scan`` (K5) in every mode.  On the CPU
they run the kernels' plain versions, which are the JAX package's
``lax.scan`` step by step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import base as cfgs
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, apply_rope,
                                       dense_init, group_norm_heads, linear,
                                       mlp_init, norm_init)

# The recurrent scans on CUDA tensors: "auto" launches the kernels (K4,
# K5), "reference" takes their plain versions (for comparisons on the
# card).  CPU tensors always take the plain versions.
_SCAN_IMPL = "auto"


@contextlib.contextmanager
def use_scan_impl(impl: str):
    """Run the RG-LRU and RWKV-6 scans inside this context with ``impl``
    ("auto": the kernels on CUDA; "reference": their plain versions)."""
    global _SCAN_IMPL
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown scan impl {impl!r}")
    prev, _SCAN_IMPL = _SCAN_IMPL, impl
    try:
        yield
    finally:
        _SCAN_IMPL = prev


@dataclasses.dataclass
class Ctx:
    cfg: cfgs.ModelConfig
    mode: str                       # train | prefill | decode
    positions: Any                  # [B,S] int
    lengths: Optional[Any] = None   # [B] valid tokens incl. current step
    valid: Optional[Any] = None     # [B,S] bool: pad mask for prefill
    cache: Any = None               # this block's cache slice

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ===========================================================================
# Attention block (global or sliding-window), GQA + RoPE
# ===========================================================================


def attn_init(gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    d = cfg.d_model
    return {"wq": dense_init(gen, d, cfg.q_dim, dtype),
            "wk": dense_init(gen, d, cfg.kv_dim, dtype),
            "wv": dense_init(gen, d, cfg.kv_dim, dtype),
            "wo": dense_init(gen, cfg.q_dim, d, dtype)}


def _qkv(params, x, cfg: cfgs.ModelConfig, positions):
    B, S, _ = x.shape
    q = linear(x, params["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = linear(x, params["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = linear(x, params["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(params, x, ctx: Ctx, *, window: int = 0):
    cfg = ctx.cfg
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, ctx.positions)
    new_cache = ctx.cache
    if ctx.mode == "decode":
        if window:
            pos = ctx.lengths - 1                   # absolute position
            ck, cv = attn.write_kv_ring(ctx.cache["k"], ctx.cache["v"], k, v,
                                        pos, window)
            out = attn.ring_decode_attention(q, ck, cv, pos, window)
        else:
            start = ctx.lengths - S
            ck, cv = attn.write_kv(ctx.cache["k"], ctx.cache["v"], k, v,
                                   start)
            out = attn.decode_attention(q, ck, cv, ctx.lengths)
    else:
        out = attn.causal_attention(q, k, v, window=window)
        if ctx.mode == "prefill":
            ck, cv = ctx.cache["k"], ctx.cache["v"]
            if window:
                lens = (ctx.lengths if ctx.lengths is not None else
                        torch.full((B,), S, dtype=torch.int32,
                                   device=x.device))
                attn.fill_ring(ck, cv, k, v, lens, window)
            else:
                ck[:, :S] = k
                cv[:, :S] = v
                ck[:, S:].zero_()
                cv[:, S:].zero_()
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return linear(out, params["wo"]), new_cache


def attn_cache_init(cfg: cfgs.ModelConfig, batch: int, smax: int, *,
                    window: int = 0, dtype, device):
    cap = window if window else smax
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ===========================================================================

_RG_C = 8.0  # decay sharpness constant from the Griffin paper


def rglru_init(gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    d, w = cfg.d_model, cfg.lru_width
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    # a_param such that a = sigmoid(a_param)^c lies in (0.9, 0.999)
    return {
        "in_x": dense_init(gen, d, w, dtype),
        "in_gate": dense_init(gen, d, w, dtype),
        "conv_w": (torch.randn((cfg.conv1d_width, w), generator=gen, **f32)
                   * 0.02).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "a_param": torch.linspace(2.0, 6.0, w, **f32),
        "i_gate_w": torch.ones((w,), **f32),
        "i_gate_b": torch.zeros((w,), **f32),
        "r_gate_w": torch.ones((w,), **f32),
        "r_gate_b": torch.zeros((w,), **f32),
        "out": dense_init(gen, w, d, dtype),
    }


def _rglru_coeffs(params, u):
    """u: [...,W] conv output -> (a, b) of h_t = a*h + b (fp32)."""
    uf = u.float()
    i_gate = torch.sigmoid(uf * params["i_gate_w"] + params["i_gate_b"])
    r_gate = torch.sigmoid(uf * params["r_gate_w"] + params["r_gate_b"])
    log_a_base = F.logsigmoid(params["a_param"])              # [W]
    log_a = _RG_C * r_gate * log_a_base                       # [...,W] (<0)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i_gate * uf)
    return a, b


def _causal_conv(params, x, prev):
    """Depthwise causal conv1d.  x: [B,S,W]; prev: [B,cw-1,W] history."""
    w = params["conv_w"]
    cw = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    y = 0
    for i in range(cw):
        y = y + xp[:, i:i + S] * w[cw - 1 - i]
    return y + params["conv_b"]


def rglru_apply(params, x, ctx: Ctx):
    B, S, _ = x.shape
    u = linear(x, params["in_x"])                             # [B,S,W]
    gate = linear(x, params["in_gate"])
    W = u.shape[-1]
    cw = params["conv_w"].shape[0]
    cache = ctx.cache
    if ctx.mode == "decode":
        prev, h0 = cache["conv"], cache["h"]
    else:
        prev = torch.zeros((B, cw - 1, W), dtype=u.dtype, device=u.device)
        h0 = torch.zeros((B, W), dtype=torch.float32, device=u.device)
    uc = _causal_conv(params, u, prev)
    a, b = _rglru_coeffs(params, uc)
    if ctx.mode == "prefill" and ctx.valid is not None:
        # pad positions are identity updates (a=1, b=0), so the carried
        # state is the state at the last valid token
        vm = ctx.valid[..., None]
        a = torch.where(vm, a, torch.ones_like(a))
        b = torch.where(vm, b, torch.zeros_like(b))

    if ctx.mode == "decode":
        if S != 1:
            raise ValueError("RG-LRU decode is single-token")
        h = a[:, 0] * h0 + b[:, 0]                            # [B,W]
        hs = h[:, None]
        conv = torch.cat([prev, u], dim=1)[:, 1:]
        cache["h"].copy_(h)
        cache["conv"].copy_(conv)
    else:
        hs, hT = rglru_ops.rglru_scan(a, b, h0, impl=_SCAN_IMPL)
        if ctx.mode == "prefill":
            # conv history = the last (cw-1) *valid* inputs of each row
            lens = (ctx.lengths if ctx.lengths is not None else
                    torch.full((B,), S, dtype=torch.int32, device=x.device))
            idx = (lens.long()[:, None] - (cw - 1)
                   + torch.arange(cw - 1, device=x.device)[None])
            ok = (idx >= 0)[..., None]
            bidx = torch.arange(B, device=x.device)[:, None]
            hist = u[bidx, idx.clamp(0, S - 1)]
            cache["h"].copy_(hT)
            cache["conv"].copy_(torch.where(ok, hist,
                                            torch.zeros_like(hist)))
    g = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    y = hs.to(x.dtype) * g
    return linear(y, params["out"]), cache


def rglru_cache_init(cfg: cfgs.ModelConfig, batch: int, *, dtype, device):
    w = cfg.lru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device)}


# ===========================================================================
# RWKV-6 "Finch" block (time-mix + channel-mix)
# ===========================================================================


def rwkv_init(gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_size
    H = d // hd
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)

    return {
        "tmix": {
            "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
            "mu_w": half(),
            "wr": dense_init(gen, d, d, dtype),
            "wk": dense_init(gen, d, d, dtype),
            "wv": dense_init(gen, d, d, dtype),
            "wg": dense_init(gen, d, d, dtype),
            "ww": dense_init(gen, d, d, dtype, scale=0.1),
            "wo": dense_init(gen, d, d, dtype),
            "w0": torch.linspace(-6.0, -1.0, d, **f32),
            "u": torch.randn((H, hd), generator=gen, **f32) * 0.1,
            "gn_scale": torch.ones((d,), **f32),
            "gn_bias": torch.zeros((d,), **f32),
        },
        "cmix": {
            "mu_k": half(),
            "wk": dense_init(gen, d, f, dtype),
            "wv": dense_init(gen, f, d, dtype),
        },
    }


def _token_shift(x, prev):
    """x: [B,S,D]; prev: [B,D] last token of the previous segment."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def rwkv_apply(params, x, ctx: Ctx):
    """Full RWKV block: x + tmix(ln1(x)), then + cmix(ln2(.)).

    Token-shift states are the last *normed* tokens of each stream (so
    that decode continues exactly where prefill left off); prefill takes
    them, and the wkv state, at each row's last valid token.
    """
    cfg = ctx.cfg
    B, S, D = x.shape
    hd = cfg.rwkv_head_size
    H = D // hd
    tm = params["rwkv"]["tmix"]
    cm = params["rwkv"]["cmix"]
    cache = ctx.cache
    if ctx.mode == "decode":
        prev_t, prev_c, s0 = cache["shift_t"], cache["shift_c"], cache["s"]
    else:
        prev_t = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        prev_c = torch.zeros((B, D), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=x.device)

    # ---- time-mix ----
    h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
    xx = _token_shift(h1, prev_t)

    def mix(mu):
        return h1 + mu * (xx - h1)

    r = linear(mix(tm["mu_r"]), tm["wr"]).reshape(B, S, H, hd)
    k = linear(mix(tm["mu_k"]), tm["wk"]).reshape(B, S, H, hd)
    v = linear(mix(tm["mu_v"]), tm["wv"]).reshape(B, S, H, hd)
    g = linear(mix(tm["mu_g"]), tm["wg"])
    decay_raw = tm["w0"] + linear(mix(tm["mu_w"]), tm["ww"]).float()
    w = torch.exp(-torch.exp(decay_raw)).reshape(B, S, H, hd)
    if ctx.mode == "prefill" and ctx.valid is not None:
        # pads: decay 1 and no kv injection, so the state stops at the
        # last valid token
        vm = ctx.valid[:, :, None, None]
        w = torch.where(vm, w, torch.ones_like(w))
        k = torch.where(vm, k, torch.zeros_like(k))

    o, sT = rwkv_ops.rwkv6_scan(r, k, v, w, tm["u"], s0, impl=_SCAN_IMPL)
    o = group_norm_heads(o, tm["gn_scale"], tm["gn_bias"]).to(x.dtype)
    o = o * F.silu(g.float()).to(o.dtype)
    x2 = x + linear(o, tm["wo"])

    # ---- channel-mix ----
    h2 = apply_norm(params["ln2"], x2, cfg.norm_eps)
    xx2 = _token_shift(h2, prev_c)
    zk = h2 + cm["mu_k"] * (xx2 - h2)
    hc = torch.square(torch.relu(linear(zk, cm["wk"]).float()))
    out = x2 + linear(hc.to(x.dtype), cm["wv"])

    if ctx.mode in ("prefill", "decode"):
        if ctx.mode == "prefill" and ctx.lengths is not None:
            bidx = torch.arange(B, device=x.device)
            last = (ctx.lengths - 1).clamp(0, S - 1).long()
            st, sc = h1[bidx, last], h2[bidx, last]
        else:
            st, sc = h1[:, -1], h2[:, -1]
        cache["s"].copy_(sT)
        cache["shift_t"].copy_(st)
        cache["shift_c"].copy_(sc)
    return out, cache


def rwkv_cache_init(cfg: cfgs.ModelConfig, batch: int, *, dtype, device):
    D = cfg.d_model
    hd = cfg.rwkv_head_size
    H = D // hd
    return {"s": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "shift_t": torch.zeros((batch, D), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, D), dtype=dtype, device=device)}


# ===========================================================================
# dispatch table
# ===========================================================================


def block_init(blk: str, gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    dev = gen.device
    if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN):
        return {"ln1": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
                "ln2": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
                "attn": attn_init(gen, cfg, dtype),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}
    if blk == cfgs.RGLRU:
        return {"ln1": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
                "ln2": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
                "rec": rglru_init(gen, cfg, dtype),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}
    if blk == cfgs.RWKV:
        return {"ln1": norm_init(cfg.d_model, dtype, dev, True),
                "ln2": norm_init(cfg.d_model, dtype, dev, True),
                "rwkv": rwkv_init(gen, cfg, dtype)}
    raise NotImplementedError(f"block {blk!r} is not yet ported")


def block_cache_init(blk: str, cfg: cfgs.ModelConfig, batch: int, smax: int,
                     dtype, device):
    if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN):
        window = cfg.attention_window if blk == cfgs.LOCAL_ATTN else 0
        return attn_cache_init(cfg, batch, smax, window=window, dtype=dtype,
                               device=device)
    if blk == cfgs.RGLRU:
        return rglru_cache_init(cfg, batch, dtype=dtype, device=device)
    if blk == cfgs.RWKV:
        return rwkv_cache_init(cfg, batch, dtype=dtype, device=device)
    raise NotImplementedError(f"block {blk!r} is not yet ported")


def block_apply(blk: str, params, x, ctx: Ctx):
    cfg = ctx.cfg
    if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN):
        window = cfg.attention_window if blk == cfgs.LOCAL_ATTN else 0
        h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
        a_out, new_cache = attn_apply(params["attn"], h1, ctx, window=window)
    elif blk == cfgs.RGLRU:
        h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
        a_out, new_cache = rglru_apply(params["rec"], h1, ctx)
    elif blk == cfgs.RWKV:
        # rwkv_apply does its own norms, residuals and token-shift state
        return rwkv_apply(params, x, ctx)
    else:
        raise NotImplementedError(f"block {blk!r} is not yet ported")
    x = x + a_out
    h2 = apply_norm(params["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(params["mlp"], h2), new_cache
