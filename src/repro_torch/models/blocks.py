"""Transformer blocks: the PyTorch counterpart of ``repro.models.blocks``.

The port implements the global-attention block (``ATTN``) with the dense
gated MLP.  Every block has three entry points behind one interface:

    block_init(blk, gen, cfg, dtype)          -> params
    block_cache_init(blk, cfg, batch, smax)   -> cache (decode state)
    block_apply(blk, params, x, ctx)          -> (y, new_cache)

``ctx.mode`` is one of "train" (no cache), "prefill" (full sequence, writes
the cache), "decode" (new tokens against the cache).  Caches are updated in
place and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs import base as cfgs
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, apply_rope,
                                       dense_init, linear, mlp_init,
                                       norm_init)


@dataclasses.dataclass
class Ctx:
    cfg: cfgs.ModelConfig
    mode: str                       # train | prefill | decode
    positions: Any                  # [B,S] int
    lengths: Optional[Any] = None   # [B] valid tokens incl. current step
    cache: Any = None               # this block's cache slice

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ===========================================================================
# Attention block (global), GQA + RoPE
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


def attn_apply(params, x, ctx: Ctx):
    cfg = ctx.cfg
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, ctx.positions)
    new_cache = ctx.cache
    if ctx.mode == "decode":
        start = ctx.lengths - S
        ck, cv = attn.write_kv(ctx.cache["k"], ctx.cache["v"], k, v, start)
        out = attn.decode_attention(q, ck, cv, ctx.lengths)
    else:
        out = attn.causal_attention(q, k, v)
        if ctx.mode == "prefill":
            ck, cv = ctx.cache["k"], ctx.cache["v"]
            ck[:, :S] = k
            cv[:, :S] = v
            ck[:, S:].zero_()
            cv[:, S:].zero_()
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return linear(out, params["wo"]), new_cache


def attn_cache_init(cfg: cfgs.ModelConfig, batch: int, smax: int, *, dtype,
                    device):
    shape = (batch, smax, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# dispatch table
# ===========================================================================


def _ported(blk: str) -> None:
    if blk != cfgs.ATTN:
        raise NotImplementedError(f"block {blk!r} is not yet ported")


def block_init(blk: str, gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    _ported(blk)
    dev = gen.device
    return {"ln1": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
            "ln2": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
            "attn": attn_init(gen, cfg, dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def block_cache_init(blk: str, cfg: cfgs.ModelConfig, batch: int, smax: int,
                     dtype, device):
    _ported(blk)
    return attn_cache_init(cfg, batch, smax, dtype=dtype, device=device)


def block_apply(blk: str, params, x, ctx: Ctx):
    _ported(blk)
    cfg = ctx.cfg
    h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
    a_out, new_cache = attn_apply(params["attn"], h1, ctx)
    x = x + a_out
    h2 = apply_norm(params["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(params["mlp"], h2), new_cache
