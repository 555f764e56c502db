"""Whisper-style audio encoder-decoder: the PyTorch counterpart of
``repro.models.whisper``.

The conv / mel front end is a stub, as in the JAX package: the model takes
precomputed frame embeddings [B, encoder_seq, d_model] (``batch["frames"]``).
The encoder is ``encoder_layers`` pre-LayerNorm blocks of non-causal
self-attention and a gated MLP over the frames plus learned positions.
The decoder is ``num_layers`` blocks of causal self-attention (cached),
cross-attention over the encoder output (its K / V computed once, at
prefill, and kept in the cache) and a gated MLP, over learned positions;
no RoPE.  Every projection has a bias; the embedding is tied.

Params are plain dicts of tensors; each stack of layers is a list of
per-layer dicts (``enc_layers``, ``dec_layers``), where the JAX package
stacks them on a leading axis.  The decode cache keeps the JAX layout:
``"k" | "v"`` [L, B, Smax, KV, hd], ``"xk" | "xv"`` [L, B, encoder_seq,
KV, hd] and ``"len"`` [B]; prefill and decode update it in place.

On the card every attention goes through the hand-written kernels: the
encoder's self-attention and every cross-attention through the flash
attention kernel (K2) with ``causal=False``, a decode step's included
(one query over the encoder's keys); the decoder's self-attention through
K2 in a full-sequence pass and the flash-decode kernel (K1) in a decode
step.  With the shard context armed and the cache's sequence sharded
over ``model``, a decode step's self-attention writes into the owning
rank and runs K1 on each rank's chunk (``attention.sharded_cache_decode``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import base as cfgs
from repro_torch.models import attention as attn
from repro_torch.models import blocks, shardctx
from repro_torch.models.common import (apply_mlp, apply_norm, dtype_of,
                                       embed_init, last_rows, linear, lookup,
                                       mlp_init, norm_init)


def init_params(cfg: cfgs.ModelConfig, gen: torch.Generator, dtype=None
                ) -> Dict[str, Any]:
    """Random params drawn from ``gen``, on ``gen.device``."""
    dtype = dtype or dtype_of(cfg.dtype)
    d, dev = cfg.d_model, gen.device

    def ln():
        return norm_init(d, dtype, dev, True)

    def mlp():
        return mlp_init(gen, d, cfg.d_ff, dtype, cfg.use_bias)

    return {
        "embed": {"w": embed_init(gen, cfg.vocab_size, d, dtype)},
        "pos_embed": {"w": embed_init(gen, cfg.max_pos_embed, d, dtype)},
        "enc_pos": {"w": embed_init(gen, cfg.encoder_seq, d, dtype)},
        "enc_layers": [{"ln1": ln(), "attn": blocks.attn_init(gen, cfg, dtype),
                        "ln2": ln(), "mlp": mlp()}
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": ln(),
        "dec_layers": [{"ln1": ln(), "attn": blocks.attn_init(gen, cfg, dtype),
                        "lnx": ln(),
                        "xattn": blocks.attn_init(gen, cfg, dtype),
                        "ln2": ln(), "mlp": mlp()}
                       for _ in range(cfg.num_layers)],
        "final_norm": ln(),
    }


def init_cache(cfg: cfgs.ModelConfig, batch: int, smax: int, dtype=None,
               device="cpu") -> Dict[str, Any]:
    dtype = dtype or dtype_of(cfg.dtype)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zero(s):
        return torch.zeros((L, batch, s, KV, hd), dtype=dtype, device=device)

    return {"k": zero(smax), "v": zero(smax), "xk": zero(cfg.encoder_seq),
            "xv": zero(cfg.encoder_seq),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _heads(x, p, name, n, cfg):
    """The projection ``w{name}`` (+ ``b{name}``) of x [B,S,D] as
    [B, S, n, hd]."""
    return blocks.split_heads(linear(x, p[f"w{name}"], p.get(f"b{name}")),
                              n, cfg.head_dim)


def _self_qkv(p, x, cfg):
    """q, k, v of a self-attention: no RoPE whatever ``use_rope`` says
    (the smoke config leaves it on), as in the JAX package."""
    return (_heads(x, p, "q", cfg.num_heads, cfg),
            _heads(x, p, "k", cfg.num_kv_heads, cfg),
            _heads(x, p, "v", cfg.num_kv_heads, cfg))


def _out(p, o):
    """The output projection of attention heads o [B,S,H,hd]."""
    return linear(blocks.merge_heads(o), p["wo"], p.get("bo"))


def encode(cfg: cfgs.ModelConfig, params, frames):
    """frames: [B, encoder_seq, D] -> encoder output [B, encoder_seq, D]."""
    x = (frames.to(device=params["enc_pos"]["w"].device,
                   dtype=dtype_of(cfg.dtype))
         + params["enc_pos"]["w"][None])
    for lp in params["enc_layers"]:
        q, k, v = _self_qkv(lp["attn"], apply_norm(lp["ln1"], x, cfg.norm_eps),
                            cfg)
        x = x + _out(lp["attn"], attn.causal_attention(q, k, v, causal=False))
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg.norm_eps))
    return apply_norm(params["enc_norm"], x, cfg.norm_eps)


def apply(cfg: cfgs.ModelConfig, params, batch, *, mode: str, cache=None,
          remat: bool = True):
    """Whisper forward.  batch: {"tokens": [B,S], "frames": [B,Senc,D]
    (train / prefill), optional "lengths" [B] (prefill)}.  Returns a dict
    with hidden [B,S,D] (train, decode) or last_hidden [B,D] (prefill),
    the cache (prefill, decode) and ``aux`` (0: no mixture of experts).
    In train mode with ``remat`` each decoder layer runs under activation
    checkpointing, as in the JAX package (the encoder's layers do not)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"]["w"].device
    if mode == "decode":
        enc_out = None
        lengths = cache["len"] + S
        positions = (lengths - 1)[:, None]
    else:
        enc_out = encode(cfg, params, batch["frames"])
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    x = (lookup(params["embed"]["w"], tokens)
         + lookup(params["pos_embed"]["w"], positions))

    def layer_fn(layer, x, enc_out):
        lp = params["dec_layers"][layer]
        # causal self-attention
        q, k, v = _self_qkv(lp["attn"],
                            apply_norm(lp["ln1"], x, cfg.norm_eps), cfg)
        if mode == "decode":
            if S == 1 and attn.seq_sharded_decode_ready(cache["k"][layer]):
                o, ck, cv = attn.sharded_cache_decode(
                    q, cache["k"][layer], cache["v"][layer], k, v, lengths)
            else:
                ck, cv = attn.write_kv(cache["k"][layer], cache["v"][layer],
                                       k, v, lengths - S)
                o = attn.decode_attention(q, ck, cv, lengths)
        else:
            o = attn.causal_attention(q, k, v)
            if mode == "prefill":
                blocks.write_prefix(cache["k"][layer], k)
                blocks.write_prefix(cache["v"][layer], v)
        x = x + _out(lp["attn"], o)
        # cross-attention over the encoder output
        xp = lp["xattn"]
        qx = _heads(apply_norm(lp["lnx"], x, cfg.norm_eps), xp, "q",
                    cfg.num_heads, cfg)
        if mode == "decode":
            xk, xv = cache["xk"][layer], cache["xv"][layer]
        else:
            xk = _heads(enc_out, xp, "k", cfg.num_kv_heads, cfg)
            xv = _heads(enc_out, xp, "v", cfg.num_kv_heads, cfg)
            if mode == "prefill":
                shardctx.assign(cache["xk"][layer], xk)
                shardctx.assign(cache["xv"][layer], xv)
        x = x + _out(xp, attn.causal_attention(qx, xk, xv, causal=False))
        # mlp
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg.norm_eps))
        return x

    for layer in range(cfg.num_layers):
        if mode == "train" and remat:
            x = checkpoint(layer_fn, layer, x, enc_out, use_reentrant=False)
        else:
            x = layer_fn(layer, x, enc_out)

    x = apply_norm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    if mode == "train":
        return {"hidden": x, "aux": aux}
    cache["len"] = lengths
    if mode == "prefill":
        return {"last_hidden": last_rows(x, lengths), "cache": cache,
                "aux": aux}
    return {"hidden": x, "cache": cache, "aux": aux}
