"""Decoder-only language model: the PyTorch counterpart of
``repro.models.lm``.

The model is ``num_periods`` repetitions of ``cfg.period``.  The JAX
package stacks each period position's params on a leading axis and scans
over it; here the params are a list of per-layer dicts (layer
``p * len(period) + i`` is period ``p``, position ``i``) and the forward
pass is a loop over layers.  The decode cache keeps the JAX layout:
``cache["periods"]["b{i}"]["k"|"v"]`` is ``[P, B, Smax, KV, hd]`` and
``cache["len"]`` is ``[B]``.  Modes:

  * train:   full sequence, no cache, returns hidden states
  * prefill: full (right-padded) sequence, writes the cache, returns the
             hidden state of the last valid token per sequence
  * decode:  new tokens against the cache

The cache passed to prefill / decode is updated in place and returned.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import base as cfgs
from repro_torch.models import blocks
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       norm_init, softcap)


def init_params(cfg: cfgs.ModelConfig, gen: torch.Generator, dtype=None
                ) -> Dict[str, Any]:
    """Random params drawn from ``gen``, on ``gen.device``."""
    dtype = dtype or dtype_of(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": {"w": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)},
        "final_norm": norm_init(cfg.d_model, dtype, gen.device,
                                cfg.use_layernorm),
        "lm_head": {"w": embed_init(gen, cfg.d_model, cfg.vocab_size,
                                    dtype)},
    }
    params["layers"] = [blocks.block_init(blk, gen, cfg, dtype)
                        for blk in cfg.block_pattern]
    return params


def init_cache(cfg: cfgs.ModelConfig, batch: int, smax: int, dtype=None,
               device="cpu") -> Dict[str, Any]:
    dtype = dtype or dtype_of(cfg.dtype)
    periods = {}
    for i, blk in enumerate(cfg.period):
        one = blocks.block_cache_init(blk, cfg, batch, smax, dtype, device)
        periods[f"b{i}"] = {
            k: torch.zeros((cfg.num_periods,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device) for k, x in one.items()}
    return {"periods": periods,
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _embed(cfg, params, batch):
    return params["embed"]["w"][batch["tokens"].long()]


def _default_positions(cfg, batch, x, mode, lengths):
    if batch.get("positions") is not None:
        return batch["positions"]
    B, S = x.shape[0], x.shape[1]
    if mode == "decode":
        return (lengths - 1)[:, None]                            # [B,1]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def apply(cfg: cfgs.ModelConfig, params, batch, *, mode: str, cache=None):
    """Run the backbone.  Returns a dict with hidden [B,S,D] (train),
    last_hidden [B,D] (prefill) or hidden [B,S,D] (decode), and the cache
    (prefill / decode)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = _embed(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    lengths = None
    if mode == "prefill":
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    elif mode == "decode":
        lengths = cache["len"] + S                           # S new tokens
    positions = _default_positions(cfg, batch, x, mode, lengths)
    ctx = blocks.Ctx(cfg=cfg, mode=mode, positions=positions, lengths=lengths)
    n = len(cfg.period)
    for layer, (blk, p) in enumerate(zip(cfg.block_pattern,
                                         params["layers"])):
        c = None
        if mode != "train":
            pc = cache["periods"][f"b{layer % n}"]
            c = {k: t[layer // n] for k, t in pc.items()}
        x, _ = blocks.block_apply(blk, p, x, ctx.replace(cache=c))
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)

    if mode == "train":
        return {"hidden": x}
    cache["len"] = lengths
    if mode == "prefill":
        bidx = torch.arange(B, device=x.device)
        last = (lengths - 1).clamp(0, S - 1).long()
        return {"last_hidden": x[bidx, last], "cache": cache}
    return {"hidden": x, "cache": cache}


def cache_capacity(cache) -> int:
    if cache is None:
        return 0
    for c in cache.get("periods", {}).values():
        if "k" in c:
            return c["k"].shape[2]  # [P, B, Smax, KV, hd]
    return 0


def logits_of(cfg, params, hidden):
    """hidden [..., D] -> logits [..., V] in fp32.  Both operands are
    upcast before the product: the JAX package asks for an fp32 result,
    and a bf16 product would round its output to bf16."""
    logits = hidden.float() @ params["lm_head"]["w"].float()
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits
