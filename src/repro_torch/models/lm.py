"""Decoder-only language model: the PyTorch counterpart of
``repro.models.lm``.

The model is ``num_periods`` repetitions of ``cfg.period`` followed by
``cfg.tail``.  The JAX package stacks each period position's params on a
leading axis and scans over it; here the params are a list of per-layer
dicts (layer ``p * len(period) + i`` is period ``p``, position ``i``; the
tail's layers follow the periods') and the forward pass is a loop over
layers.  The decode cache keeps the JAX layout: ``cache["periods"]["b{i}"]``
holds each period position's state stacked on a leading ``[P]`` axis
(``"k"|"v"`` ``[P, B, Smax, KV, hd]`` for attention, ``[P, B, W, KV, hd]``
rings for sliding-window attention, ``"ckv"`` ``[P, B, Smax, r + rope]``
for latent attention, ``"h"|"conv"`` for RG-LRU,
``"s"|"shift_t"|"shift_c"`` for RWKV-6), ``cache["tail"]["t{i}"]`` the
tail blocks' states, and ``cache["len"]`` is ``[B]``.  Modes:

  * train:   full sequence, no cache, returns hidden states
  * prefill: full (right-padded) sequence, writes the cache, returns the
             hidden state of the last valid token per sequence
  * decode:  new tokens against the cache (the batch's optional
             ``valid`` [B, S] marks the real ones, for the layers' counts)

A ``patches`` front end (qwen2-vl) prepends the batch's precomputed patch
embeddings [B, P, D] to the token embeddings outside decode, so a pass
runs over P + S positions; ``lengths``, the pad mask and the last hidden
state stay indexed as in the JAX package, by text tokens from the start
of the pass.  Positions come from the batch where it has them ([B, S],
or [B, S, 3] streams for M-RoPE), else from ``_default_positions``.
The cache passed to prefill / decode is updated in place and returned.
The training loss is :func:`ce_loss_chunked`, which never holds the
[B, S, V] logits at once.

With the shard context armed (``models/shardctx``) ``apply`` takes the
mesh from it for the expert-parallel MoE layers and pins the embedding
output, the carry between periods and the loss chunk's logits as the JAX
package does; the params, the batch and the cache are then DTensors.
"""
from __future__ import annotations

from typing import Any, Dict

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import base as cfgs
from repro_torch.models import blocks, shardctx
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       last_rows, lookup, norm_init,
                                       softcap)


def init_params(cfg: cfgs.ModelConfig, gen: torch.Generator, dtype=None
                ) -> Dict[str, Any]:
    """Random params drawn from ``gen``, on ``gen.device``.  With
    ``tie_embeddings`` there is no ``lm_head``: the logits go through the
    embedding's transpose."""
    dtype = dtype or dtype_of(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": {"w": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)},
        "final_norm": norm_init(cfg.d_model, dtype, gen.device,
                                cfg.use_layernorm),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": embed_init(gen, cfg.d_model,
                                             cfg.vocab_size, dtype)}
    if cfg.learned_pos_embed:
        params["pos_embed"] = {"w": embed_init(gen, cfg.max_pos_embed,
                                               cfg.d_model, dtype)}
    params["layers"] = [blocks.block_init(blk, gen, cfg, dtype, i)
                        for i, blk in enumerate(cfg.block_pattern)]
    return params


def init_cache(cfg: cfgs.ModelConfig, batch: int, smax: int, dtype=None,
               device="cpu") -> Dict[str, Any]:
    dtype = dtype or dtype_of(cfg.dtype)

    def one(blk):
        return blocks.block_cache_init(blk, cfg, batch, smax, dtype, device)

    periods = {}
    for i, blk in enumerate(cfg.period):
        periods[f"b{i}"] = {
            k: torch.zeros((cfg.num_periods,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device) for k, x in one(blk).items()}
    cache: Dict[str, Any] = {
        "periods": periods,
        "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.tail:
        cache["tail"] = {f"t{i}": one(blk) for i, blk in enumerate(cfg.tail)}
    return cache


def _embed(cfg, params, batch, mode):
    x = lookup(params["embed"]["w"], batch["tokens"])
    if cfg.scale_embedding:
        # sqrt(d_model) rounded to the model dtype first, as in JAX
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        x = x * scale.to(x.dtype).to(x.device)
    if cfg.frontend == "patches" and mode != "decode":
        # precomputed patch embeddings [B, P, D] before the tokens
        x = torch.cat([batch["patches"].to(device=x.device, dtype=x.dtype),
                       x], dim=1)
    if cfg.learned_pos_embed:
        pos = batch["positions"]
        if pos.dim() == 3:
            pos = pos[..., 0]
        x = x + lookup(params["pos_embed"]["w"], pos)
    return x


def _default_positions(cfg, batch, x, mode, lengths):
    if batch.get("positions") is not None:
        return batch["positions"]
    B, S = x.shape[0], x.shape[1]
    if mode == "decode":
        pos = (lengths - 1)[:, None]                             # [B,1]
    else:
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device)[None].expand(B, S)
    if cfg.mrope_sections:                      # the same on all 3 streams
        pos = pos[..., None].expand(pos.shape + (3,))
    return pos


def apply(cfg: cfgs.ModelConfig, params, batch, *, mode: str, cache=None,
          mesh_axes=None, remat: bool = True):
    """Run the backbone.  Returns a dict with hidden [B,S,D] (train),
    last_hidden [B,D] (prefill) or hidden [B,S,D] (decode), the cache
    (prefill / decode) and ``aux``, the summed load-balance loss of the
    mixture-of-experts layers (an fp32 scalar, 0 without them); a decode
    call also gives ``chunked_layers``, its layers that took K2's chunked
    entry (``blocks.attn_apply``).

    In train mode with ``remat`` each period's blocks run under
    activation checkpointing (recomputed in the backward pass, so their
    kernels launch twice a step), as the JAX package's
    ``jax.checkpoint`` of its period scan; the tail's blocks do not."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mesh_axes is None and shardctx.enabled():
        # launcher context: explicit expert parallelism for MoE layers
        mesh_axes = shardctx.mesh_info()
    x = _embed(cfg, params, batch, mode)
    x = shardctx.constrain(x, "dp", "sp" if mode == "train" else None, None)
    B, S = x.shape[0], x.shape[1]
    lengths = valid = None
    if mode == "prefill":
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        valid = (torch.arange(S, dtype=torch.int32, device=x.device)[None]
                 < lengths[:, None])                             # [B,S]
    elif mode == "decode":
        lengths = cache["len"] + S                           # S new tokens
        valid = batch.get("valid")     # the real ones, where the caller says
    positions = _default_positions(cfg, batch, x, mode, lengths)
    ctx = blocks.Ctx(cfg=cfg, mode=mode, positions=positions, lengths=lengths,
                     valid=valid, mesh_axes=mesh_axes)
    n = len(cfg.period)
    n_body = cfg.num_periods * n

    def run(lo, hi, x):
        """Layers [lo, hi) on x -> (x, their aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in range(lo, hi):
            c = None
            if mode != "train":
                if layer < n_body:
                    pc = cache["periods"][f"b{layer % n}"]
                    c = {k: t[layer // n] for k, t in pc.items()}
                else:
                    c = cache["tail"][f"t{layer - n_body}"]
            x, _, a = blocks.block_apply(cfg.block_pattern[layer],
                                         params["layers"][layer], x,
                                         ctx.replace(cache=c))
            aux = aux + a
            if layer < n_body and layer % n == n - 1:
                # pin the period-to-period carry: batch on dp; with
                # sequence parallelism on, the sequence on ``model``
                x = shardctx.constrain(x, "dp", "sp", None)
        return x, aux

    if mode == "train" and remat:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in range(cfg.num_periods):
            x, a = checkpoint(run, p * n, (p + 1) * n, x, use_reentrant=False)
            aux = aux + a
        x, a = run(n_body, cfg.num_layers, x)
        aux = aux + a
    else:
        x, aux = run(0, cfg.num_layers, x)
    x = apply_norm(params["final_norm"], x, cfg.norm_eps)

    if mode == "train":
        return {"hidden": x, "aux": aux}
    cache["len"] = lengths
    if mode == "prefill":
        return {"last_hidden": last_rows(x, lengths), "cache": cache,
                "aux": aux}
    return {"hidden": x, "cache": cache, "aux": aux,
            "chunked_layers": ctx.memo.get("chunked_layers", 0)}


def cache_capacity(cache) -> int:
    if cache is None:
        return 0
    for c in cache.get("periods", {}).values():
        if "k" in c:
            return c["k"].shape[2]  # [P, B, Smax, KV, hd]
    for c in cache.get("tail", {}).values():
        if "k" in c:
            return c["k"].shape[1]
    return 0


def unembed_w(cfg, params):
    """The [D, V] output projection: the embedding's transpose when tied."""
    if cfg.tie_embeddings:
        return params["embed"]["w"].T
    return params["lm_head"]["w"]


def logits_of(cfg, params, hidden):
    """hidden [..., D] -> logits [..., V] in fp32.  Both operands are
    upcast before the product: the JAX package asks for an fp32 result,
    and a bf16 product would round its output to bf16."""
    logits = hidden.float() @ unembed_w(cfg, params).float()
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _ce_chunk(cfg, w, hc, lc, mc):
    """Summed masked NLL and mask of one chunk: hc [B,c,D], lc, mc [B,c]."""
    logits = hc.float() @ w.float()
    # vocab-sharded logits; never replicate the [B, chunk, V] tensor
    logits = shardctx.constrain(logits, "dp", None, "tp")
    if cfg.logit_softcap:
        logits = softcap(logits, cfg.logit_softcap)
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    tgt = torch.gather(logits, -1, lc.long()[..., None])
    nll = (logz - tgt)[..., 0] * mc
    return nll.sum(), mc.sum()


def ce_loss_chunked(cfg, params, hidden, labels, loss_mask=None,
                    chunk: int = 512):
    """Causal LM loss without materialising [B,S,V].

    hidden: [B,S,D]; labels: [B,S] (already shifted by the caller:
    labels[t] is the target for hidden[t]).  Chunks of ``chunk``
    positions (the tail padded with label 0 and mask 0) each run under
    activation checkpointing, so no [B, chunk, V] logits outlive their
    chunk.  Returns (mean_loss, token_count), fp32 scalars.
    """
    B, S, D = hidden.shape
    w = unembed_w(cfg, params)
    if loss_mask is None:
        loss_mask = torch.ones((B, S), dtype=torch.float32,
                               device=hidden.device)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        loss_mask = torch.nn.functional.pad(loss_mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        t, c = checkpoint(_ce_chunk, cfg, w, hidden[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk],
                          loss_mask[:, c0:c0 + chunk], use_reentrant=False)
        total = total + t
        count = count + c
    return total / torch.clamp(count, min=1.0), count
