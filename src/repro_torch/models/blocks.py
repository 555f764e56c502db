"""Model blocks: the PyTorch counterpart of ``repro.models.blocks``.

The port implements the global- and sliding-window attention blocks
(``ATTN``, ``LOCAL_ATTN``, with qk-norm and parallel attention + MLP as
options, biases where the config has them, RoPE or M-RoPE) and the
multi-head latent attention block (``MLA``, DeepSeek-V2 / V3), each
with the dense gated MLP or a token-choice mixture of experts (softmax
or DeepSeek-V3's sigmoid router; ``cfg.is_moe_layer``), the RG-LRU
recurrent block (``RGLRU``, recurrentgemma) and the RWKV-6 block
(``RWKV``).  Every block has three entry points behind one interface:

    block_init(blk, gen, cfg, dtype, layer)   -> params
    block_cache_init(blk, cfg, batch, smax)   -> cache (decode state)
    block_apply(blk, params, x, ctx)          -> (y, new_cache, aux_loss)

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

On the mesh path (``models/shardctx`` armed, params and caches DTensors
placed by ``launch/sharding``) the blocks carry the JAX package's mesh
code: the q / k / v pins of ``_qkv``, q heads zero-padded up to a multiple
of the ``model`` axis where they do not divide it (``_padded_heads``),
the sequence-sharded single-token decode, cache writes that land in each
rank's own slice (``shardctx.assign``), and the expert-parallel mixture
of experts (:func:`moe_apply`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import base as cfgs
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.models import attention as attn
from repro_torch.models import shardctx
from repro_torch.models.common import (apply_mlp, apply_norm, apply_rope,
                                       dense_init, group_norm_heads, linear,
                                       mlp_init, norm_init, rope_cos_sin,
                                       rotate_pairs)
from repro_torch.obs import engine as obs_engine

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
    positions: Any                  # [B,S] int or [B,S,3] (M-RoPE)
    lengths: Optional[Any] = None   # [B] valid tokens incl. current step
    valid: Optional[Any] = None     # [B,S] bool: the real tokens (prefill's
    #                                 pad mask; a batcher step's new ones)
    cache: Any = None               # this block's cache slice
    mesh_axes: Any = None           # (mesh, dp_axes, tp_axis) or None
    # values the layers of one forward share (``replace`` keeps the dict):
    # the chunked prefill's RoPE tables, made by its first layer, and the
    # count of its layers that took K2's chunked entry
    memo: dict = dataclasses.field(default_factory=dict)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ===========================================================================
# Attention block (global or sliding-window), GQA + RoPE (+ qk-norm)
# ===========================================================================


def attn_init(gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    d = cfg.d_model
    p = {"wq": dense_init(gen, d, cfg.q_dim, dtype),
         "wk": dense_init(gen, d, cfg.kv_dim, dtype),
         "wv": dense_init(gen, d, cfg.kv_dim, dtype),
         "wo": dense_init(gen, cfg.q_dim, d, dtype)}
    if cfg.use_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim), ("bo", d)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = norm_init(cfg.head_dim, dtype, gen.device, False)
        p["k_norm"] = norm_init(cfg.head_dim, dtype, gen.device, False)
    return p


def split_heads(y, n: int, hd: int):
    """A projection y [B, S, n*hd] as [B, S, n, hd].  On the mesh, a
    projection sharded over ``model`` where n heads don't divide it (the
    shard would cut a head) is gathered over ``model`` first."""
    B, S = y.shape[:2]
    if shardctx.is_dtensor(y) and n % shardctx.tp_size():
        y = shardctx.constrain(y, "dp", None, None)
    return y.reshape(B, S, n, hd)


def merge_heads(o):
    """Attention heads o [B, S, H, hd] as [B, S, H*hd], the output
    projection's input.  On the mesh, where H does not divide ``model``
    (the heads are replicated there), the gradient that comes back from
    the head-sharded projection is made replicated before it reaches the
    view: a view cannot cut a head (DTensor refuses to unflatten an
    uneven shard)."""
    B, S, H, hd = o.shape
    y = o.reshape(B, S, H * hd)
    if shardctx.is_dtensor(y) and H % shardctx.tp_size():
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def _projections(params, x, cfg: cfgs.ModelConfig):
    """q [B,S,H,hd], k, v [B,S,KV,hd]: the projections alone."""
    hd = cfg.head_dim
    q = split_heads(linear(x, params["wq"], params.get("bq")),
                    cfg.num_heads, hd)
    k = split_heads(linear(x, params["wk"], params.get("bk")),
                    cfg.num_kv_heads, hd)
    v = split_heads(linear(x, params["wv"], params.get("bv")),
                    cfg.num_kv_heads, hd)
    return q, k, v


def _qkv(params, x, cfg: cfgs.ModelConfig, positions):
    q, k, v = _projections(params, x, cfg)
    if cfg.qk_norm:
        # RMSNorm over each head, after the projection and before RoPE
        q = apply_norm(params["q_norm"], q, cfg.norm_eps)
        k = apply_norm(params["k_norm"], k, cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q = shardctx.constrain(q, "dp", None, "tp", None)
    k = shardctx.constrain(k, "dp", None, None, None)
    v = shardctx.constrain(v, "dp", None, None, None)
    return q, k, v


def _padded_heads(cfg: cfgs.ModelConfig) -> int:
    """Zero-pad q heads up to a multiple of the ``model`` axis when H
    doesn't divide it (qwen2-vl: 28 heads on a 16-way axis -> 32).  The
    extra heads' wo rows are zero, so the output is exact; the padded
    heads shard over ``model`` where H alone would be replicated."""
    if not shardctx.enabled():
        return cfg.num_heads
    t = shardctx.tp_size()
    H = cfg.num_heads
    if H % t == 0:
        return H
    Hp = ((H + t - 1) // t) * t
    if Hp % cfg.num_kv_heads != 0:     # GQA grouping must survive
        return H
    return Hp


def _pad_heads(q, n: int):
    """q [B, S, H, hd] with n zero heads after its H.  A DTensor q holds
    every head on each rank (H does not divide ``model``), so each rank
    pads its own shard (DTensor's pad fails in some torch versions)."""
    if not shardctx.is_dtensor(q):
        return F.pad(q, (0, 0, 0, n))
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(F.pad(q.to_local(), (0, 0, 0, n)),
                              q.device_mesh, q.placements, run_check=False)


def _pad_rows(w, n: int):
    """w [R, D] with n zero rows after its R.  A DTensor w is gathered to
    whole rows first, padded on each rank and placed as it was (the
    padded rows divide ``model``), since DTensor's pad of a split dim
    fails in some torch versions."""
    if not shardctx.is_dtensor(w):
        return F.pad(w, (0, 0, 0, n))
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = w.device_mesh, tuple(w.placements)
    whole = [Replicate() if p == Shard(0) else p for p in pl]
    w = w.redistribute(mesh, whole)
    w = DTensor.from_local(F.pad(w.to_local(), (0, 0, 0, n)), mesh, whole,
                           run_check=False)
    return w.redistribute(mesh, pl)


def _chunked_prefill(params, x, ctx: Ctx):
    """A decode call with several new tokens a row through K2's chunked
    entry: the projections here, then qk-norm, RoPE, the cache append and
    the attention in its two launches (``attention.takes_chunked_kernel``
    decides).  The RoPE tables are made once a forward; a layer whose
    kernels ran counts itself in ``ctx.memo["chunked_layers"]``."""
    cfg = ctx.cfg
    q, k, v = _projections(params, x, cfg)
    rope = None
    if cfg.use_rope:
        rope = ctx.memo.get("rope")
        if rope is None:
            rope = ctx.memo["rope"] = rope_cos_sin(
                ctx.positions, cfg.head_dim, cfg.rope_theta)
    norms = ((params["q_norm"]["scale"], params["k_norm"]["scale"])
             if cfg.qk_norm else (None, None))
    out, kernel = attn.chunked_prefill_attention(
        q, k, v, ctx.cache["k"], ctx.cache["v"], ctx.lengths,
        q_norm=norms[0], k_norm=norms[1], eps=cfg.norm_eps, rope=rope)
    ctx.memo["chunked_layers"] = ctx.memo.get("chunked_layers", 0) + kernel
    return linear(merge_heads(out), params["wo"], params.get("bo"))


def attn_apply(params, x, ctx: Ctx, *, window: int = 0):
    cfg = ctx.cfg
    B, S, _ = x.shape
    if (ctx.mode == "decode" and tuple(ctx.positions.shape) == (B, S)
            and attn.takes_chunked_kernel(x, cfg, params, window)):
        # (a decode call without positions rotates every new token at the
        # row's last position: the plain path broadcasts that)
        return _chunked_prefill(params, x, ctx), ctx.cache
    q, k, v = _qkv(params, x, cfg, ctx.positions)
    Hp = _padded_heads(cfg)
    if Hp != cfg.num_heads:
        q = shardctx.constrain(_pad_heads(q, Hp - cfg.num_heads),
                               "dp", None, "tp", None)
    new_cache = ctx.cache
    if ctx.mode == "decode":
        if window:
            pos = ctx.lengths - 1                   # absolute position
            ck, cv = attn.write_kv_ring(ctx.cache["k"], ctx.cache["v"], k, v,
                                        pos, window)
            out = attn.ring_decode_attention(q, ck, cv, pos, window)
        elif S == 1 and attn.seq_sharded_decode_ready(ctx.cache["k"]):
            # sequence-sharded cache: shard-local write + partial
            # attention per rank, combined by logsumexp
            out, ck, cv = attn.sharded_cache_decode(
                q, ctx.cache["k"], ctx.cache["v"], k, v, ctx.lengths)
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
                write_prefix(ck, k)
                write_prefix(cv, v)
    out = merge_heads(out)
    wo = params["wo"]
    if Hp != cfg.num_heads:                 # zero rows for padded heads
        wo = _pad_rows(wo, (Hp - cfg.num_heads) * cfg.head_dim)
    return linear(out, wo, params.get("bo")), new_cache


def write_prefix(cache, x):
    """Prefill's cache write: x [B,S,...] into cache [B,Smax,...] at
    positions 0..S-1, zeros past them, in place.  A pass longer than the
    cache raises ``TypeError``, as the JAX package's
    ``dynamic_update_slice`` does (qwen2-vl's patches make a pass P tokens
    longer than the text the engine sized the cache for)."""
    S = x.shape[1]
    if S > cache.shape[1]:
        raise TypeError(
            "dynamic_update_slice update shape must be smaller than operand "
            f"shape, got update shape {tuple(x.shape)} for operand shape "
            f"{tuple(cache.shape)}.")
    if shardctx.is_dtensor(cache) or shardctx.is_dtensor(x):
        # the mesh path: each rank writes its slice of the whole
        if shardctx.is_dtensor(x):
            x = x.full_tensor()
        full = x.new_zeros(tuple(cache.shape))
        full[:, :S] = x
        shardctx.assign(cache, full)
        return
    cache[:, :S] = x
    cache[:, S:].zero_()


def attn_cache_init(cfg: cfgs.ModelConfig, batch: int, smax: int, *,
                    window: int = 0, dtype, device):
    cap = window if window else smax
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ===========================================================================
# Multi-head latent attention (DeepSeek-V2 / V3), no q latent
# ===========================================================================
#
# Per position the cache holds one latent leaf ``ckv`` [B, Smax, r + rope]:
# c_n = kv_norm(x W_kva[:, :r]) and the rotated k_pe = RoPE(x W_kva[:, r:]),
# which all heads share.  A head's key is [c_n W_UK_h | k_pe] and its
# value c_n W_UV_h, W_kvb = [W_UK_h | W_UV_h] over the heads.  Full
# sequences (train, prefill) take the decompressed form, as the
# ``deepseek_v3`` code does; decode calls (the batcher's chunked prefill,
# single-token steps) the absorbed one over the gathered latent view:
# q~_h = q_nope_h W_UK_h^T, scores (q~_h . c_n + q_pe_h . k_pe) / sqrt(nope +
# rope), context sum p c_n, then W_UV_h.  Plain batched products, fp32
# softmax.  While a batcher step is recorded, the attention proper (past
# the projections, before ``wo``) is the span ``layer.attn``.


def mla_init(gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    """``wq`` [D, H (nope + rope)], ``wkv_a`` [D, r + rope] (the latent and
    the shared RoPE key), ``kv_norm`` over the latent, ``wkv_b`` [r, H (nope
    + v)] (each head's k_nope, then its v) and ``wo`` [H v, D]."""
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    return {"wq": dense_init(gen, d, cfg.q_dim, dtype),
            "wkv_a": dense_init(gen, d, r + cfg.qk_rope_head_dim, dtype),
            "kv_norm": norm_init(r, dtype, gen.device, False),
            "wkv_b": dense_init(gen, r, H * (cfg.qk_nope_head_dim
                                             + cfg.v_head_dim), dtype),
            "wo": dense_init(gen, H * cfg.v_head_dim, d, dtype)}


def mla_cache_init(cfg: cfgs.ModelConfig, batch: int, smax: int, *, dtype,
                   device):
    return {"ckv": torch.zeros((batch, smax, cfg.kv_lora_rank
                                + cfg.qk_rope_head_dim), dtype=dtype,
                               device=device)}


def _mla_inputs(params, x, ctx: Ctx):
    """q_nope [B,S,H,nope], the rotated q_pe [B,S,H,rope] and the new
    tokens' latent [B,S,r + rope].  RoPE turns the interleaved pairs of
    the ``deepseek_v3`` code; its tables are made once a forward."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = linear(x, params["wq"]).view(B, S, cfg.num_heads, cfg.head_dim)
    kv = linear(x, params["wkv_a"])
    rope = ctx.memo.get("mla_rope")
    if rope is None:
        rope = ctx.memo["mla_rope"] = rope_cos_sin(
            ctx.positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    cos, sin = rope                                         # [B, S, rope/2]
    q_pe = rotate_pairs(q[..., dn:], cos[:, :, None], sin[:, :, None])
    c = apply_norm(params["kv_norm"], kv[..., :r], cfg.latent_norm_eps)
    return q[..., :dn], q_pe, torch.cat([c, rotate_pairs(kv[..., r:], cos,
                                                         sin)], -1)


def _mla_full(params, q_nope, q_pe, lat, cfg, chunk: int = 512):
    """Causal attention over full sequences in the decompressed form:
    k = [c_n W_UK | k_pe], v = c_n W_UV, in blocks of ``chunk`` queries,
    fp32 scores and softmax.  Returns [B, S, H, v]."""
    B, S, H, dn = q_nope.shape
    r, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv = linear(lat[..., :r], params["wkv_b"]).view(B, S, H, -1)
    k = torch.cat([kv[..., :dn], lat[:, :, None, r:].expand(B, S, H, rope)],
                  -1).float()
    v = kv[..., dn:].float()
    q = torch.cat([q_nope, q_pe], -1).float()
    pos = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, chunk):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, c0:c0 + chunk], k)
        s = s / math.sqrt(dn + rope)
        keep = pos[None] <= pos[c0:c0 + chunk, None]
        p = torch.softmax(s.masked_fill(~keep, attn.NEG_INF), -1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v))
    return torch.cat(outs, 1).to(q_nope.dtype)


def _mla_absorbed(params, q_nope, q_pe, lat, ctx: Ctx):
    """A decode call of S new tokens a row: their latent written into the
    cache view ``ctx.cache["ckv"]`` at lengths - S (positions past its end
    land on its last slot, which the batcher never reads: a chunk overruns
    the gathered width only in a row it does not prefill), then the
    absorbed attention over the view, each query at ``ctx.positions``.
    Returns [B, S, H, v]."""
    cfg = ctx.cfg
    B, S, H, dn = q_nope.shape
    r = cfg.kv_lora_rank
    ckv = ctx.cache["ckv"]                                  # [B, Smax, r+rope]
    Smax = ckv.shape[1]
    dev = ckv.device
    idx = ((ctx.lengths - S).long()[:, None]
           + torch.arange(S, device=dev)[None]).clamp(max=Smax - 1)
    ckv[torch.arange(B, device=dev)[:, None], idx] = lat
    w = params["wkv_b"].view(r, H, -1)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w[..., :dn])
    qf = torch.cat([q_abs, q_pe], -1).reshape(B, S * H, -1)
    s = torch.bmm(qf, ckv.transpose(1, 2)).float().view(B, S, H, Smax)
    s.mul_(1.0 / math.sqrt(dn + cfg.qk_rope_head_dim))
    keep = torch.arange(Smax, device=dev) <= ctx.positions[..., None]
    s.masked_fill_(~keep[:, :, None], attn.NEG_INF)
    p = torch.softmax(s, -1).to(ckv.dtype).view(B, S * H, Smax)
    c = torch.bmm(p, ckv[..., :r]).view(B, S, H, r)
    return torch.einsum("bshr,rhd->bshd", c, w[..., dn:])


def mla_apply(params, x, ctx: Ctx):
    """The latent attention of x [B, S, D] (after the pre-norm): the
    projections, the attention (``layer.attn``), ``wo``.  Prefill writes
    the pass's latents into the cache, decode appends the new ones."""
    B, S, _ = x.shape
    q_nope, q_pe, lat = _mla_inputs(params, x, ctx)
    with obs_engine.layer("layer.attn"):
        if ctx.mode == "decode":
            out = _mla_absorbed(params, q_nope, q_pe, lat, ctx)
        else:
            out = _mla_full(params, q_nope, q_pe, lat, ctx.cfg)
            if ctx.mode == "prefill":
                write_prefix(ctx.cache["ckv"], lat)
    return linear(out.reshape(B, S, -1), params["wo"]), ctx.cache


# ===========================================================================
# MoE MLP (token-choice top-k with per-expert capacity)
# ===========================================================================
#
# ``moe_apply`` runs the single-device form, or, with the shard context
# armed and the tokens dividing the data axes and the experts the model
# axis, the JAX package's expert-parallel ``shard_map`` branch: each rank
# takes its tokens and its slice of the experts, and the outputs are
# summed over ``model``.


def moe_init(gen: torch.Generator, cfg: cfgs.ModelConfig, dtype):
    """Router (fp32 [D, E_padded], and the fp32 correction bias [E_padded]
    where the config has one, drawn N(0, 0.1^2) so that a router that
    ignores it shows) and stacked experts ``wi`` / ``wg`` [E, D, F], ``wo``
    [E, F, D], each expert drawn as ``dense_init`` into its slice of the
    stack (no fp32 copy of a stack), and the fused shared expert where the
    config has one."""
    m = cfg.moe
    E = m.padded_num_experts
    d, f = cfg.d_model, m.expert_d_ff

    def stack(din, dout):
        w = torch.empty((E, din, dout), dtype=dtype, device=gen.device)
        for e in range(E):
            w[e] = dense_init(gen, din, dout, dtype)
        return w

    p = {"router": {"w": dense_init(gen, d, E, torch.float32)},
         "experts": {"wi": stack(d, f), "wg": stack(d, f),
                     "wo": stack(f, d)}}
    if m.correction_bias:
        p["router"]["bias"] = 0.1 * torch.randn(
            (E,), generator=gen, dtype=torch.float32, device=gen.device)
    if m.num_shared_experts:
        p["shared"] = mlp_init(gen, d, m.shared_d_ff, dtype, cfg.use_bias)
    return p


def _top_k(x, k: int):
    """The k largest entries along the last axis and their indices, ties
    to the lower index as ``jax.lax.top_k`` breaks them: a stable
    descending sort, sliced (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gates(router_w, x2d, m: cfgs.MoEConfig, bias=None):
    """x2d [T, D] -> (the top-k gates scattered to [T, E], the router's
    probabilities [T, E]), fp32.  Padding experts are masked to -1e30
    before the softmax, so they are never chosen.  The softmax router
    chooses and weights by its probabilities.  The sigmoid router
    (``m.scoring``) scores s = sigmoid(logits), chooses the top k of s +
    ``bias`` (the correction bias, where given) and weights by s; its
    probabilities, for the balance loss, are s over their sum.  Then
    the chosen weights are renormalised (``m.norm_topk_prob``) and scaled
    by ``m.routed_scale``."""
    logits = x2d.float() @ router_w                        # [T, E] fp32
    E = m.padded_num_experts
    real = None
    if E > m.num_experts:
        real = torch.arange(E, device=logits.device) < m.num_experts
    if m.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores if bias is None else scores + bias
        if real is not None:
            scores = torch.where(real[None], scores, torch.zeros_like(scores))
            choice = torch.where(real[None], choice,
                                 torch.full_like(choice, -1e30))
        _, topi = _top_k(choice, m.num_experts_per_tok)
        topv = scores.gather(1, topi)
        probs = scores / scores.sum(-1, keepdim=True)
    else:
        if real is not None:
            logits = torch.where(real[None], logits,
                                 torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        topv, topi = _top_k(probs, m.num_experts_per_tok)
    if m.norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True)
    topv = topv * m.routed_scale
    return torch.zeros_like(probs).scatter_(1, topi, topv), probs


def _route(router_w, x2d, m: cfgs.MoEConfig, bias=None):
    """x2d [T, D] -> the gates [T, E] (fp32) and the Switch-style load
    balance aux loss (over the true experts only)."""
    gates, probs = _gates(router_w, x2d, m, bias)
    frac_tokens = (gates > 0).float().mean(0)
    frac_probs = probs.mean(0)
    aux = m.num_experts * (frac_tokens * frac_probs).sum()
    return gates, aux * m.router_aux_loss


def _moe_local(x2d, gates, wi, wg, wo, capacity: int):
    """Run tokens through the experts.

    x2d [T, D]; gates [T, E]; wi / wg [E, D, F]; wo [E, F, D].  Each
    expert takes up to ``capacity`` tokens by gate priority (ties to the
    lower token index; the rest are dropped, as under a capacity factor)
    and weights its output by the gate.  Returns the [T, D] sum of each
    token's expert outputs.  Each expert holds a token at most once, so
    every expert's outputs are scattered into a plane of their own and
    the planes summed: the same sum on every run, where an accumulating
    scatter on the card may add in any order.
    """
    T, D = x2d.shape
    E = wi.shape[0]
    g, idx = _top_k(gates.T, min(capacity, T))             # [E, C]
    tok = x2d[idx]                                         # [E, C, D]
    valid = g > 0
    h = torch.bmm(tok, wi)
    gate = torch.bmm(tok, wg)
    h = F.silu(gate.float()).to(h.dtype) * h
    out = torch.bmm(h, wo)                                 # [E, C, D]
    out = out * (g * valid)[..., None].to(out.dtype)
    planes = out.new_zeros((E, T, D))
    planes.scatter_(1, idx[..., None].expand(-1, -1, D), out)
    return planes.sum(0)


def _capacity(m: cfgs.MoEConfig, t_loc: int, mode: str) -> int:
    """Per-expert token capacity.  Decode is dropless (every expert runs
    all T tokens); train and prefill take ceil(k * T * factor / experts)
    over the unpadded expert count, T counting padding tokens."""
    if mode == "decode":
        return t_loc
    return min(t_loc, max(1, math.ceil(
        m.num_experts_per_tok * t_loc * m.capacity_factor / m.num_experts)))


def _ep_axes(ctx: Ctx, T: int, E: int):
    """(mesh, dp axes, tp axis) when the expert-parallel branch applies:
    the context is armed, the tokens divide the data axes and the
    experts the model axis (the JAX package's gate); else None."""
    if ctx.mesh_axes is None:
        return None
    from repro_torch.launch import sharding
    mesh, dp, tp = ctx.mesh_axes
    dp = dp if isinstance(dp, tuple) else (dp,)
    if T % sharding._axis_size(mesh, dp) or E % sharding._axis_size(mesh,
                                                                     tp):
        return None
    return mesh, dp, tp


def _moe_ep(params, x2d, m: cfgs.MoEConfig, mode: str, axes):
    """The expert-parallel branch on DTensors: each rank routes its T / dp
    tokens, keeps the gates of its E / tp experts, runs them with the
    capacity of its local token count, and the partial outputs are
    summed over ``model``.  The load-balance loss takes the means over all
    tokens (sums reduced over the data axes), as the JAX package routes
    the whole batch before its ``shard_map``.  Returns (y2d, aux), both
    DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch import sharding
    from repro_torch.launch.sharding import placements
    mesh, dp, tp = axes
    names = tuple(mesh.mesh_dim_names)
    tok_spec = (dp, None)
    xl = x2d.redistribute(mesh, placements(mesh, tok_spec)).to_local()
    rw, bias = (None if t is None else t.redistribute(
        mesh, [Replicate()] * len(names)).to_local()
        for t in (params["router"]["w"], params["router"].get("bias")))
    T_loc = xl.shape[0]
    gates, probs = _gates(rw, xl, m, bias)                  # [T_loc, E]
    # global means of the Switch loss: per-rank sums, summed over dp
    sums = torch.stack([(gates > 0).float().sum(0), probs.sum(0)])
    red = [Partial() if n in dp else Replicate() for n in names]
    sums = DTensor.from_local(sums, mesh, red, run_check=False).redistribute(
        mesh, [Replicate()] * len(names))
    means = sums / (T_loc * sharding._axis_size(mesh, dp))
    aux = m.num_experts * (means[0] * means[1]).sum() * m.router_aux_loss
    # this rank's experts: E / tp of them, the whole D
    e_spec = (tp, None, None)
    e = {k: w.redistribute(mesh, placements(mesh, e_spec)).to_local()
         for k, w in params["experts"].items()}
    E_loc = e["wi"].shape[0]
    off = mesh.get_local_rank(tp) * E_loc
    cap = _capacity(m, T_loc, mode)
    y = _moe_local(xl, gates[:, off:off + E_loc], e["wi"], e["wg"], e["wo"],
                   cap)
    out = [Partial() if n == tp else p for n, p in
           zip(names, placements(mesh, tok_spec))]
    y2d = DTensor.from_local(y, mesh, out, run_check=False).redistribute(
        mesh, placements(mesh, tok_spec))
    return y2d, aux


def moe_apply(params, x, ctx: Ctx):
    """x [B, S, D] -> (y [B, S, D], aux loss): routed experts, plus the
    fused shared expert where there is one."""
    m = ctx.cfg.moe
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    axes = _ep_axes(ctx, B * S, m.padded_num_experts)
    if axes is not None and shardctx.is_dtensor(x2d):
        y2d, aux = _moe_ep(params, x2d, m, ctx.mode, axes)
        if tuple(y2d.placements) != tuple(x2d.placements):
            # the tokens split over the data axes where the batch does not
            # (B below their size): back to x's placement before the view
            y2d = y2d.redistribute(x2d.device_mesh, x2d.placements)
    else:
        mesh = None
        if shardctx.is_dtensor(x2d):
            # no expert parallelism: every rank routes every token
            # through every expert on full values
            mesh = x2d.device_mesh
            x2d = x2d.full_tensor()
            params = {k: v for k, v in params.items()}
            params["router"] = {k: t.full_tensor()
                                for k, t in params["router"].items()}
            params["experts"] = {k: w.full_tensor() for k, w in
                                 params["experts"].items()}
        gates, aux = _route(params["router"]["w"], x2d, m,
                            params["router"].get("bias"))
        if obs_engine.recording() is not None:
            _note_experts(gates, ctx.valid)
        cap = _capacity(m, x2d.shape[0], ctx.mode)
        e = params["experts"]
        y2d = _moe_local(x2d, gates, e["wi"], e["wg"], e["wo"], cap)
        if mesh is not None:
            # back on the mesh, replicated: their gradients then come back
            # as the plain tensors the full values are
            from torch.distributed.tensor import DTensor, Replicate
            y2d, aux = (DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                           run_check=False)
                        for t in (y2d, aux))
    y = y2d.reshape(B, S, D).to(x.dtype)
    if m.num_shared_experts:
        y = y + apply_mlp(params["shared"], x)
    return y, aux


def _note_experts(gates, valid) -> None:
    """Note on the open span (a recorded batcher step's ``layer.ffn``) the
    experts that took at least one of the layer's tokens and the largest
    expert's token count, counted on the device over the valid tokens
    (``valid`` [B, S] or None: all)."""
    took = gates > 0
    if valid is not None:
        took = took & valid.reshape(-1, 1)
    n = took.sum(0)
    obs_engine.note(experts_hit=(n > 0).sum(), max_expert_tokens=n.max())


def _ffn(params, h, ctx: Ctx):
    """The block's feed-forward on ``h``: the mixture of experts where the
    layer has one (``cfg.is_moe_layer``), else the gated MLP.  Returns
    (out, aux loss)."""
    if "moe" in params:
        return moe_apply(params["moe"], h, ctx)
    return apply_mlp(params["mlp"], h), 0.0


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
    # log sigmoid as -softplus(-x), JAX's ``log_sigmoid``: DTensor has a
    # sharding rule for softplus and its backward, none for log_sigmoid's
    log_a_base = -F.softplus(-params["a_param"])              # [W]
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
        shardctx.assign(cache["h"], h)
        shardctx.assign(cache["conv"], conv)
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
            uf = u.full_tensor() if shardctx.is_dtensor(u) else u
            if shardctx.is_dtensor(idx):
                idx, ok = idx.full_tensor(), ok.full_tensor()
            hist = uf[bidx, idx.clamp(0, S - 1)]
            shardctx.assign(cache["h"], hT)
            shardctx.assign(cache["conv"], torch.where(
                ok, hist, torch.zeros_like(hist)))
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
            if shardctx.is_dtensor(h1):       # the mesh path: full values
                h1, h2 = h1.full_tensor(), h2.full_tensor()
                if shardctx.is_dtensor(last):
                    last = last.full_tensor()
            st, sc = h1[bidx, last], h2[bidx, last]
        else:
            st, sc = h1[:, -1], h2[:, -1]
        shardctx.assign(cache["s"], sT)
        shardctx.assign(cache["shift_t"], st)
        shardctx.assign(cache["shift_c"], sc)
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


def block_init(blk: str, gen: torch.Generator, cfg: cfgs.ModelConfig, dtype,
               layer: int):
    """The params of block ``blk`` as layer ``layer`` of the model."""
    dev = gen.device
    if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN, cfgs.MLA):
        p = {"ln1": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
             "ln2": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
             "attn": (mla_init if blk == cfgs.MLA else attn_init)(gen, cfg,
                                                                  dtype)}
        if cfg.is_moe_layer(layer):
            p["moe"] = moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                cfg.use_bias)
        return p
    if blk == cfgs.RGLRU:
        return {"ln1": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
                "ln2": norm_init(cfg.d_model, dtype, dev, cfg.use_layernorm),
                "rec": rglru_init(gen, cfg, dtype),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                cfg.use_bias)}
    if blk == cfgs.RWKV:
        return {"ln1": norm_init(cfg.d_model, dtype, dev, True),
                "ln2": norm_init(cfg.d_model, dtype, dev, True),
                "rwkv": rwkv_init(gen, cfg, dtype)}
    raise ValueError(f"unknown block {blk!r}")


def block_cache_init(blk: str, cfg: cfgs.ModelConfig, batch: int, smax: int,
                     dtype, device):
    if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN):
        window = cfg.attention_window if blk == cfgs.LOCAL_ATTN else 0
        return attn_cache_init(cfg, batch, smax, window=window, dtype=dtype,
                               device=device)
    if blk == cfgs.MLA:
        return mla_cache_init(cfg, batch, smax, dtype=dtype, device=device)
    if blk == cfgs.RGLRU:
        return rglru_cache_init(cfg, batch, dtype=dtype, device=device)
    if blk == cfgs.RWKV:
        return rwkv_cache_init(cfg, batch, dtype=dtype, device=device)
    raise ValueError(f"unknown block {blk!r}")


def block_apply(blk: str, params, x, ctx: Ctx):
    """One block: (y, new_cache, aux loss), the aux loss 0.0 outside a
    mixture of experts.  With ``parallel_block`` the attention and the
    feed-forward both read ln1(x) and y = x + attn + ffn; ``ln2`` is
    built and carried all the same, as in the JAX package."""
    cfg = ctx.cfg
    if blk in (cfgs.ATTN, cfgs.LOCAL_ATTN):
        window = cfg.attention_window if blk == cfgs.LOCAL_ATTN else 0
        h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
        a_out, new_cache = attn_apply(params["attn"], h1, ctx, window=window)
        if cfg.parallel_block:
            m_out, aux = _ffn(params, h1, ctx)
            return _carry(x + a_out + m_out, ctx), new_cache, aux
    elif blk == cfgs.MLA:
        h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
        a_out, new_cache = mla_apply(params["attn"], h1, ctx)
        x = x + a_out
        h2 = apply_norm(params["ln2"], x, cfg.norm_eps)
        with obs_engine.layer("layer.ffn"):
            m_out, aux = _ffn(params, h2, ctx)
        return x + m_out, new_cache, aux
    elif blk == cfgs.RGLRU:
        h1 = apply_norm(params["ln1"], x, cfg.norm_eps)
        a_out, new_cache = rglru_apply(params["rec"], h1, ctx)
    elif blk == cfgs.RWKV:
        # rwkv_apply does its own norms, residuals and token-shift state
        y, new_cache = rwkv_apply(params, x, ctx)
        return y, new_cache, 0.0
    else:
        raise ValueError(f"unknown block {blk!r}")
    x = _carry(x + a_out, ctx)
    h2 = apply_norm(params["ln2"], x, cfg.norm_eps)
    m_out, aux = _ffn(params, h2, ctx)
    return _carry(x + m_out, ctx), new_cache, aux


def _carry(x, ctx: Ctx):
    """Pin the residual stream as the layer carry is pinned (batch on the
    data axes, replicated over ``model`` unless sequence parallelism puts
    the sequence there): the head- and hidden-sharded projections then
    keep their weights in place and reduce their outputs, the Megatron
    layout XLA picks for the JAX package, where DTensor alone may gather
    the weights instead."""
    return shardctx.constrain(x, "dp", "sp" if ctx.mode == "train" else None,
                              None)
