"""Attention cores: the PyTorch counterpart of ``repro.models.attention``.

Two paths carry the model's attention on the card, each through a
hand-written CUDA kernel:

  * full-sequence passes (train / prefill mode) run
    ``kernels/flash_attention`` when the tensors lie on a CUDA device; on
    the CPU they run the chunked grouped-einsum path of the JAX package;
  * single-token decode steps run ``kernels/decode_attention`` on a CUDA
    device; on the CPU they do so inside ``use_decode_impl("auto")``
    (which the continuous batcher arms) and otherwise take the dense
    grouped einsum, as the JAX package does.

Decode with several new tokens per row (the continuous batcher's chunked
prefill) takes K2's chunked entry on a CUDA device where
:func:`takes_chunked_kernel` says the kernel fits (no window, no M-RoPE,
an RMS qk-norm or none, the GQA group and head dim K2 takes, off the
mesh): one prologue launch applies the qk-norm and RoPE and appends the
new k and v to the cache view, one attention launch takes per-row query
offsets (:func:`chunked_prefill_attention`).  Everything else, and every
CPU tensor, keeps the dense path: ``write_kv`` then ``_attn_block``.

Sliding-window layers (``LOCAL_ATTN``) take the same two kernels: the
full-sequence pass is :func:`causal_attention` with ``window`` (K2 in
window mode on the card; the JAX package's chunked banded
``local_attention`` computes the same function), and a decode step is
K1 over the layer's ring buffer of the last W tokens
(:func:`ring_decode_attention`), whose valid slots are always a prefix.

On the mesh path (``models/shardctx`` armed, DTensor activations) the
pins of the JAX package's ``_attn_block`` hold: q, k and v go to the
attention with their batch over the data axes and replicated over
``model``, and the output comes back head-sharded over ``model``.  XLA
partitions that attention by its output's heads, so a full-sequence pass
here runs K2 on each rank's heads (:func:`_head_parallel`); a decode step
runs K1 on every head.  The kernels run on each rank's rows and heads
(``kernels.local``).  A single-token decode against a cache whose
sequence axis is sharded over ``model`` writes into the owning rank and
runs K1 on each rank's chunk, combined by logsumexp
(:func:`sharded_cache_decode`, ``kernels/decode_attention``); the ring of
a sliding-window layer, sharded so, takes the same path.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import shardctx

NEG_INF = -1e30

# Single-token decode attention implementation on CPU tensors: "dense" is
# the grouped einsum below; "auto" routes through the plain version of
# kernels/decode_attention.  CUDA tensors always launch the kernel, except
# under "reference", which takes the plain version on any device (for
# comparisons on the card).  The continuous batcher arms it around its
# decode step.
_DECODE_IMPL = "dense"
# Full-sequence passes on CUDA: "auto" launches kernels/flash_attention,
# "reference" takes its plain version (for comparisons on the card).
_FLASH_IMPL = "auto"


@contextlib.contextmanager
def use_decode_impl(impl: str):
    """Route single-token :func:`decode_attention` calls made inside this
    context through ``kernels/decode_attention`` (``impl`` in {"dense",
    "auto", "reference"})."""
    global _DECODE_IMPL
    if impl not in ("dense", "auto", "reference"):
        raise ValueError(f"unknown decode impl {impl!r}")
    prev, _DECODE_IMPL = _DECODE_IMPL, impl
    try:
        yield
    finally:
        _DECODE_IMPL = prev


@contextlib.contextmanager
def use_flash_impl(impl: str):
    """Run full-sequence attention on CUDA tensors inside this context with
    ``impl`` ("auto": the kernel; "reference": its plain version)."""
    global _FLASH_IMPL
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown flash impl {impl!r}")
    prev, _FLASH_IMPL = _FLASH_IMPL, impl
    try:
        yield
    finally:
        _FLASH_IMPL = prev


def _attn_block(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0,
                kv_valid=None):
    """One dense attention block.

    q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd]; q_pos: [Sq] or [B,Sq];
    kv_pos: [Skv] or [B,Skv]; kv_valid: optional bool [B,Skv].
    Returns [B,Sq,H,hd].
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    # pin the batch sharding through the GQA head split
    qg = shardctx.constrain(qg, "dp", None, None, None, None)
    k = shardctx.constrain(k, "dp", None, None, None)
    v = shardctx.constrain(v, "dp", None, None, None)
    logits = torch.einsum("bqcgd,bscd->bcgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]            # [B?,Sq]
    kp = kv_pos if kv_pos.dim() == 2 else kv_pos[None]         # [B?,Skv]
    mask = None
    if causal:
        mask = kp[:, None, :] <= qp[:, :, None]
    if window:
        w = kp[:, None, :] > qp[:, :, None] - window
        mask = w if mask is None else mask & w
    if kv_valid is not None:
        vv = kv_valid[:, None, :]
        mask = vv if mask is None else mask & vv
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcgqs,bscd->bqcgd", p.to(v.dtype).float(), v.float())
    out = out.to(q.dtype).reshape(B, Sq, H, hd)
    return shardctx.constrain(out, "dp", None, "tp", None)


def _pinned(q, k, v):
    """q, k, v with their batch over the data axes and replicated over
    ``model`` (the JAX package's pins around the GQA head split)."""
    return (shardctx.constrain(q, "dp", None, None, None),
            shardctx.constrain(k, "dp", None, None, None),
            shardctx.constrain(v, "dp", None, None, None))


def _head_parallel(q, k, v):
    """q, k, v for attention parallel over heads on ``model``, as XLA
    partitions the JAX package's pinned attention by its head-sharded
    output: q's heads sharded over ``model``, and k, v gathered so that
    each rank's slice holds the kv heads its q heads read (their GQA
    groups in order; a kv head repeats where ranks split its group: an
    expand, whose backward is a sum, where a gather's backward would need
    ``index_add``, which DTensor lacks in some torch versions).
    Where the heads do not divide ``model``, or a rank's share would cut
    groups unevenly, the pins of ``_pinned`` (every head on every rank)."""
    tp = shardctx.tp_size()
    H, KV = q.shape[2], k.shape[2]
    G, Hl = H // KV, H // tp
    if tp == 1 or H % tp or not (Hl % G == 0 or G % Hl == 0):
        return _pinned(q, k, v)
    if Hl < G:                  # G / Hl ranks share each kv head: repeat it
        B, Skv, _, hd = k.shape
        R = G // Hl
        k, v = (t.unsqueeze(3).expand(B, Skv, KV, R, hd).reshape(
            B, Skv, KV * R, hd) for t in (k, v))
    return tuple(shardctx.constrain(t, "dp", None, "tp", None)
                 for t in (q, k, v))


def causal_attention(q, k, v, *, window: int = 0, chunk: int = 1024,
                     causal: bool = True):
    """Attention over full sequences.

    q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd]; q[i] sits at kv position
    i + Skv - Sq.  On CUDA this is one launch of the flash attention
    kernel; on the CPU it runs dense blocks of ``chunk`` query rows.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    if shardctx.is_dtensor(q):          # the kernel (plain on CPU) a rank
        out = flash_ops.flash_attention(*_head_parallel(q, k, v),
                                        causal=causal, window=window,
                                        impl=_FLASH_IMPL)
        return shardctx.constrain(out, "dp", None, "tp", None)
    if q.is_cuda:
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, impl=_FLASH_IMPL)
    kv_pos = torch.arange(Skv, dtype=torch.int32, device=q.device)
    outs = []
    for c0 in range(0, Sq, chunk):
        qc = q[:, c0:c0 + chunk]
        q_pos = torch.arange(c0, c0 + qc.shape[1], dtype=torch.int32,
                             device=q.device) + (Skv - Sq)
        outs.append(_attn_block(qc, k, v, q_pos, kv_pos, causal=causal,
                                window=window))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, lengths):
    """Decode-step attention against a full KV cache.

    q: [B,T,H,hd] (T new tokens, already at positions lengths-T ..
    lengths-1); k_cache,v_cache: [B,Smax,KV,hd] with the new tokens already
    written; lengths: [B], valid tokens *including* the new ones.
    """
    B, T, H, hd = q.shape
    if T == 1 and (q.is_cuda or _DECODE_IMPL != "dense"
                   or shardctx.is_dtensor(q)):
        impl = "reference" if _DECODE_IMPL == "reference" else "auto"
        q, k_cache, v_cache = _pinned(q, k_cache, v_cache)
        return dec_ops.flash_decode(q, k_cache, v_cache, lengths, impl=impl)
    Smax = k_cache.shape[1]
    kv_pos = torch.arange(Smax, dtype=torch.int32, device=q.device)[None]
    q_pos = ((lengths[:, None] - T)
             + torch.arange(T, dtype=torch.int32, device=q.device)[None])
    valid = kv_pos < lengths[:, None]                          # [B,Smax]
    return _attn_block(q, k_cache, v_cache, q_pos, kv_pos.expand(B, Smax),
                       causal=True, kv_valid=valid)


def chunked_prefill_fits(cfg, params, T: int, window: int, dtype) -> bool:
    """The shapes K2's chunked entry takes, read off the layer: several
    new tokens a row, no window, no M-RoPE, a qk-norm that is an RMSNorm
    (no bias) or none, and heads the kernel fits
    (``flash_attention.chunked_fits``)."""
    norm = params.get("q_norm")
    return (T > 1 and not window and not cfg.mrope_sections
            and (norm is None or "bias" not in norm)
            and flash_ops.chunked_fits(cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim, dtype))


def takes_chunked_kernel(x, cfg, params, window: int) -> bool:
    """Whether a decode call of the attention layer ``params`` on its
    input x [B, T, D] runs K2's chunked entry: on a CUDA device, off the
    mesh, where :func:`chunked_prefill_fits`."""
    return (x.device.type == "cuda" and not shardctx.enabled()
            and not shardctx.is_dtensor(x)
            and chunked_prefill_fits(cfg, params, x.shape[1], window,
                                     x.dtype))


def chunked_prefill_attention(q, k, v, cache_k, cache_v, lengths, *,
                              q_norm=None, k_norm=None, eps: float = 1e-6,
                              rope=None):
    """A chunked-prefill step of one layer through K2's chunked entry:
    q [B,T,H,hd], k, v [B,T,KV,hd] the projections before qk-norm and
    RoPE, rope the (cos, sin) tables of the step's positions or None.
    Writes the new k, v into the caches in place (positions past their
    end dropped).  Returns the attention [B,T,H,hd] and whether the
    kernels ran (not under ``use_flash_impl("reference")``)."""
    cos, sin = rope if rope is not None else (None, None)
    out = flash_ops.chunked_attention(
        q, k, v, cache_k, cache_v, lengths, q_norm=q_norm, k_norm=k_norm,
        eps=eps, cos=cos, sin=sin, impl=_FLASH_IMPL)
    return out, _FLASH_IMPL == "auto"


def ring_decode_attention(q, k_ring, v_ring, pos, window: int):
    """Sliding-window decode against a ring buffer of the last W tokens.

    q: [B,1,H,hd]; k_ring,v_ring: [B,W,KV,hd]; pos: [B] absolute position
    of the new token (already written to slot pos % W).  The valid slots
    of the ring are always its first min(pos+1, W): slot j holds the
    largest position <= pos congruent to j (mod W), which is negative, and
    invalid, exactly for j > pos.  Softmax ignores order, so on a CUDA
    device (or on the CPU under ``use_decode_impl("auto")``) this is
    flash-decode over the ring with lengths min(pos+1, W); on the CPU
    otherwise the dense masked block of the JAX package.
    """
    B, T, H, hd = q.shape
    if T != 1:
        raise ValueError("ring decode is single-token")
    W = window
    if shardctx.is_dtensor(q):
        impl = "reference" if _DECODE_IMPL == "reference" else "auto"
        lengths = torch.clamp(pos + 1, max=W).to(torch.int32)
        if seq_sharded_decode_ready(k_ring):
            mesh, _, tp = shardctx.mesh_info()
            return dec_ops.flash_decode_sharded(
                q, k_ring, v_ring, lengths, mesh=mesh, seq_axis=tp,
                dp_axes=shardctx.dp_for(B), impl=impl)
        q, k_ring, v_ring = _pinned(q, k_ring, v_ring)
        return dec_ops.flash_decode(q, k_ring, v_ring, lengths, impl=impl)
    if q.is_cuda or _DECODE_IMPL != "dense":
        impl = "reference" if _DECODE_IMPL == "reference" else "auto"
        lengths = torch.clamp(pos + 1, max=W).to(torch.int32)
        return dec_ops.flash_decode(q, k_ring, v_ring, lengths, impl=impl)
    j = torch.arange(W, dtype=torch.int32, device=q.device)[None]   # [1,W]
    p = pos.to(torch.int32)[:, None]                                  # [B,1]
    slot_pos = p - torch.remainder(p - j, W)                          # [B,W]
    return _attn_block(q, k_ring, v_ring, p, slot_pos, causal=True,
                       window=W, kv_valid=slot_pos >= 0)


def seq_sharded_decode_ready(cache_k) -> bool:
    """True when the shard context is armed and ``cache_k`` [B,S,KV,hd]
    is a DTensor whose sequence axis is sharded over ``model`` (batch over
    the data axes where they divide it): the sharded decode path
    applies.  The path writes the cache in place, so a cache placed
    otherwise is not resharded for it."""
    if not shardctx.enabled() or not shardctx.is_dtensor(cache_k):
        return False
    from repro_torch.launch.sharding import placements
    mesh, _, tp = shardctx.mesh_info()
    if cache_k.shape[1] % shardctx.tp_size():
        return False
    dp = shardctx.dp_for(cache_k.shape[0]) or None
    return tuple(cache_k.placements) == placements(
        cache_k.device_mesh, (dp, tp, None, None))


def sharded_cache_decode(q, cache_k, cache_v, k_new, v_new, lengths,
                         impl: str = "auto"):
    """Decode against a sequence-sharded KV cache: shard-local write +
    flash-decode with the partials combined by logsumexp (see
    ``kernels/decode_attention``).  Returns (out, cache_k, cache_v)."""
    mesh, _, tp = shardctx.mesh_info()
    dp = shardctx.dp_for(q.shape[0])
    start = lengths - 1
    ck, cv = dec_ops.write_kv_sharded(cache_k, cache_v, k_new, v_new, start,
                                      mesh=mesh, seq_axis=tp, dp_axes=dp)
    if impl == "auto" and _DECODE_IMPL == "reference":
        impl = "reference"
    out = dec_ops.flash_decode_sharded(q, ck, cv, lengths, mesh=mesh,
                                       seq_axis=tp, dp_axes=dp, impl=impl)
    return out, ck, cv


def write_kv_ring(cache_k, cache_v, k_new, v_new, pos, window: int):
    """Write single-token k/v [B,1,KV,hd] at ring slot pos % window, in
    place, and return the rings (on a ring sharded over ``model``, into
    the rank that holds the slot)."""
    B = k_new.shape[0]
    if seq_sharded_decode_ready(cache_k):
        mesh, _, tp = shardctx.mesh_info()
        return dec_ops.write_kv_sharded(
            cache_k, cache_v, k_new, v_new, torch.remainder(pos, window),
            mesh=mesh, seq_axis=tp, dp_axes=shardctx.dp_for(B))
    slot = torch.remainder(pos.long(), window)
    bidx = torch.arange(B, device=pos.device)
    cache_k[bidx, slot] = k_new[:, 0]
    cache_v[bidx, slot] = v_new[:, 0]
    return cache_k, cache_v


def fill_ring(ring_k, ring_v, k, v, lengths, window: int):
    """Prefill's ring: the last W *valid* tokens of k, v [B,S,KV,hd]; slot
    j holds the largest valid position congruent to j (mod W), zeros
    where there is none.  Written into the rings [B,W,KV,hd] in place (a
    gather, so padding never races a scatter)."""
    if shardctx.is_dtensor(k):               # the mesh path: full values
        k, v = k.full_tensor(), v.full_tensor()
        if shardctx.is_dtensor(lengths):
            lengths = lengths.full_tensor()
    B, S = k.shape[:2]
    W = window
    q_last = (lengths.to(torch.int64) - 1)[:, None]                  # [B,1]
    j = torch.arange(W, device=k.device)[None]                        # [1,W]
    src = q_last - torch.remainder(q_last - j, W)                     # [B,W]
    ok = (src >= 0)[..., None, None]
    srcc = src.clamp(0, S - 1)
    bidx = torch.arange(B, device=k.device)[:, None]
    zeros = torch.zeros(k.shape[:1] + (W,) + k.shape[2:], dtype=k.dtype,
                        device=k.device)
    shardctx.assign(ring_k, torch.where(ok, k[bidx, srcc], zeros))
    shardctx.assign(ring_v, torch.where(ok, v[bidx, srcc], zeros))
    return ring_k, ring_v


def write_kv(cache_k, cache_v, k_new, v_new, start):
    """Write k_new/v_new [B,T,KV,hd] into the caches [B,Smax,KV,hd] at
    per-row offsets start [B].  Updates the caches in place (the JAX
    version returned new arrays) and returns them.

    A multi-token write drops the positions past the cache's end, as the
    JAX scatter does (chunked prefill runs decode rows whose chunk would
    overrun the bucketed width).  A single-token write must lie inside.
    """
    B, T = k_new.shape[:2]
    idx = (start.long()[:, None]
           + torch.arange(T, device=start.device)[None])         # [B,T]
    bidx = torch.arange(B, device=start.device)[:, None].expand(B, T)
    if T == 1:
        cache_k[bidx, idx] = k_new
        cache_v[bidx, idx] = v_new
        return cache_k, cache_v
    keep = idx < cache_k.shape[1]
    cache_k[bidx[keep], idx[keep]] = k_new[keep]
    cache_v[bidx[keep], idx[keep]] = v_new[keep]
    return cache_k, cache_v
