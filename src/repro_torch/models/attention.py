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

Decode with several new tokens per row (chunked prefill) keeps the dense
``_attn_block``: its per-row query offsets do not fit the flash kernel's
single offset.

Sliding-window layers (``LOCAL_ATTN``) take the same two kernels: the
full-sequence pass is :func:`causal_attention` with ``window`` (K2 in
window mode on the card; the JAX package's chunked banded
``local_attention`` computes the same function), and a decode step is
K1 over the layer's ring buffer of the last W tokens
(:func:`ring_decode_attention`), whose valid slots are always a prefix.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

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
    return out.to(q.dtype).reshape(B, Sq, H, hd)


def causal_attention(q, k, v, *, window: int = 0, chunk: int = 1024,
                     causal: bool = True):
    """Attention over full sequences.

    q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd]; q[i] sits at kv position
    i + Skv - Sq.  On CUDA this is one launch of the flash attention
    kernel; on the CPU it runs dense blocks of ``chunk`` query rows.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
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
    if T == 1 and (q.is_cuda or _DECODE_IMPL != "dense"):
        impl = "reference" if _DECODE_IMPL == "reference" else "auto"
        return dec_ops.flash_decode(q, k_cache, v_cache, lengths, impl=impl)
    Smax = k_cache.shape[1]
    kv_pos = torch.arange(Smax, dtype=torch.int32, device=q.device)[None]
    q_pos = ((lengths[:, None] - T)
             + torch.arange(T, dtype=torch.int32, device=q.device)[None])
    valid = kv_pos < lengths[:, None]                          # [B,Smax]
    return _attn_block(q, k_cache, v_cache, q_pos, kv_pos.expand(B, Smax),
                       causal=True, kv_valid=valid)


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
    if q.is_cuda or _DECODE_IMPL != "dense":
        impl = "reference" if _DECODE_IMPL == "reference" else "auto"
        lengths = torch.clamp(pos + 1, max=W).to(torch.int32)
        return dec_ops.flash_decode(q, k_ring, v_ring, lengths, impl=impl)
    j = torch.arange(W, dtype=torch.int32, device=q.device)[None]   # [1,W]
    p = pos.to(torch.int32)[:, None]                                  # [B,1]
    slot_pos = p - torch.remainder(p - j, W)                          # [B,W]
    return _attn_block(q, k_ring, v_ring, p, slot_pos, causal=True,
                       window=W, kv_valid=slot_pos >= 0)


def write_kv_ring(cache_k, cache_v, k_new, v_new, pos, window: int):
    """Write single-token k/v [B,1,KV,hd] at ring slot pos % window, in
    place, and return the rings."""
    B = k_new.shape[0]
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
    B, S = k.shape[:2]
    W = window
    q_last = (lengths.to(torch.int64) - 1)[:, None]                  # [B,1]
    j = torch.arange(W, device=k.device)[None]                        # [1,W]
    src = q_last - torch.remainder(q_last - j, W)                     # [B,W]
    ok = (src >= 0)[..., None, None]
    srcc = src.clamp(0, S - 1)
    bidx = torch.arange(B, device=k.device)[:, None]
    ring_k.copy_(torch.where(ok, k[bidx, srcc], torch.zeros_like(ring_k)))
    ring_v.copy_(torch.where(ok, v[bidx, srcc], torch.zeros_like(ring_v)))
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
