"""Plain PyTorch versions of the flash attention kernel (the oracle): the
full-sequence entry and the chunked-prefill entry."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import apply_norm, rotate

NEG_INF = -1e30


def _wide(t):
    """t in fp32, or in fp64 where it already is (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None,
                        q_offset: Optional[int] = None):
    """q: [B,H,Sq,hd]; k,v: [B,KV,Skv,hd] -> [B,H,Sq,hd].

    GQA: q head h uses kv head h // (H // KV).  q position i sits at kv
    position i + q_offset (default Skv - Sq).  Optional sliding window.
    """
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    off = Skv - Sq if q_offset is None else q_offset
    qg = _wide(q.reshape(B, KV, G, Sq, hd))
    logits = torch.einsum("bcgqd,bckd->bcgqk", qg, _wide(k)) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None] + off
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcgqk,bckd->bcgqd", _wide(p.to(v.dtype)), _wide(v))
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def _norm_rope(x, w, eps: float, cos, sin):
    """The model's qk-norm then RoPE of x [B, T, heads, hd], each rounded
    to x's dtype (``models.common``'s ops): w the RMSNorm scale [hd] or
    None, cos / sin [B, T, hd / 2] fp32 or None."""
    if w is not None:
        x = apply_norm({"scale": w}, x, eps)
    if cos is not None:
        x = rotate(x, cos[:, :, None, :], sin[:, :, None, :])
    return x


def chunked_attention_ref(q, k, v, cache_k, cache_v, lengths, *,
                          q_norm=None, k_norm=None, eps: float = 1e-6,
                          cos=None, sin=None):
    """A chunked-prefill step of one layer: q [B,T,H,hd], k, v [B,T,KV,hd]
    (projections before the qk-norm and RoPE), the dense cache view
    cache_k, cache_v [B,Smax,KV,hd], lengths [B] (tokens valid after the
    step).  Token t of row b sits at position lengths[b] - T + t: its k
    and v are written there in place (positions outside [0, Smax) are
    dropped), and its query sees keys 0 .. that position.  A query that
    sees no key (a position below 0) outputs zeros.  Returns [B,T,H,hd].

    The arithmetic is the model's plain decode path (norm, RoPE, then the
    dense masked block of ``models.attention``): fp32 logits, softmax,
    p rounded to v's dtype, fp32 p v.  The append and the masked block
    restate ``models.attention.write_kv`` and ``decode_attention`` (the
    model layer imports this package, not the other way round);
    ``tests/test_torch_kernels.py``'s bit-for-bit test of the chunked
    route against the plain decode path keeps the two in step."""
    q = _norm_rope(q, q_norm, eps, cos, sin)
    k = _norm_rope(k, k_norm, eps, cos, sin)
    B, T, H, hd = q.shape
    Smax, KV = cache_k.shape[1], cache_k.shape[2]
    dev = q.device
    pos = (lengths.long()[:, None] - T
           + torch.arange(T, device=dev)[None])                  # [B,T]
    keep = (pos >= 0) & (pos < Smax)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    cache_k[bidx[keep], pos[keep]] = k[keep]
    cache_v[bidx[keep], pos[keep]] = v[keep]
    qg = q.reshape(B, T, KV, H // KV, hd)
    logits = torch.einsum("bqcgd,bscd->bcgqs", qg.float(),
                          cache_k.float()) / math.sqrt(hd)
    kv_pos = torch.arange(Smax, device=dev)[None, None]          # [1,1,S]
    mask = (kv_pos <= pos[:, :, None]) & (kv_pos < lengths.long()[:, None,
                                                                 None])
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcgqs,bscd->bqcgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    out = torch.where((pos >= 0)[:, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.to(q.dtype).reshape(B, T, H, hd)
