"""Plain PyTorch version of the flash-decode kernel (the oracle)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _group_logits(q, k_cache):
    B, H, hd = q.shape
    KV = k_cache.shape[1]
    qg = q.reshape(B, KV, H // KV, hd).float()
    return torch.einsum("bcgd,bcsd->bcgs", qg, k_cache.float()) / math.sqrt(hd)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: [B,H,hd] (single new token, already at position lengths-1);
    k_cache,v_cache: [B,KV,Smax,hd]; lengths: [B] valid tokens.
    Returns [B,H,hd] in q's dtype."""
    B, H, hd = q.shape
    Smax = k_cache.shape[2]
    logits = _group_logits(q, k_cache)                          # [B,KV,G,S]
    valid = (torch.arange(Smax, device=q.device)[None]
             < lengths[:, None])                                # [B,Smax]
    logits = torch.where(valid[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcgs,bcsd->bcgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_with_lse_ref(q, k_cache, v_cache, lengths):
    """Like :func:`decode_attention_ref` but also returns the logsumexp over
    the valid keys: (out [B,H,hd], lse [B,H,1] fp32; -inf for no key)."""
    B, H, hd = q.shape
    Smax = k_cache.shape[2]
    logits = _group_logits(q, k_cache)
    valid = (torch.arange(Smax, device=q.device)[None]
             < lengths[:, None])
    logits = torch.where(valid[:, None, None], logits,
                         torch.full_like(logits, -math.inf))
    m = logits.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m_safe)
    e = torch.where(torch.isfinite(logits), e, torch.zeros_like(e))
    l = e.sum(-1, keepdim=True)
    out = torch.einsum("bcgs,bcsd->bcgd", e.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / l.clamp_min(1e-30)
    lse = m_safe + torch.log(l.clamp_min(1e-30))
    lse = torch.where(l > 0, lse, torch.full_like(lse, -math.inf))
    return (out.reshape(B, H, hd).to(q.dtype),
            lse.reshape(B, H, 1).float())
