"""Plain PyTorch version of the flash attention kernel (the oracle)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        sm_scale: Optional[float] = None):
    """q: [B,H,Sq,hd]; k,v: [B,KV,Skv,hd] -> [B,H,Sq,hd].

    GQA: q head h uses kv head h // (H // KV).  q position i sits at kv
    position i + Skv - Sq.  Optional sliding window.
    """
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, Sq, hd).float()
    logits = torch.einsum("bcgqd,bckd->bcgqk", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcgqk,bckd->bcgqd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)
