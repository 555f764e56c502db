"""Plain PyTorch version of the RG-LRU scan kernel (the oracle)."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t, one time step after the other, in fp32.

    a,b: [B,S,W]; h0: [B,W].  Returns (hs [B,S,W] fp32, hT [B,W] fp32).
    """
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs else af.new_zeros(af.shape)), h
