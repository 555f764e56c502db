"""Plain PyTorch version of the RG-LRU scan kernel (the oracle), and of
its gradient."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t, one time step after the other, in fp32
    (in fp64 for fp64 inputs, as the gradient checks give).

    a,b: [B,S,W]; h0: [B,W].  Returns (hs [B,S,W] fp32, hT [B,W] fp32).
    """
    wide = torch.promote_types(a.dtype, torch.float32)
    af, bf = a.to(wide), b.to(wide)
    h = h0.to(wide)
    hs = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) if hs else af.new_zeros(af.shape)), h


def rglru_scan_bwd_ref(a, hs, h0, d_hs, d_hT, *, b_dtype=None):
    """The gradient of :func:`rglru_scan_ref` as the same recurrence run
    backwards in time, from its inputs a, h0, its output hs and the
    gradients d_hs [B,S,W], d_hT [B,W] of its outputs:

        g_{S-1} = d_hT + d_hs_{S-1},   g_t = a_{t+1} * g_{t+1} + d_hs_t,
        db_t = g_t,   da_t = g_t * h_{t-1}  (h_{-1} = h0),   dh0 = a_0 * g_0.

    Each is one product and one sum of two terms, as autograd of
    ``rglru_scan_ref`` computes them, so the bits are autograd's.  Returns
    (da in a's dtype, db in ``b_dtype`` (a's by default), dh0 in h0's),
    each rounded from the wide type as a cast's backward rounds it."""
    wide = torch.promote_types(a.dtype, torch.float32)
    af, hsf = a.to(wide), hs.to(wide)
    dh = d_hs.to(wide)
    S = af.shape[1]
    da, db = torch.empty_like(af), torch.empty_like(af)
    g = d_hT.to(wide)
    for t in reversed(range(S)):
        g = (g if t == S - 1 else af[:, t + 1] * g) + dh[:, t]
        db[:, t] = g
        da[:, t] = g * (hsf[:, t - 1] if t else h0.to(wide))
    dh0 = af[:, 0] * g if S else g
    return (da.to(a.dtype), db.to(b_dtype or a.dtype), dh0.to(h0.dtype))
