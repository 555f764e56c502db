"""Plain PyTorch version of the RWKV-6 wkv scan kernel (the oracle)."""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, w, u, s0):
    """o_t = r_t . (S_{t-1} + (u * k_t) v_t^T);  S_t = diag(w_t) S + k_t v_t^T.

    r,k,v,w: [B,S,H,hd] (w in (0,1), the decay); u: [H,hd]; s0:
    [B,H,hd,hd].  Everything runs in fp32 (in fp64 for fp64 inputs, as
    the gradient checks give), one time step after the other.
    Returns (o [B,S,H,hd] fp32, sT [B,H,hd,hd] fp32).
    """
    wide = torch.promote_types(r.dtype, torch.float32)
    rf, kf, vf, wf = (t.to(wide) for t in (r, k, v, w))
    uf = u.to(wide)
    s = s0.to(wide)
    outs = []
    for t in range(rf.shape[1]):
        r_t, k_t, v_t, w_t = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]           # [B,H,hd,hd]
        s_att = s + uf[None, :, :, None] * kv
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, s_att))
        s = w_t[..., :, None] * s + kv
    o = (torch.stack(outs, dim=1) if outs
         else rf.new_zeros(rf.shape))
    return o, s
