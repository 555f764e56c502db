"""Plain PyTorch version of batched cosine-similarity top-k (the oracle)."""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize to unit L2 norm in fp32 (zero rows stay zero)."""
    x = x.float()
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def similarity_topk_ref(queries: torch.Tensor, corpus: torch.Tensor,
                        k: int):
    """Exact top-k by cosine similarity.

    queries: [Q, D]; corpus: [N, D] (any float dtype; normalized here).
    Returns ``(vals [Q, k] fp32 descending, idx [Q, k] int32)``.  Ties go
    to the lower corpus index: a stable sort of ``-sims`` keeps equal
    scores in index order (``torch.topk`` promises no tie order, so it is
    not used).  With ``k > N`` the tail is ``-inf`` / ``-1``.
    """
    q = l2_normalize(queries)
    c = l2_normalize(corpus)
    sims = q @ c.T                                    # [Q, N]
    kk = min(k, c.shape[0])
    order = torch.sort(-sims, dim=1, stable=True).indices[:, :kk]
    vals = torch.gather(sims, 1, order)
    idx = order.to(torch.int32)
    if kk < k:
        Q = q.shape[0]
        vals = torch.cat([vals, torch.full((Q, k - kk), float("-inf"),
                                           device=q.device)], dim=1)
        idx = torch.cat([idx, torch.full((Q, k - kk), -1, dtype=torch.int32,
                                         device=q.device)], dim=1)
    return vals, idx


def topk_flips(idx: torch.Tensor, ref_vals: torch.Tensor,
               ref_idx: torch.Tensor):
    """Where ids ``idx`` [Q, k] differ from the reference's, with the
    reference's margin there: the gap from its score at that position to
    the nearest neighbouring score in its order.  Pass the reference with
    one column more than ``idx`` so the k-th position has both
    neighbours.  Returns ``[(row, pos, got, want, margin), ...]``; a flip
    between near-tied rows has a margin near fp32 rounding."""
    k = idx.shape[1]
    rv = ref_vals.double().cpu()
    m = min(k + 1, rv.shape[1])
    step = (rv[:, 1:m] - rv[:, :m - 1]).abs()       # gap to the next row
    gaps = torch.full((rv.shape[0], k), float("inf"), dtype=torch.float64)
    gaps[:, 1:] = step[:, :k - 1]
    gaps[:, :m - 1] = torch.minimum(gaps[:, :m - 1], step[:, :k])
    got, want = idx.cpu(), ref_idx[:, :k].cpu()
    return [(r, p, int(got[r, p]), int(want[r, p]), float(gaps[r, p]))
            for r, p in (got != want).nonzero().tolist()]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest on the
    10 explicit mantissa bits, ties away from zero, the 13 low bits zero.
    Adding half a TF32 unit to the magnitude bits and cutting rounds half
    away from zero in sign-magnitude.  Inf and NaN pass unchanged."""
    x = x.float().contiguous()
    r = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)`` as K3's kernel splits each fp32 operand: ``hi`` is
    ``x`` rounded to TF32 (``tf32_round``), ``lo`` the remainder ``x - hi``
    (exact in fp32) as the tensor core reads it, cut to TF32 (its 13 low
    bits ignored, which truncates toward zero)."""
    hi = tf32_round(x)
    lo = (x.float() - hi).contiguous()
    return hi, (lo.view(torch.int32) & -0x2000).view(torch.float32)


def scores_3xtf32(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[Q, N] scores as K3 computes them on the tensor cores: the three
    TF32 products lo(q) hi(c), hi(q) lo(c), hi(q) hi(c), summed in fp32
    (lo lo is dropped).  Products of two TF32 values are exact in fp32,
    so this differs from the kernel only in summation order.  A model of
    the kernel's arithmetic for the tests; no search path calls it."""
    qh, ql = split_tf32(q)
    ch, cl = split_tf32(c)
    return ql @ ch.T + qh @ cl.T + qh @ ch.T
