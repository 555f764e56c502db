"""The arithmetic of the Hopper forms of K1 (decode attention) and K5
(RWKV-6 scan), held to the JAX package on the CPU, where the card cannot
be reached.

Each test runs a plain PyTorch emulation of what the CUDA kernel computes,
in its decomposition and order of reduction but not on any serving path
(K5's products of phases 4-5 in fp32, where the kernel runs them in
3xTF32):

* K5, ``csrc/rwkv6_scan.cu``'s chunked path: chunks of C = 32 steps cut
  into sub-chunks of CS = 8, every decay factor a product of w over a
  range inside one sub-chunk (a prefix from its start, a suffix to its
  end, a whole sub-chunk, or the span between two steps of one
  sub-chunk), so each factor is at most 1 and none is a quotient; a key
  of an earlier sub-chunk is decayed to the start of the query's;
* K1, ``csrc/decode_attention.cu``: the cache split over the blocks of a
  cluster as the entry point splits it, each block's 4 warps taking 16
  keys of every 64-key tile with their own online softmax (in log2 units),
  the warps' partials merged in warp order and the blocks' in split order
  by logsumexp, with the TPU kernel's finalisation.

Both are fed seeded numpy inputs and compared with the JAX ``ref.py`` and
with the Pallas kernels in interpret mode.  Tolerances: K5 2e-4 of the
largest reference value (``chip_smoke.py``'s gate), K1 1e-5 in fp32.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import \
    decode_attention_kernel  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_with_lse_ref as j_dec_lse_ref  # noqa: E402
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel  # noqa: E402
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_rwkv_ref  # noqa

NEG_INF = -1e30


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(x, ref, tol=2e-4):
    x, ref = _np(x), _np(ref)
    assert np.isfinite(x).all()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(x - ref).max()) <= tol * scale


# ---------------------------------------------------------------------------
# K5: the chunked form
# ---------------------------------------------------------------------------

C, CS = 32, 8
NSUB = C // CS


def rwkv6_chunked(r, k, v, w, u, s0):
    """K5's chunked path.  r,k,v,w: [B,S,H,hd]; u: [H,hd]; s0:
    [B,H,hd,hd] -> (o [B,S,H,hd], sT [B,H,hd,hd]), fp32."""
    B, S, H, hd = r.shape
    pad = (-S) % C

    def bhsd(x, fill):          # [B,H,S+pad,hd], past the end: identity
        x = x.float().transpose(1, 2)
        return torch.cat([x, x.new_full((B, H, pad, hd), fill)], 2)

    r, k, v, w = bhsd(r, 0.0), bhsd(k, 0.0), bhsd(v, 0.0), bhsd(w, 1.0)
    u = u.float()[None]                                    # [1,H,hd]
    state = s0.float().clone()
    outs = []
    for c0 in range(0, S + pad, C):
        rc, kc, vc, wc = (x[:, :, c0:c0 + C] for x in (r, k, v, w))
        # phase 2: per (sub-chunk, channel) running products of w
        pre = torch.empty_like(wc)      # prod of w from the sub-chunk's start
        suf = torch.empty_like(wc)      # prod of w to the sub-chunk's end
        W = []                          # each sub-chunk's whole decay
        for a in range(NSUB):
            f = torch.ones_like(wc[:, :, 0])
            for q in range(CS):
                pre[:, :, a * CS + q] = f
                f = f * wc[:, :, a * CS + q]
            W.append(f)
            f = torch.ones_like(wc[:, :, 0])
            for q in reversed(range(CS)):
                suf[:, :, a * CS + q] = f
                f = f * wc[:, :, a * CS + q]
        rp, ks = rc * pre, kc * suf
        # phase 3: A[t][s] for s <= t
        A = torch.zeros((B, H, C, C))
        for t in range(C):
            for s in range(t + 1):
                at, as_ = t // CS, s // CS
                if s == t:
                    L, R, F = rc[:, :, t], kc[:, :, t], u
                elif as_ == at:
                    F = torch.ones_like(wc[:, :, 0])
                    for tau in range(s + 1, t):
                        F = F * wc[:, :, tau]
                    L, R = rc[:, :, t], kc[:, :, s]
                else:           # key s decayed to the start of sub-chunk at
                    F = torch.ones_like(wc[:, :, 0])
                    for m in range(as_ + 1, at):
                        F = F * W[m]
                    L, R, F = rp[:, :, t], ks[:, :, s] * F, 1.0
                A[:, :, t, s] = (L * R * F).sum(-1)
        qa = torch.stack([math.prod(W[:a], start=torch.ones_like(W[0]))
                          for a in range(NSUB)], 2)       # [B,H,NSUB,hd]
        ra = torch.stack([math.prod(W[a + 1:], start=torch.ones_like(W[0]))
                          for a in range(NSUB)], 2)
        rq = rp * qa.repeat_interleave(CS, 2)
        kq = ks * ra.repeat_interleave(CS, 2)
        # phase 4: outputs; phase 5: the state
        outs.append(rq @ state + A @ vc)
        qend = math.prod(W, start=torch.ones_like(W[0]))
        state = qend[..., :, None] * state + kq.transpose(-1, -2) @ vc
    o = torch.cat(outs, 2)[:, :, :S].transpose(1, 2)
    return o, state


def _rwkv_inputs(seed, B, S, H, hd, *, underflow=False):
    """Seeded numpy inputs; decays w = exp(-exp(x)) as the served model
    makes them, x up to 5 with ``underflow`` (so that some w are 0)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    x = rng.standard_normal((B, S, H, hd))
    if underflow:
        x = np.clip(x * 2.0 + 1.0, -6.0, 5.0)
    else:
        x = x - 2.0
    w = np.exp(-np.exp(x)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return [r, k, v, w, u, s0]


def _check_rwkv(arrs):
    o, sT = rwkv6_chunked(*(torch.from_numpy(a) for a in arrs))
    j_in = [jnp.asarray(a) for a in arrs]
    j_o, j_sT = j_rwkv_ref(*j_in)
    _close_rel(o, j_o)
    _close_rel(sT, j_sT)
    p_o, p_sT = rwkv6_scan_kernel(*j_in, block_t=8, interpret=True)
    _close_rel(o, p_o)
    _close_rel(sT, p_sT)
    return o, sT


@pytest.mark.parametrize("B,S,H,hd,underflow", [
    (2, 64, 2, 16, False),     # two whole chunks
    (1, 45, 2, 16, False),     # S not a multiple of C
    (2, 1, 2, 16, False),      # S = 1: one step in a padded chunk
    (2, 77, 2, 16, True),      # decays that underflow to 0
    (1, 40, 1, 64, True)])     # the served head size
def test_rwkv6_chunked_matches_jax(B, S, H, hd, underflow):
    arrs = _rwkv_inputs(B * S + H + hd, B, S, H, hd, underflow=underflow)
    if underflow:
        assert (arrs[3] == 0).any()
    _check_rwkv(arrs)


def test_rwkv6_chunked_pad_steps_keep_the_state():
    """Pad steps (w = 1, k = 0) after a row's last token leave its state
    as it was, inside a chunk and across a chunk boundary."""
    B, S, H, hd = 2, 50, 2, 16
    arrs = _rwkv_inputs(7, B, S, H, hd, underflow=True)
    r, k, v, w, u, s0 = arrs
    k[1, 20:] = 0.0
    w[1, 20:] = 1.0
    _, sT = _check_rwkv(arrs)
    _, s20 = rwkv6_chunked(*(torch.from_numpy(a) for a in
                             (r[:, :20], k[:, :20], v[:, :20], w[:, :20],
                              u, s0)))
    _close_rel(sT[1], s20[1])


def test_rwkv6_chunked_state_chaining():
    """Two calls over the pieces, the second from the first's state, equal
    one call over the whole sequence, the cut inside a chunk."""
    B, S, H, hd = 2, 70, 2, 16
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _rwkv_inputs(9, B, S, H, hd, underflow=True))
    o, sT = rwkv6_chunked(r, k, v, w, u, s0)
    cut = 41
    o1, s1 = rwkv6_chunked(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                           u, s0)
    o2, s2 = rwkv6_chunked(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                           u, s1)
    _close_rel(torch.cat([o1, o2], 1), o)
    _close_rel(s2, sT)
    j_o, j_sT = j_rwkv_ref(*(jnp.asarray(x.numpy())
                             for x in (r, k, v, w, u, s0)))
    _close_rel(o, j_o)
    _close_rel(s2, j_sT)


# ---------------------------------------------------------------------------
# K1: split over a cluster, fixed-order logsumexp combine
# ---------------------------------------------------------------------------

TK, NW, MAX_SPLITS = 64, 4, 8
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def split_count(B, KV, Smax, sms):
    """The entry point's split count (``split_count`` in the source)."""
    tiles = -(-Smax // TK)
    want = -(-sms // (B * KV))
    splits = 1
    while (splits < want and 2 * splits <= MAX_SPLITS
           and 2 * splits <= tiles):
        splits *= 2
    return splits


def _merge(parts):
    """(m, l, acc) partials in order -> (M, L, A): weights 2^(m - M)."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        wgt = torch.exp2(m - M)
        L = L + l * wgt
        A = A + acc * wgt[..., None]
    return M, L, A


def decode_split_combine(q, kc, vc, lengths, sms):
    """K1 in fp32.  q: [B,H,hd]; kc, vc: [B,KV,Smax,hd]; lengths: [B] ->
    (out [B,H,hd], lse [B,H,1])."""
    B, H, hd = q.shape
    KV, Smax = kc.shape[1], kc.shape[2]
    G = H // KV
    splits = split_count(B, KV, Smax, sms)
    chunk = -(-(-(-Smax // TK)) // splits) * TK
    qg = q.float().reshape(B, KV, G, hd)
    scale = hd ** -0.5 * LOG2E
    out = torch.zeros((B, KV, G, hd))
    lse = torch.zeros((B, KV, G))
    for b in range(B):
        length = max(0, min(int(lengths[b]), Smax))
        blocks = []
        for sp in range(splits):
            k0, k1 = sp * chunk, min(sp * chunk + chunk, length)
            warps = []
            for wi in range(NW):
                m = torch.full((KV, G), NEG_INF)
                l = torch.zeros((KV, G))
                acc = torch.zeros((KV, G, hd))
                for t0 in range(k0, k1, TK):
                    keys = range(t0 + 16 * wi, t0 + 16 * wi + 16)
                    ok = torch.tensor([p < k1 for p in keys])
                    idx = torch.tensor([min(p, Smax - 1) for p in keys])
                    s = torch.einsum("cgd,csd->cgs", qg[b],
                                     kc[b][:, idx].float()) * scale
                    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(ok, torch.exp2(s - m_new[..., None]),
                                    torch.zeros_like(s))
                    l = l * alpha + p.sum(-1)
                    acc = (acc * alpha[..., None]
                           + torch.einsum("cgs,csd->cgd", p,
                                          vc[b][:, idx].float()))
                    m = m_new
                warps.append((m, l, acc))
            blocks.append(_merge(warps))
        M, L, A = _merge(blocks)
        out[b] = torch.where(L[..., None] == 0, torch.zeros_like(A),
                             A / torch.where(L == 0, 1.0, L)[..., None])
        lse[b] = torch.where(L == 0, torch.full_like(L, NEG_INF),
                             (M + torch.log2(torch.where(L == 0, 1.0, L)))
                             * LN2)
    return out.reshape(B, H, hd), lse.reshape(B, H, 1)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("G,KV", [(1, 2), (3, 2), (7, 1), (16, 1)])
def test_decode_split_combine_matches_jax(G, KV, sms):
    """G in {1, 3, 7, 16}; lengths 0, 1, not a multiple of a split's keys,
    and Smax; one split (sms = 1) and four (sms = 132, Smax 200)."""
    B, Smax, hd = 4, 200, 32
    H = KV * G
    rng = np.random.default_rng(G * 10 + KV + sms)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32) for s in
                 ((B, H, hd), (B, KV, Smax, hd), (B, KV, Smax, hd)))
    lengths = np.array([0, 1, 150, Smax], np.int32)
    assert split_count(B, KV, Smax, sms) == (1 if sms == 1 else 4)
    out, lse = decode_split_combine(torch.from_numpy(q), torch.from_numpy(kc),
                                    torch.from_numpy(vc),
                                    torch.from_numpy(lengths), sms)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, kc, vc, lengths))
    tol = dict(rtol=1e-5, atol=1e-5)
    j_out, j_lse = j_dec_lse_ref(jq, jk, jv, jl)
    np.testing.assert_allclose(_np(out), _np(j_out), **tol)
    live = lengths > 0             # the JAX ref's lse is -inf at length 0
    np.testing.assert_allclose(_np(lse)[live], _np(j_lse)[live], **tol)
    p_out, p_lse = decode_attention_kernel(jq, jk, jv, jl, block_k=64,
                                           interpret=True, return_lse=True)
    np.testing.assert_allclose(_np(out), _np(p_out), **tol)
    np.testing.assert_allclose(_np(lse), _np(p_lse), **tol)
    assert (_np(lse)[~live] == NEG_INF).all()
    assert (_np(out)[~live] == 0).all()
