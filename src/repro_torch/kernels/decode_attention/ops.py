"""Flash-decode wrappers in the model layout, and the paged gather.

``flash_decode`` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel in ``csrc/decode_attention.cu``, or raises if it cannot be built or
launched.  ``impl="reference"`` runs the plain version on any device; only
comparisons of the kernel against it pass that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_with_lse_ref)

LIB = build.CudaLibrary("decode_attention.cu", {
    "repro_decode_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p],
})
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0


def decode_attention_cuda(q, k_cache, v_cache, lengths, *,
                          return_lse: bool = False):
    """Launch the kernel.  q: [B,1,H,hd]; k_cache,v_cache: [B,Smax,KV,hd]
    (model layout, read through strides); lengths: int32 [B].
    Returns out [B,1,H,hd] (and lse [B,H,1] fp32)."""
    global LAUNCHES
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"decode attention takes bf16 or fp32, not {q.dtype}")
    if hd not in HEAD_DIMS or H % KV or H // KV not in GROUPS:
        raise ValueError(f"decode attention kernel takes hd in {HEAD_DIMS} "
                         f"and H/KV in {GROUPS}; got hd={hd}, H={H}, KV={KV}")
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        build.check_operand(name, t, q.dtype)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], out.stride(0), out.stride(2))
    err = LIB.load().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        build.DTYPE_CODE[q.dtype], B, H, KV, Smax, hd, strides, hd ** -0.5,
        build.stream_ptr(q.device))
    build.check(err, "decode_attention")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_decode(q, k_cache, v_cache, lengths, *, impl: str = "auto",
                 return_lse: bool = False):
    """q: [B,1,H,hd]; k_cache,v_cache: [B,Smax,KV,hd]; lengths: [B].
    Returns [B,1,H,hd] (and the per-head logsumexp [B,H,1] fp32 when
    ``return_lse``).  impl: "auto" (the kernel on CUDA, the plain version
    on CPU) or "reference" (the plain version)."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto" and q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, lengths,
                                     return_lse=return_lse)
    kc = k_cache.transpose(1, 2)                   # [B,KV,Smax,hd]
    vc = v_cache.transpose(1, 2)
    if return_lse:
        out, lse = decode_attention_with_lse_ref(q[:, 0], kc, vc, lengths)
        return out[:, None], lse
    return decode_attention_ref(q[:, 0], kc, vc, lengths)[:, None]


def gather_kv_blocks(pool, tables):
    """Dense cache view of a paged KV pool.

    pool: [NB, bs, ...] fixed-size blocks; tables: int [B, nb] per-sequence
    block tables.  Returns [B, nb*bs, ...]: sequence ``b``'s tokens
    contiguous at positions ``0..len_b-1`` (table order).
    """
    B, nb = tables.shape
    g = pool.index_select(0, tables.reshape(-1).long())
    return g.reshape((B, nb * pool.shape[1]) + tuple(pool.shape[2:]))


def flash_decode_paged(q, k_pool, v_pool, tables, lengths, *,
                       impl: str = "auto"):
    """Flash-decode against paged KV pools via a block-table gather.

    q: [B,1,H,hd]; k_pool,v_pool: [NB,bs,KV,hd]; tables: int [B,nb];
    lengths: [B].  Returns [B,1,H,hd], equal to ``flash_decode`` over the
    equivalent dense [B, nb*bs] cache.
    """
    kc = gather_kv_blocks(k_pool, tables)
    vc = gather_kv_blocks(v_pool, tables)
    return flash_decode(q, kc, vc, lengths, impl=impl)
