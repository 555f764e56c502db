"""Flash attention wrapper in the model layout [B, S, heads, hd].

``flash_attention`` dispatches on the tensor's device: a CPU tensor takes
the plain PyTorch version (``ref.py``); a CUDA tensor launches the
hand-written kernel in ``csrc/flash_attention.cu``, or raises if it cannot
be built or launched.  ``impl="reference"`` runs the plain version on any
device; only comparisons of the kernel against it pass that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LIB = build.CudaLibrary("flash_attention.cu", {
    "repro_flash_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
})
HEAD_DIMS = (64, 128)

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel.  q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] (read
    through strides) -> [B,Sq,H,hd]."""
    global LAUNCHES
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"flash attention takes bf16 or fp32, not {q.dtype}")
    if hd not in HEAD_DIMS or H % KV:
        raise ValueError(f"flash attention kernel takes hd in {HEAD_DIMS} "
                         f"and H divisible by KV; got hd={hd}, H={H}, KV={KV}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Sq == 0 or Skv == 0:
        raise ValueError("flash attention needs Sq > 0 and Skv > 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        build.check_operand(name, t, q.dtype)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = LIB.load().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODE[q.dtype], B, H, KV, Sq, Skv, hd, strides,
        int(causal), int(window), hd ** -0.5, build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    LAUNCHES += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd].

    q position i sits at kv position i + Skv - Sq.  impl: "auto" (the
    kernel on CUDA, the plain version on CPU) or "reference" (the plain
    version).
    """
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto" and q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)
