"""RG-LRU scan (K4): h_t = a_t * h_{t-1} + b_t over a, b [B, S, W].

``rglru_scan`` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref.py``); a CUDA tensor launches the
hand-written kernel in ``csrc/rglru_scan.cu``, or raises if it cannot be
built or launched.  ``impl="reference"`` runs the plain version on any
device; only comparisons of the kernel against it pass that.

The kernel reads a and b in their own type (bf16 or fp32, one type for
both; the served model's are fp32) and the state in fp32: the wrapper
casts h0 to fp32 where it is not.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

LIB = build.CudaLibrary("rglru_scan.cu", {
    "repro_rglru_scan": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p],
})

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0


def rglru_scan_cuda(a, b, h0):
    """Launch the kernel.  a,b: [B,S,W]; h0: [B,W].  Returns
    (hs [B,S,W] fp32, hT [B,W] fp32)."""
    global LAUNCHES
    if a.dim() != 3:
        raise ValueError(f"rglru scan takes a, b [B,S,W]; got a "
                         f"{tuple(a.shape)}")
    B, S, W = a.shape
    if a.dtype not in build.DTYPE_CODE:
        raise TypeError(f"rglru scan takes bf16 or fp32, not {a.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"b: dtype {b.dtype}, a is {a.dtype}")
    if b.shape != a.shape or h0.shape != (B, W):
        raise ValueError(f"rglru scan shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)} do not "
                         "match")
    for name, t in (("b", b), ("h0", h0)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    hs = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, W), dtype=torch.float32, device=a.device)
    err = LIB.load().repro_rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
        hT.data_ptr(), build.DTYPE_CODE[a.dtype], B, S, W,
        build.stream_ptr(a.device))
    build.check(err, "rglru_scan")
    LAUNCHES += 1
    return hs, hT


def rglru_scan(a, b, h0, *, impl: str = "auto"):
    """a,b: [B,S,W]; h0: [B,W] -> (hs [B,S,W] fp32, hT [B,W] fp32).
    impl: "auto" (the kernel on CUDA, the plain version on CPU) or
    "reference" (the plain version)."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto" and a.is_cuda:
        return rglru_scan_cuda(a, b, h0)
    return rglru_scan_ref(a, b, h0)
