"""RWKV-6 wkv scan (K5) in the model layout [B, S, H, hd].

``rwkv6_scan`` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref.py``); a CUDA tensor launches the
hand-written kernel in ``csrc/rwkv6_scan.cu``, or raises if it cannot be
built or launched.  ``impl="reference"`` runs the plain version on any
device; only comparisons of the kernel against it pass that.

The kernel reads r, k and v in their own type (bf16 or fp32, one type
for the three: the served model hands them over in bf16) and w, u and the
state in fp32: the wrapper casts w, u and s0 to fp32 where they are not
(the served model's w already is).  Sequences of 32 steps or more take the
kernel's chunked path (dense products within each chunk of 32 steps),
shorter ones (the decode steps) its step path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

LIB = build.CudaLibrary("rwkv6_scan.cu", {
    "repro_rwkv6_scan": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p],
})
HEAD_DIMS = (16, 64)

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0


def rwkv6_scan_cuda(r, k, v, w, u, s0):
    """Launch the kernel.  r,k,v,w: [B,S,H,hd]; u: [H,hd]; s0:
    [B,H,hd,hd].  Returns (o [B,S,H,hd] fp32, sT [B,H,hd,hd] fp32)."""
    global LAUNCHES
    if r.dim() != 4:
        raise ValueError(f"rwkv6 scan takes r, k, v, w [B,S,H,hd]; got r "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if r.dtype not in build.DTYPE_CODE:
        raise TypeError(f"rwkv6 scan takes bf16 or fp32, not {r.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6 scan kernel takes hd in {HEAD_DIMS}; "
                         f"got {hd}")
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or u.shape != (H, hd) or s0.shape != (B, H, hd, hd)):
        raise ValueError(f"rwkv6 scan shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)} do not match")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, r is {r.dtype}")
    r, k, v = (t.contiguous() for t in (r, k, v))
    w, u, s0 = (t.to(torch.float32).contiguous() for t in (w, u, s0))
    if s0.data_ptr() % 16:             # the kernel reads S in 16-byte rows
        s0 = s0.clone()
    o = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    err = LIB.load().repro_rwkv6_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), o.data_ptr(), sT.data_ptr(),
        build.DTYPE_CODE[r.dtype], B, S, H, hd, build.stream_ptr(r.device))
    build.check(err, "rwkv6_scan")
    LAUNCHES += 1
    return o, sT


def rwkv6_scan(r, k, v, w, u, s0, *, impl: str = "auto"):
    """r,k,v,w: [B,S,H,hd]; u: [H,hd]; s0: [B,H,hd,hd] ->
    (o [B,S,H,hd] fp32, sT [B,H,hd,hd] fp32).  impl: "auto" (the kernel
    on CUDA, the plain version on CPU) or "reference" (the plain
    version)."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto" and r.is_cuda:
        return rwkv6_scan_cuda(r, k, v, w, u, s0)
    return rwkv6_scan_ref(r, k, v, w, u, s0)
