"""RG-LRU scan (K4): h_t = a_t * h_{t-1} + b_t over a, b [B, S, W].

``rglru_scan`` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref.py``); a CUDA tensor launches the
hand-written kernel in ``csrc/rglru_scan.cu``, or raises if it cannot be
built or launched; a meta tensor (the dry-run's) takes the kernel's meta
route, which checks, allocates and reports the launch without running it
(the backward's reverse scan too).  ``impl="reference"`` runs the plain
version on any device; only comparisons of the kernel against it pass
that.

The kernel reads a and b in their own type (bf16 or fp32, one type for
both; the served model's are fp32) and the state in fp32: the wrapper
casts h0 to fp32 where it is not.

Where a, b or h0 requires grad, a CUDA or meta tensor goes through
:class:`RglruScanFn`: the kernel forward, and a backward that is K4 run
in reverse (``rglru_scan_bwd_cuda``) from the saved a, h0 and the
forward's own hs; its launches count on ``REVERSE_LAUNCHES``, so
``LAUNCHES`` counts forward launches only.  It gives the bits of autograd
of the plain version, as the plain reverse ``ref.rglru_scan_bwd_ref``
does on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, local, report
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)

LIB = build.CudaLibrary("rglru_scan.cu", {
    "repro_rglru_scan": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p],
    "repro_rglru_scan_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p],
})

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count): the forward, and the reverse scan of
# the backward
LAUNCHES = 0
REVERSE_LAUNCHES = 0


def check(a, b, h0):
    """Raise where the kernel cannot take a, b [B,S,W] and h0 [B,W]."""
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


def _prepare(a, b, h0):
    """Checks, then the launch's inputs and outputs (hs, hT fp32)."""
    check(a, b, h0)
    B, S, W = a.shape
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    hs = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, W), dtype=torch.float32, device=a.device)
    return a, b, h0, hs, hT


def _work(a):
    B, S, W = a.shape
    return 2.0 * B * S * W, (2 * a.element_size() + 4) * B * S * W + 8 * B * W


def rglru_scan_cuda(a, b, h0):
    """Launch the kernel.  a,b: [B,S,W]; h0: [B,W].  Returns
    (hs [B,S,W] fp32, hT [B,W] fp32)."""
    global LAUNCHES
    a, b, h0, hs, hT = _prepare(a, b, h0)
    B, S, W = a.shape
    err = LIB.load().repro_rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(),
        hT.data_ptr(), build.DTYPE_CODE[a.dtype], B, S, W,
        build.stream_ptr(a.device))
    build.check(err, "rglru_scan")
    LAUNCHES += 1
    report("rglru_scan", lambda: _work(a))
    return hs, hT


def rglru_scan_meta(a, b, h0):
    """The kernel's meta route (a dry-run on meta tensors): the launch's
    checks and allocations, its work reported, and no launch;
    ``LAUNCHES`` is left alone."""
    a, b, h0, hs, hT = _prepare(a, b, h0)
    report("rglru_scan", lambda: _work(a))
    return hs, hT


def check_bwd(a, hs, h0, d_hs, d_hT):
    """Raise where the reverse kernel cannot take its inputs."""
    if a.dim() != 3 or a.dtype not in build.DTYPE_CODE:
        raise TypeError(f"rglru scan backward takes a [B,S,W] of bf16 or "
                        f"fp32; got {a.dtype} {tuple(a.shape)}")
    B, S, W = a.shape
    if (hs.shape != a.shape or d_hs.shape != a.shape
            or h0.shape != (B, W) or d_hT.shape != (B, W)):
        raise ValueError(f"rglru scan backward shapes a {tuple(a.shape)}, "
                         f"hs {tuple(hs.shape)}, d_hs {tuple(d_hs.shape)}, "
                         f"h0 {tuple(h0.shape)}, d_hT {tuple(d_hT.shape)} "
                         "do not match")
    for name, t in (("hs", hs), ("h0", h0), ("d_hs", d_hs), ("d_hT", d_hT)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")


def _prepare_bwd(a, hs, h0, d_hs, d_hT, needs):
    check_bwd(a, hs, h0, d_hs, d_hT)
    a = a.contiguous()
    h0, d_hs, d_hT = (t.to(torch.float32).contiguous()
                      for t in (h0, d_hs, d_hT))
    hs = hs.to(torch.float32).contiguous() if needs[0] else None  # for da
    da, db = (torch.empty_like(a) if n else None for n in needs[:2])
    dh0 = torch.empty_like(h0) if needs[2] else None
    return a, hs, h0, d_hs, d_hT, da, db, dh0


def _work_bwd(a, needs):
    B, S, W = a.shape
    es, n = a.element_size(), B * S * W
    return ((2.0 + needs[0]) * n + needs[2] * B * W,
            (es + 4 + needs[0] * (4 + es) + needs[1] * es) * n
            + 4 * (1 + needs[0] + needs[2]) * B * W)


def rglru_scan_bwd_cuda(a, hs, h0, d_hs, d_hT, needs=(True, True, True)):
    """Launch the reverse kernel: the gradients of the scan that gave
    ``hs`` from a [B,S,W] and h0 [B,W], against d_hs [B,S,W] and d_hT
    [B,W].  Returns (da, db [B,S,W] in a's dtype, dh0 [B,W] fp32), each
    None where ``needs`` says it is not wanted (and not written)."""
    global REVERSE_LAUNCHES
    a, hs, h0, d_hs, d_hT, da, db, dh0 = _prepare_bwd(a, hs, h0, d_hs, d_hT,
                                                      needs)
    B, S, W = a.shape

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = LIB.load().repro_rglru_scan_bwd(
        a.data_ptr(), ptr(hs), h0.data_ptr(), d_hs.data_ptr(),
        d_hT.data_ptr(), ptr(da), ptr(db), ptr(dh0),
        build.DTYPE_CODE[a.dtype], B, S, W, build.stream_ptr(a.device))
    build.check(err, "rglru_scan_bwd")
    REVERSE_LAUNCHES += 1
    report("rglru_scan_bwd", lambda: _work_bwd(a, needs))
    return da, db, dh0


def rglru_scan_bwd_meta(a, hs, h0, d_hs, d_hT, needs=(True, True, True)):
    """The reverse kernel's meta route: checks, allocations and reported
    work, no launch; ``REVERSE_LAUNCHES`` is left alone."""
    a, hs, h0, d_hs, d_hT, da, db, dh0 = _prepare_bwd(a, hs, h0, d_hs, d_hT,
                                                      needs)
    report("rglru_scan_bwd", lambda: _work_bwd(a, needs))
    return da, db, dh0


class RglruScanFn(torch.autograd.Function):
    """``launch(a, b, h0)`` in the forward (the kernel); the backward runs
    the recurrence in reverse from the saved a, h0 and the forward's own
    hs: the reverse kernel on a CUDA tensor, ``rglru_scan_bwd_ref`` on a
    CPU one.  Gradients come back in their inputs' dtypes."""

    @staticmethod
    def forward(ctx, launch, a, b, h0):
        hs, hT = launch(a, b, h0)
        ctx.save_for_backward(a, h0, hs)
        ctx.b_dtype = b.dtype
        return hs, hT

    @staticmethod
    def backward(ctx, d_hs, d_hT):
        a, h0, hs = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        if a.is_cuda or a.is_meta:   # b's dtype is a's: the kernel's
            reverse = rglru_scan_bwd_cuda if a.is_cuda else rglru_scan_bwd_meta
            da, db, dh0 = reverse(a, hs, h0, d_hs, d_hT, needs)
            dh0 = None if dh0 is None else dh0.to(h0.dtype)
        else:
            da, db, dh0 = rglru_scan_bwd_ref(a, hs, h0, d_hs, d_hT,
                                             b_dtype=ctx.b_dtype)
        return (None,) + tuple(g if n else None
                               for g, n in zip((da, db, dh0), needs))


def rglru_scan(a, b, h0, *, impl: str = "auto"):
    """a,b: [B,S,W]; h0: [B,W] -> (hs [B,S,W] fp32, hT [B,W] fp32).
    impl: "auto" (the kernel on CUDA, the plain version on CPU) or
    "reference" (the plain version).  DTensors run on each rank's rows and
    channels (``kernels.local``)."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if local.is_dtensor(a):          # each rank: its rows and channels
        d3, d2 = ("dp", None, "tp"), ("dp", "tp")
        return local.run_local(lambda *t: rglru_scan(*t, impl=impl),
                               (a, b, h0), (d3, d3, d2), (d3, d2))
    if impl == "auto" and (a.is_cuda or a.is_meta):
        launch = rglru_scan_cuda if a.is_cuda else rglru_scan_meta
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad
                                        or h0.requires_grad):
            return RglruScanFn.apply(launch, a, b, h0)
        return launch(a, b, h0)
    return rglru_scan_ref(a, b, h0)
