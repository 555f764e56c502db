"""Flash attention wrapper in the model layout [B, S, heads, hd].

``flash_attention`` dispatches on the tensor's device: a CPU tensor takes
the plain PyTorch version (``ref.py``); a CUDA tensor launches the
hand-written kernel in ``csrc/flash_attention.cu``, or raises if it cannot
be built or launched; a meta tensor (the dry-run's) takes the kernel's
meta route, which checks, allocates and reports the launch without
running it.  ``impl="reference"`` runs the plain version on any device;
only comparisons of the kernel against it pass that.

Where q, k or v requires grad, a CUDA or meta tensor goes through
:class:`FlashAttentionFn`: the kernel forward, and a backward that
recomputes the plain version over blocks of ``BACKWARD_ROWS`` query rows
with the forward's mask, window, scale and query offset.

``chunked_attention`` is the entry of the continuous batcher's chunked
prefill (a decode step with T > 1 new tokens a row, against the dense
cache view): on a CUDA tensor two launches, a prologue that applies the
qk-norm and RoPE to the new q and k and writes the new k and v into the
cache view at each row's offset, then the attention kernel with per-row
query offsets; on a CPU tensor, or with ``impl="reference"``, its plain
version (``ref.chunked_attention_ref``).  ``chunked_fits`` says which
shapes the kernel takes; ``models/attention`` keeps the plain path for the
rest.  Inference only: nothing here takes a gradient.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels import build, local, report
from repro_torch.kernels.autograd import recompute_grads
from repro_torch.kernels.flash_attention.ref import (chunked_attention_ref,
                                                      flash_attention_ref)

LIB = build.CudaLibrary("flash_attention.cu", {
    "repro_flash_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "repro_flash_attention_chunked": [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 7 + [ctypes.c_char_p, ctypes.c_float,
                             ctypes.c_float, ctypes.c_void_p],
})
_pack_strides = struct.Struct("12q").pack   # the entry point's strides[12]
_pack_chunked = struct.Struct("15q").pack   # the chunked entry's strides[15]
HEAD_DIMS = (64, 128, 160, 256)
# returned by the entry point where the bf16 kernel cannot take an input
ERR_UNSUPPORTED = -1

# Query rows of the plain version recomputed at once in the backward: its
# fp32 scores are [B, KV, G, rows, Skv].
BACKWARD_ROWS = 1024

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0
# Launches of the chunked-prefill entry's kernels on the card, two a call
# (the prologue, then the attention), counted apart from LAUNCHES.
CHUNKED_LAUNCHES = 0


def block_rows(hd: int) -> int:
    """Rows (position, head) of a unit of the bf16 kernel: BM."""
    return 64 if hd > 128 else 128


def check(q, k, v):
    """Raise where the kernel cannot take the inputs: the wrapper's checks
    and, for bf16, the entry point's (which returns ERR_UNSUPPORTED on the
    card): at most BM q heads a kv head, and strides and bases TMA can
    read, 16-byte multiples (a base by its storage offset: the
    allocator's blocks are aligned)."""
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
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, q has {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")
    if q.dtype == torch.bfloat16 and (H // KV > block_rows(hd) or not all(
            (t.storage_offset() * 2) % 16 == 0
            and all((st * 2) % 16 == 0 for st in t.stride()[:3])
            for t in (q, k, v))):
        raise ValueError(f"the bf16 flash attention kernel cannot take "
                         f"H / KV = {H // KV} q heads a kv head at hd {hd}, "
                         f"or TMA cannot read the strides of q, k, v or out")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel.  q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] (read
    through strides) -> [B,Sq,H,hd]."""
    global LAUNCHES
    check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = _pack_strides(*q.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], *out.stride()[:3])
    err = LIB.load().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODE[q.dtype], B, H, KV, Sq, Skv, hd, strides,
        int(causal), int(window), sm_scale_of(hd),
        build.stream_ptr(q.device))
    if err == ERR_UNSUPPORTED:
        raise ValueError(f"the bf16 flash attention kernel cannot take "
                         f"H / KV = {H // KV} q heads a kv head at hd {hd}, "
                         f"or TMA cannot read the strides of q, k, v or out")
    build.check(err, "flash_attention")
    LAUNCHES += 1
    report("flash_attention", lambda: work(q, k, causal, window))
    return out


def flash_attention_meta(q, k, v, *, causal: bool = True, window: int = 0):
    """The kernel's meta route (a dry-run on meta tensors): the launch's
    checks and output, its work reported, and no launch; ``LAUNCHES`` is
    left alone."""
    check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    report("flash_attention", lambda: work(q, k, causal, window))
    return out


def pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits: query i at kv position
    i + Skv - Sq sees keys (qp - window, qp] (causal) or all."""
    qp = torch.arange(Sq, dtype=torch.int64) + (Skv - Sq)
    hi = qp.clamp(max=Skv - 1) if causal else torch.full_like(qp, Skv - 1)
    lo = (qp - window + 1).clamp(min=0) if window else torch.zeros_like(qp)
    return int((hi - lo + 1).clamp(min=0).sum())


def work(q, k, causal: bool, window: int):
    """(FLOPs, bytes) of one launch: q.k and p.v over the admitted pairs;
    q, k, v read and out written once."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    return (4.0 * B * H * hd * pairs(Sq, Skv, causal, window),
            es * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd))


def sm_scale_of(hd: int) -> float:
    """The softmax scale the kernel is launched with."""
    return hd ** -0.5


class FlashAttentionFn(torch.autograd.Function):
    """``launch(q, k, v, causal=, window=)`` in the forward (the kernel,
    in the model layout); the backward recomputes the plain version
    block by block of ``rows`` query rows, query row i at kv position
    i + Skv - Sq, and returns its gradients."""

    @staticmethod
    def forward(ctx, launch, q, k, v, causal, window, sm_scale, rows):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, sm_scale, rows)
        return launch(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, sm_scale, rows = ctx.args
        Sq, Skv = q.shape[1], k.shape[1]
        need_q, need_k, need_v = ctx.needs_input_grad[1:4]
        dq = torch.empty_like(q) if need_q else None
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for r0 in range(0, Sq, rows):
            r1 = min(r0 + rows, Sq)

            def plain(qc, kk, vv, r0=r0):
                return (flash_attention_ref(
                    qc.transpose(1, 2), kk.transpose(1, 2),
                    vv.transpose(1, 2), causal=causal, window=window,
                    sm_scale=sm_scale, q_offset=r0 + Skv - Sq
                ).transpose(1, 2),)

            gq, gk, gv = recompute_grads(
                plain, (q[:, r0:r1], k, v), (need_q, need_k, need_v),
                (dout[:, r0:r1],))
            if need_q:
                dq[:, r0:r1] = gq
            if need_k:
                dk += gk
            if need_v:
                dv += gv
        return (None, dq, dk.to(k.dtype) if need_k else None,
                dv.to(v.dtype) if need_v else None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    impl: str = "auto"):
    """q: [B,Sq,H,hd]; k,v: [B,Skv,KV,hd] -> [B,Sq,H,hd].

    q position i sits at kv position i + Skv - Sq.  impl: "auto" (the
    kernel on CUDA, the plain version on CPU) or "reference" (the plain
    version).  DTensors run on each rank's rows, and on its heads where q's
    and k's heads both divide ``model`` (``kernels.local``): rank r's q
    heads must read rank r's kv heads in order.
    """
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if local.is_dtensor(q):          # each rank: its rows and heads
        d = ("dp", None, "tp", None)
        return local.run_local(
            lambda *t: flash_attention(*t, causal=causal, window=window,
                                       impl=impl), (q, k, v), (d, d, d), d)
    if impl == "auto" and (q.is_cuda or q.is_meta):
        launch = flash_attention_cuda if q.is_cuda else flash_attention_meta
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(
                launch, q, k, v, causal, window, sm_scale_of(q.shape[-1]),
                BACKWARD_ROWS)
        return launch(q, k, v, causal=causal, window=window)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def chunked_fits(H: int, KV: int, hd: int, dtype) -> bool:
    """Whether the chunked entry's kernels take these heads: hd in
    ``HEAD_DIMS``, GQA groups of at most ``block_rows(hd)`` q heads, bf16
    or fp32."""
    return (dtype in build.DTYPE_CODE and hd in HEAD_DIMS and KV > 0
            and H % KV == 0 and H // KV <= block_rows(hd))


def _check_chunked(q, k, v, cache_k, cache_v, lengths, q_norm, k_norm,
                   cos, sin):
    B, T, H, hd = q.shape
    Smax, KV = cache_k.shape[1], cache_k.shape[2]
    if not chunked_fits(H, KV, hd, q.dtype):
        raise ValueError(f"the chunked flash attention kernel cannot take "
                         f"H={H}, KV={KV}, hd={hd}, {q.dtype}")
    if (k.shape != (B, T, KV, hd) or v.shape != k.shape
            or cache_k.shape != (B, Smax, KV, hd)
            or cache_v.shape != cache_k.shape or lengths.shape != (B,)):
        raise ValueError(f"chunked attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, cache "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)},"
                         f" lengths {tuple(lengths.shape)}")
    for name, t in (("k", k), ("v", v), ("cache_k", cache_k),
                    ("cache_v", cache_v), ("q_norm", q_norm),
                    ("k_norm", k_norm)):
        if t is not None and (t.dtype != q.dtype or t.device != q.device):
            raise TypeError(f"{name}: {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_k", cache_k),
                    ("cache_v", cache_v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")
    if q.dtype == torch.bfloat16 and not all(
            (t.storage_offset() * 2) % 16 == 0
            and all((st * 2) % 16 == 0 for st in t.stride()[:3])
            for t in (cache_k, cache_v)):
        raise ValueError("TMA cannot read the strides of the cache view")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous() or \
            lengths.device != q.device:
        raise TypeError("lengths must be contiguous int32 on q's device")
    for name, t in (("q_norm", q_norm), ("k_norm", k_norm)):
        if t is not None and (t.shape != (hd,) or not t.is_contiguous()):
            raise ValueError(f"{name}: a contiguous [{hd}] scale")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin go together")
    for t in (cos, sin):
        if t is not None and (t.shape != (B, T, hd // 2)
                              or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != q.device):
            raise ValueError(f"cos / sin: contiguous fp32 [{B}, {T}, "
                             f"{hd // 2}] on q's device")


def chunked_attention_cuda(q, k, v, cache_k, cache_v, lengths, *,
                           q_norm=None, k_norm=None, eps: float = 1e-6,
                           cos=None, sin=None):
    """Launch the chunked entry (prologue, then attention with per-row
    query offsets); arguments as ``ref.chunked_attention_ref``.  Writes
    the new k, v into the cache view and returns the attention
    [B,T,H,hd]."""
    global CHUNKED_LAUNCHES
    _check_chunked(q, k, v, cache_k, cache_v, lengths, q_norm, k_norm,
                   cos, sin)
    B, T, H, hd = q.shape
    Smax, KV = cache_k.shape[1], cache_k.shape[2]
    q_out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    out = torch.empty_like(q_out)
    strides = _pack_chunked(*q.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], *cache_k.stride()[:3],
                            *cache_v.stride()[:3])

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = LIB.load().repro_flash_attention_chunked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(q_norm), ptr(k_norm),
        ptr(cos), ptr(sin), lengths.data_ptr(), q_out.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
        build.DTYPE_CODE[q.dtype], B, T, H, KV, Smax, hd, strides,
        float(eps), sm_scale_of(hd), build.stream_ptr(q.device))
    if err == ERR_UNSUPPORTED:
        raise ValueError(f"the chunked flash attention kernel cannot take "
                         f"H / KV = {H // KV} q heads a kv head at hd {hd}, "
                         f"or TMA cannot read the cache view")
    build.check(err, "flash_attention_chunked")
    CHUNKED_LAUNCHES += 2
    report("flash_attention_chunked",
           lambda: chunked_work(q, cache_k, lengths))
    return out


def chunked_work(q, cache_k, lengths):
    """(FLOPs, bytes) of one chunked call: q.k and p.v over the pairs the
    per-row offsets admit; q, k, v and the valid cache prefix read once,
    the output and the new k, v written once."""
    B, T, H, hd = q.shape
    KV = cache_k.shape[2]
    Smax = cache_k.shape[1]
    pos = (lengths.long().cpu()[:, None] - T
           + torch.arange(T)[None])                             # [B,T]
    keys = (pos + 1).clamp(0, Smax)
    seen = (lengths.long().cpu() - T).clamp(0, Smax)   # before the step
    es = q.element_size()
    return (4.0 * H * hd * float(keys.sum()),
            es * (2 * B * T * H * hd + 4 * B * T * KV * hd
                  + 2 * float(seen.sum()) * KV * hd))


def chunked_attention(q, k, v, cache_k, cache_v, lengths, *, q_norm=None,
                      k_norm=None, eps: float = 1e-6, cos=None, sin=None,
                      impl: str = "auto"):
    """The chunked-prefill step of one layer (``ref.chunked_attention_ref``
    says what it computes): the kernels on a CUDA tensor with impl
    "auto", the plain version on the CPU or with "reference"."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    fn = (chunked_attention_cuda if impl == "auto" and q.is_cuda
          else chunked_attention_ref)
    return fn(q, k, v, cache_k, cache_v, lengths, q_norm=q_norm,
              k_norm=k_norm, eps=eps, cos=cos, sin=sin)
