"""Batched cosine-similarity top-k (K3), the semantic index's scoring path.

``similarity_topk`` dispatches on the tensor's device: a CPU tensor takes
the plain PyTorch version (``ref.py``); a CUDA tensor launches the
hand-written kernel in ``csrc/similarity_topk.cu``, or raises if it cannot
be built or launched.  ``impl="reference"`` runs the plain version on any
device; only comparisons of the kernel against it pass that.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, report
from repro_torch.kernels.similarity_topk.ref import (l2_normalize,
                                                     similarity_topk_ref)

_FUSED_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p] * 4
_LARGE_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
LIB = build.CudaLibrary("similarity_topk.cu", {
    "repro_similarity_topk": _FUSED_ARGS,
    "repro_similarity_topk_large": _LARGE_ARGS,
})
BLOCK_N = 128        # corpus rows per tile (csrc/similarity_topk.cu)
K_FUSED = 128        # largest k the fused path keeps in registers
K_WIDE = 32          # largest k of the 128-query block
WIDE_D = 64          # largest D of the 128-query block (queries resident)
BLOCKS_PER_SM = 2    # 16-query blocks an SM holds

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _block(device, Q: int, n_tiles: int, D: int, k: int, aligned: bool):
    """``(block_q, slots)``: queries a block and blocks the card holds.
    128 queries a block (one an SM, products on wgmma) read the corpus
    fewer times, and are taken for k <= 32, D <= 64, D % 4 == 0 and a
    16-byte aligned corpus where their blocks fill the card; otherwise 16
    (two an SM, mma.sync).  Both give a score the same bits."""
    sms = _sm_count(device)
    if (Q > 16 and k <= K_WIDE and D <= WIDE_D and D % 4 == 0 and aligned
            and -(-Q // 128) * n_tiles >= sms):
        return 128, sms
    return 16, BLOCKS_PER_SM * sms


def _splits(slots: int, q_tiles: int, n_tiles: int):
    """``(tiles_per_split, splits)``: cut the corpus's ``n_tiles`` 128-row
    tiles into runs so that q_tiles * splits blocks fill one wave of the
    card's ``slots`` blocks, and never more (a second, partial wave would
    take as long as the first)."""
    splits = max(1, min(n_tiles, slots // q_tiles))
    per_split = -(-n_tiles // splits)
    return per_split, -(-n_tiles // per_split)


def similarity_topk_cuda(q: torch.Tensor, c: torch.Tensor, k: int):
    """Launch the kernel.  q [Q, D], c [N, D]: unit-normalized contiguous
    fp32 rows on one CUDA device.  Returns ``(vals [Q, k] fp32
    descending, idx [Q, k] int32)``.  An empty query set or ``k == 0``
    has nothing to select and launches nothing."""
    global LAUNCHES
    if q.dim() != 2 or c.dim() != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(f"similarity_topk: shapes {tuple(q.shape)} and "
                         f"{tuple(c.shape)} are not [Q,D] and [N,D]")
    for name, t in (("queries", q), ("corpus", c)):
        if t.device != q.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{q.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: the kernel takes contiguous fp32 rows")
    (Q, D), N = q.shape, c.shape[0]
    if k < 0 or N >= 2 ** 31 - 1 or D < 1:
        raise ValueError(f"similarity_topk: k={k}, N={N}, D={D}")
    vals = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0 or k == 0:
        return vals, idx
    n_tiles = max(1, -(-N // BLOCK_N))
    block_q, slots = _block(q.device, Q, n_tiles, D, k,
                            c.data_ptr() % 16 == 0)
    per_split, splits = _splits(slots, -(-Q // block_q), n_tiles)
    stream = build.stream_ptr(q.device)
    if k <= K_FUSED:
        part = torch.empty((Q, splits, k), dtype=torch.int64,
                           device=q.device)
        err = LIB.load().repro_similarity_topk(
            q.data_ptr(), c.data_ptr(), Q, N, D, k, block_q, per_split,
            splits, part.data_ptr(), vals.data_ptr(), idx.data_ptr(), stream)
    else:
        p2 = 1 << max(min(k, N) - 1, 0).bit_length()
        keys = torch.empty((Q, N), dtype=torch.int64, device=q.device)
        buf = torch.empty((Q, p2), dtype=torch.int64, device=q.device)
        err = LIB.load().repro_similarity_topk_large(
            q.data_ptr(), c.data_ptr(), Q, N, D, k, block_q, per_split,
            splits, keys.data_ptr(), buf.data_ptr(), p2, vals.data_ptr(),
            idx.data_ptr(), stream)
    build.check(err, "similarity_topk")
    LAUNCHES += 1
    report("similarity_topk", lambda: (2.0 * Q * N * D,
                                       4 * (Q + N) * D + 8 * Q * k))
    return vals, idx


def similarity_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
                    impl: str = "auto"):
    """Top-k corpus rows per query by cosine similarity.

    queries: [Q, D], corpus: [N, D] (any float dtype; normalized here).
    Returns ``(vals [Q, k] fp32 descending, idx [Q, k] int32)``; ties go to
    the lower corpus index; with ``k > N`` the tail holds ``-inf`` / ``-1``.
    impl: "auto" (the kernel on CUDA, the plain version on CPU) or
    "reference" (the plain version).
    """
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto" and queries.is_cuda:
        return similarity_topk_cuda(l2_normalize(queries),
                                    l2_normalize(corpus), k)
    return similarity_topk_ref(queries, corpus, k)
