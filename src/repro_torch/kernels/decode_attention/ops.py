"""Flash-decode wrappers in the model layout, the paged gather, and the
sequence-sharded decode of the mesh path.

``flash_decode`` dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel in ``csrc/decode_attention.cu``, or raises if it cannot be built or
launched; a meta tensor (the dry-run's) takes the kernel's meta route,
which checks, allocates and reports the launch without running it.
``impl="reference"`` runs the plain version on any device; only
comparisons of the kernel against it pass that.  DTensors run on each
rank's rows with the whole cache (``kernels.local``).

``flash_decode_sharded`` takes a cache whose sequence axis is sharded over
a mesh axis: each rank runs ``flash_decode(..., return_lse=True)`` over
its chunk (the kernel on the card) and the partials are combined by their
logsumexp with one all-reduce MAX and two all-reduce SUMs over that axis.
``write_kv_sharded`` writes a decode step's k / v into the rank that owns
the position, with no collective.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import build, local, report
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_with_lse_ref)

LIB = build.CudaLibrary("decode_attention.cu", {
    "repro_decode_attention": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_float, ctypes.c_void_p],
})
_pack_strides = struct.Struct("10q").pack   # the entry point's strides[10]
HEAD_DIMS = (64, 128, 160, 256)
GROUPS = range(1, 17)        # q heads a kv head: one block holds them all
# returned by the entry point where the kernel cannot take an input
ERR_UNSUPPORTED = -1

# Launches of the kernel, counted where the wrapper launches it (runs of
# the plain version do not count).
LAUNCHES = 0


def check(q, k_cache, v_cache):
    """Raise where the kernel cannot take the inputs: the wrapper's checks
    and the entry point's (which returns ERR_UNSUPPORTED on the card):
    hd, the q heads a kv head, 16-byte aligned rows and bases (a base by
    its storage offset: the allocator's blocks are aligned)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    if q.dtype not in build.DTYPE_CODE:
        raise TypeError(f"decode attention takes bf16 or fp32, not {q.dtype}")
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd or H % KV):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError(f"caches on {k_cache.device} / {v_cache.device}, "
                         f"q on {q.device}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"caches of {k_cache.dtype} / {v_cache.dtype}, q "
                        f"of {q.dtype}")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError("q, k_cache and v_cache need a contiguous last dim")
    es = q.element_size()
    rows = ((q, (0, 2)), (k_cache, (0, 1, 2)), (v_cache, (0, 1, 2)))
    aligned = all((t.storage_offset() * es) % 16 == 0
                  and all((t.stride(d) * es) % 16 == 0 for d in dims)
                  for t, dims in rows)
    if hd not in HEAD_DIMS or H // KV not in GROUPS or not aligned:
        raise ValueError(f"decode attention kernel takes hd in {HEAD_DIMS}, "
                         f"H/KV in {GROUPS.start}..{GROUPS.stop - 1} and "
                         f"16-byte aligned rows; got hd={hd}, H={H}, KV={KV}")


def _prepare(q, k_cache, v_cache, lengths, return_lse):
    """Checks, then the launch's int32 lengths and its outputs (out, lse)
    on q's device."""
    check(q, k_cache, v_cache)
    B, _, H, hd = q.shape
    if not (lengths.dtype == torch.int32 and lengths.device == q.device
            and lengths.is_contiguous()):
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    return lengths, out, lse


def decode_attention_cuda(q, k_cache, v_cache, lengths, *,
                          return_lse: bool = False):
    """Launch the kernel.  q: [B,1,H,hd]; k_cache,v_cache: [B,Smax,KV,hd]
    (model layout, read through strides); lengths: int [B].
    Returns out [B,1,H,hd] (and lse [B,H,1] fp32)."""
    global LAUNCHES
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    lengths, out, lse = _prepare(q, k_cache, v_cache, lengths, return_lse)
    strides = _pack_strides(q.stride(0), q.stride(2), *k_cache.stride()[:3],
                            *v_cache.stride()[:3], out.stride(0),
                            out.stride(2))
    err = LIB.load().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        build.DTYPE_CODE[q.dtype], B, H, KV, Smax, hd, strides, hd ** -0.5,
        build.stream_ptr(q.device))
    if err == ERR_UNSUPPORTED:
        raise ValueError(f"decode attention kernel takes hd in {HEAD_DIMS}, "
                         f"H/KV in {GROUPS.start}..{GROUPS.stop - 1} and "
                         f"16-byte aligned rows; got hd={hd}, H={H}, KV={KV}")
    build.check(err, "decode_attention")
    LAUNCHES += 1
    report("decode_attention", lambda: work(q, k_cache, lengths, return_lse))
    return (out, lse) if return_lse else out


def decode_attention_meta(q, k_cache, v_cache, lengths, *,
                          return_lse: bool = False):
    """The kernel's meta route (a dry-run on meta tensors): the launch's
    checks and allocations, its work reported over full lengths (a meta
    tensor has no data), and no launch; ``LAUNCHES`` is left alone."""
    lengths, out, lse = _prepare(q, k_cache, v_cache, lengths, return_lse)
    report("decode_attention", lambda: work(q, k_cache, None, return_lse))
    return (out, lse) if return_lse else out


def work(q, k_cache, lengths, return_lse: bool = False):
    """(FLOPs, bytes) of one launch over the valid keys (every slot where
    ``lengths`` is None): q.k and p.v; q, the valid K and V rows and
    lengths read, out (and lse) written."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    es = q.element_size()
    keys = (B * Smax if lengths is None
            else int(lengths.clamp(0, Smax).sum()))
    return (4.0 * keys * H * hd,
            2 * B * H * hd * es + 2 * keys * KV * hd * es + 4 * B
            + (4 * B * H if return_lse else 0))


def flash_decode(q, k_cache, v_cache, lengths, *, impl: str = "auto",
                 return_lse: bool = False):
    """q: [B,1,H,hd]; k_cache,v_cache: [B,Smax,KV,hd]; lengths: [B].
    Returns [B,1,H,hd] (and the per-head logsumexp [B,H,1] fp32 when
    ``return_lse``).  impl: "auto" (the kernel on CUDA, the plain version
    on CPU) or "reference" (the plain version)."""
    if impl not in ("auto", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    if local.is_dtensor(q):          # each rank: its rows, the whole cache
        d = ("dp", None, None, None)
        return local.run_local(
            lambda *t: flash_decode(*t, impl=impl, return_lse=return_lse),
            (q, k_cache, v_cache, lengths), (d, d, d, ("dp",)),
            (d, ("dp", None, None)) if return_lse else d)
    if impl == "auto" and (q.is_cuda or q.is_meta):
        launch = decode_attention_cuda if q.is_cuda else decode_attention_meta
        return launch(q, k_cache, v_cache, lengths, return_lse=return_lse)
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


# ---------------------------------------------------------------------------
# sequence-sharded cache (the mesh path)
# ---------------------------------------------------------------------------


def _local(x, mesh, spec):
    """This rank's shard of ``x`` placed by ``spec``: a DTensor is
    redistributed there (a no-op when it is placed so already: then the
    shard is the DTensor's own storage); a plain tensor is the full value
    and is sliced."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.sharding import placements
    want = placements(mesh, spec)
    if local.is_dtensor(x):
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()
    return distribute_tensor(x, mesh, want, src_data_rank=None).to_local()


def _bspec(dp_axes):
    dp = tuple(dp_axes) if isinstance(dp_axes, (tuple, list)) else (
        (dp_axes,) if dp_axes else ())
    return dp if dp else None          # B=1 cells: batch replicated


def flash_decode_sharded(q, k_cache, v_cache, lengths, *, mesh,
                         seq_axis: str, dp_axes, impl: str = "auto"):
    """Flash-decode with the cache's sequence axis sharded over
    ``seq_axis``.

    q: [B,1,H,hd]; k_cache,v_cache: [B,Smax,KV,hd] (Smax sharded over
    ``seq_axis``, B over ``dp_axes``); lengths: [B].  Each rank runs
    flash-decode over its chunk of Smax / n keys (the kernel on a CUDA
    tensor, or it raises; the plain version on the CPU or under
    ``impl="reference"``) with the chunk's local lengths, and the partials
    are combined exactly by ``combine_partials`` (an empty chunk weighs
    0).  Collectives: one all-reduce MAX of [B,H,1] and SUMs of
    [B,1,H,hd] and [B,H,1] over ``seq_axis``.  Returns a DTensor [B,1,H,hd]
    (batch over ``dp_axes``, replicated over ``seq_axis``).
    """
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import placements
    bs = _bspec(dp_axes)
    q_spec = (bs, None, None, None)
    c_spec = (bs, seq_axis, None, None)
    q_l = _local(q, mesh, q_spec)
    k_l = _local(k_cache, mesh, c_spec)
    v_l = _local(v_cache, mesh, c_spec)
    len_l = _local(lengths, mesh, (bs,))
    chunk = k_l.shape[1]
    loc_len = chunk_lengths(len_l, mesh.get_local_rank(seq_axis), chunk)
    out, lse = flash_decode(q_l, k_l, v_l, loc_len, impl=impl,
                            return_lse=True)
    group = mesh.get_group(seq_axis)
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

    def all_reduce(t, op):
        dist.all_reduce(t, op=ops[op], group=group)
        return t
    res = combine_partials(out, lse, loc_len, all_reduce)
    return DTensor.from_local(res, mesh, placements(mesh, q_spec),
                              run_check=False)


def chunk_lengths(lengths, idx: int, chunk: int):
    """The lengths [B] local to sequence chunk ``idx`` of ``chunk`` slots:
    how many of each row's valid keys lie in that chunk (int32)."""
    return (lengths.to(torch.int32) - idx * chunk).clamp(0, chunk)


def combine_partials(out, lse, loc_len, reduce):
    """Combine flash-decode partials over sequence chunks by logsumexp:
        out = sum_s out_s * w_s / sum_s w_s,   w_s = exp(lse_s - max lse)

    out [..., B,1,H,hd] and lse [..., B,H,1] are one chunk's partials and
    loc_len [..., B] its local lengths.  ``reduce(t, op)`` reduces ``t``
    over the chunks with op "max" or "sum" and returns the result in
    ``t``'s shape: an all-reduce across ranks, or a reduction over a
    leading chunk dimension in one process.  A chunk with no valid key
    weighs 0 whatever its lse (the kernel writes -inf there, the TPU kernel
    0); a row whose every chunk is empty gives 0, never NaN."""
    lse = torch.where((loc_len == 0)[..., None, None],
                      torch.full_like(lse, -math.inf), lse)
    lse_max = reduce(lse.clone(), "max")
    wgt = torch.exp(lse - lse_max)                       # [..., B,H,1]
    wgt = torch.where(torch.isfinite(wgt), wgt, torch.zeros_like(wgt))
    num = reduce(out.float() * wgt.unsqueeze(-3), "sum")  # [..., B,1,H,hd]
    den = reduce(wgt, "sum")
    return (num / den.clamp_min(1e-30).unsqueeze(-3)).to(out.dtype)


def write_kv_sharded(cache_k, cache_v, k_new, v_new, start, *, mesh,
                     seq_axis: str, dp_axes):
    """Write single-token k / v into caches whose sequence axis is sharded
    over ``seq_axis``: the write lands in the rank that owns position
    ``start``; on every other rank it is a no-op.  No collective.

    cache_k/v: DTensors [B,Smax,KV,hd] placed with B over ``dp_axes`` and
    Smax over ``seq_axis`` (written in place and returned); k_new/v_new:
    [B,1,KV,hd]; start: [B] global write positions.
    """
    bs = _bspec(dp_axes)
    c_spec = (bs, seq_axis, None, None)
    from repro_torch.launch.sharding import placements
    want = placements(mesh, c_spec)
    for c in (cache_k, cache_v):
        if not local.is_dtensor(c) or tuple(c.placements) != want:
            raise ValueError("write_kv_sharded writes in place: the caches "
                             f"must be DTensors placed as {want}")
    ck, cv = cache_k.to_local(), cache_v.to_local()
    kn = _local(k_new, mesh, (bs, None, None, None))
    vn = _local(v_new, mesh, (bs, None, None, None))
    st = _local(start, mesh, (bs,)).long()
    chunk = ck.shape[1]
    loc = st - mesh.get_local_rank(seq_axis) * chunk          # [B]
    write_rows_owned(ck, cv, kn, vn, loc)
    return cache_k, cache_v


def write_rows_owned(ck, cv, kn, vn, loc):
    """ck/cv [B,chunk,KV,hd] take kn/vn [B,1,KV,hd] at local positions
    loc [B] where 0 <= loc < chunk; a row whose position lies outside
    writes its slot loc clamped into the chunk back with its own value.
    Integer indices only: no ``nonzero`` (a host sync on the card, and no
    meta kernel), so the same code runs on meta tensors."""
    chunk = ck.shape[1]
    ok = ((loc >= 0) & (loc < chunk))[:, None, None]          # [B,1,1]
    at = loc.clamp(0, chunk - 1)
    b = torch.arange(ck.shape[0], device=ck.device)
    for c, n in ((ck, kn), (cv, vn)):
        c[b, at] = torch.where(ok, n[:, 0].to(c.dtype), c[b, at])
