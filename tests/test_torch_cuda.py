"""The port's hand-written CUDA kernels held to their plain PyTorch
versions on the same tensors, on a CUDA device (skipped elsewhere: a CUDA
kernel has no CPU mode).  Imports no JAX, so it runs on a host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 2e-4 (summation
order differs), bf16 5e-2 (outputs round to bf16 at different points),
and 1e-2 where K2 runs without the causal mask over whisper's 1500
frames (outputs there are ~0.04).
K4 (RG-LRU scan) is held to its plain version bit for bit (both round
the multiply and the add separately in fp32), and its reverse (the
backward) to the plain reverse and to autograd bit for bit; K5 (RWKV-6
scan) within 2e-4 of the largest plain value (fp32 sums in another
order).  K3 (similarity top-k) is held tighter: values within 1e-5, ids equal
except between rows whose plain-version scores lie within 1e-5 of each
other, and ids exactly equal on sign vectors, where every score is exact.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref  # noqa: E402
from repro_torch.kernels.similarity_topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.similarity_topk.ref import topk_flips  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.models import attention, blocks, model_zoo  # noqa: E402
from repro_torch.models.common import rope_cos_sin  # noqa: E402
from repro_torch.semindex import (IvfConfig, IvfFlatIndex,  # noqa: E402
                                  SemanticIndexManager, SemIndexConfig)

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# K2 without the causal mask over whisper's 1500 frames, bf16: outputs of
# std ~0.04 on N(0, 1) inputs, so 5e-2 would pass a kernel that dropped
# the ragged 28-key tail tile; held to |out-plain| <= 1e-2, five times the
# largest reading on the H100 (0.00195)
CROSS_TOL = {torch.float32: TOL[torch.float32],
             torch.bfloat16: dict(rtol=0, atol=1e-2)}
TOPK_TOL = 1e-5
# K2's chunked entry in bf16, besides TOL: rel. L2 of the output and of
# the k cache to the plain version.  The card read 0.0027 at the cell's
# shapes (the qk-norm's sums in another order move a bf16 q or k by one
# unit in the last place; both round p to bf16 before P V); a mask that
# drops or adds one key moves a row that sees n keys by ~1/sqrt(n), past
# 0.02 up to 2,048 keys, where TOL's 5e-2 elementwise would pass it
CHUNK_REL_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 7, 8, 16])
def test_decode_kernel(cuda, dtype, hd, G):
    B, Smax, KV = 5, 300, 2
    H = KV * G
    q, kc, vc = _randn(11, [(B, 1, H, hd), (B, Smax, KV, hd),
                            (B, Smax, KV, hd)], dtype, cuda)
    lengths = torch.tensor([1, 63, 64, 65, 300], dtype=torch.int32,
                           device=cuda)
    before = dec_ops.LAUNCHES
    out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
    ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                        impl="reference", return_lse=True)
    torch.cuda.synchronize()
    assert dec_ops.LAUNCHES == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.float32])
    again = dec_ops.flash_decode(q, kc, vc, lengths)
    assert torch.equal(again, out)          # no atomics: bitwise repeatable


def _combine_chunks(q, kc, vc, lengths, n, impl):
    """flash-decode over n sequence chunks, each with its local lengths
    and lse, combined by ``combine_partials``, the combine of
    ``flash_decode_sharded``, with its all-reduces as reductions over the
    stacked chunks."""
    chunk = kc.shape[1] // n
    outs, lses, locs = [], [], []
    for c in range(n):
        loc = dec_ops.chunk_lengths(lengths, c, chunk)
        o, lse = dec_ops.flash_decode(q, kc[:, c * chunk:(c + 1) * chunk],
                                      vc[:, c * chunk:(c + 1) * chunk], loc,
                                      impl=impl, return_lse=True)
        outs.append(o)
        lses.append(lse)
        locs.append(loc)

    def over_chunks(t, op):
        r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
        return r.expand_as(t).clone()
    return dec_ops.combine_partials(torch.stack(outs), torch.stack(lses),
                                    torch.stack(locs), over_chunks)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_decode_kernel_chunk_partials_combine(cuda, dtype, n):
    """K1's lse partials over 2 and 4 sequence chunks (the sequence-
    sharded decode's per-rank work), combined, equal one launch over the
    whole cache and the plain version; rows 0-2 leave chunks empty."""
    B, Smax, KV, H, hd = 4, 512, 2, 16, 128
    q, kc, vc = _randn(21, [(B, 1, H, hd), (B, Smax, KV, hd),
                            (B, Smax, KV, hd)], dtype, cuda)
    lengths = torch.tensor([1, 100, 300, 512], dtype=torch.int32,
                           device=cuda)
    before = dec_ops.LAUNCHES
    got = _combine_chunks(q, kc, vc, lengths, n, "auto")
    assert dec_ops.LAUNCHES - before == n
    whole = dec_ops.flash_decode(q, kc, vc, lengths)
    plain = _combine_chunks(q, kc, vc, lengths, n, "reference")
    ref = dec_ops.flash_decode(q, kc, vc, lengths, impl="reference")
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), whole.float(), **TOL[dtype])
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(plain.float(), ref.float(), **TOL[dtype])


def test_decode_kernel_reads_strided_cache(cuda):
    """A per-layer view of a stacked [P,B,Smax,KV,hd] cache and a [B,1,H,hd]
    slice of a wider q are read through their strides."""
    P, B, Smax, KV, H, hd = 3, 4, 96, 8, 32, 128
    q_wide, kc, vc = _randn(12, [(B, 2, H, hd), (P, B, Smax, KV, hd),
                                 (P, B, Smax, KV, hd)], torch.bfloat16, cuda)
    q = q_wide[:, 1:]
    lengths = torch.tensor([5, 96, 33, 1], dtype=torch.int32, device=cuda)
    out = dec_ops.flash_decode(q, kc[1], vc[1], lengths)
    ref = dec_ops.flash_decode(q.contiguous(), kc[1].contiguous(),
                               vc[1].contiguous(), lengths, impl="reference")
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


def _decode_case(seed, B, Smax, H, KV, hd, lengths, dtype, device):
    """K1 against its plain version (out and lse) on skewed lengths, and
    against itself: a second launch gives the same bits.  A row of length
    0 gives 0 and lse -1e30 (the TPU kernel's finalisation), where the
    plain version's lse is -inf."""
    q, kc, vc = _randn(seed, [(B, 1, H, hd), (B, Smax, KV, hd),
                              (B, Smax, KV, hd)], dtype, device)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    before = dec_ops.LAUNCHES
    out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
    again, lse2 = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
    ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                        impl="reference", return_lse=True)
    torch.cuda.synchronize()
    assert dec_ops.LAUNCHES == before + 2
    assert torch.equal(again, out) and torch.equal(lse2, lse)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    empty = (lengths == 0)[:, None, None].expand_as(lse)
    assert bool((lse[empty] == -1e30).all())
    assert bool((out[lengths == 0] == 0).all())
    torch.testing.assert_close(lse[~empty], ref_lse[~empty],
                               **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(64, 3), (128, 7), (256, 16), (128, 1)])
def test_decode_kernel_skewed_lengths(cuda, dtype, hd, G):
    """Lengths 0 and Smax in one batch with short and long rows between:
    the splits of a short row past its length read nothing."""
    KV, Smax = 2, 1000
    _decode_case(31, 6, Smax, KV * G, KV, hd, [0, 1000, 3, 999, 64, 517],
                 dtype, cuda)


@pytest.mark.parametrize("Smax", [64, 65, 256, 257, 2048])
def test_decode_kernel_split_boundaries(cuda, Smax):
    """recurrentgemma's shape (16 q heads on one kv head, hd 256, B = 8),
    where the cache splits over up to 8 blocks of a cluster: cache lengths
    at and past a tile and a split's keys, row lengths on both sides of
    the split edges."""
    lengths = [min(n, Smax) for n in (0, 1, 63, 64, 65, 255, 257, Smax)]
    _decode_case(32, 8, Smax, 16, 1, 256, lengths, torch.bfloat16, cuda)


def test_kernels_reject_unsupported(cuda):
    q, kc, vc = _randn(13, [(2, 1, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)],
                       torch.float32, cuda)
    with pytest.raises(ValueError):
        dec_ops.flash_decode(q, kc, vc, torch.tensor([1, 2], device=cuda))
    q, kc, vc = _randn(13, [(2, 1, 17, 64), (2, 16, 1, 64), (2, 16, 1, 64)],
                       torch.bfloat16, cuda)
    before = dec_ops.LAUNCHES
    with pytest.raises(ValueError):                       # G = 17
        dec_ops.flash_decode(q, kc, vc, torch.tensor([1, 2], device=cuda))
    assert dec_ops.LAUNCHES == before
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.half(), kc.half(), vc.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,window,causal", [
    (1, 1, 0, True), (37, 37, 0, True), (130, 130, 0, True),
    (96, 96, 32, True), (40, 100, 0, True), (50, 50, 0, False)])
def test_flash_kernel(cuda, dtype, Sq, Skv, window, causal):
    B, H, KV, hd = 2, 8, 2, 128
    q, k, v = _randn(14, [(B, Sq, H, hd), (B, Skv, KV, hd),
                          (B, Skv, KV, hd)], dtype, cuda)
    before = flash_ops.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl="reference")
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(flash_ops.flash_attention(q, k, v, causal=causal,
                                                 window=window), out)


def test_flash_kernel_head_dim_64_and_strided_q(cuda):
    B, S, H, KV, hd = 2, 70, 4, 4, 64
    qkv, = _randn(15, [(B, S, 3, H, hd)], torch.bfloat16, cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = flash_ops.flash_attention(q, k, v)
    ref = flash_ops.flash_attention(q, k, v, impl="reference")
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("impl", ["dense", "auto"])
def test_model_attention_launches_the_kernels(cuda, impl):
    """On the card the model's attention always goes through the kernels:
    a full-sequence pass launches K2, a single-token decode step launches
    K1 whatever ``use_decode_impl`` says; only "reference" (used for
    comparisons) takes the plain versions."""
    B, S, Smax, H, KV, hd = 2, 33, 64, 8, 2, 128
    q, k, v, q1, kc, vc = _randn(16, [
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, 1, H, hd),
        (B, Smax, KV, hd), (B, Smax, KV, hd)], torch.bfloat16, cuda)
    lengths = torch.tensor([5, 64], dtype=torch.int32, device=cuda)
    n_flash, n_dec = flash_ops.LAUNCHES, dec_ops.LAUNCHES
    out = attention.causal_attention(q, k, v)
    with attention.use_decode_impl(impl):
        dec = attention.decode_attention(q1, kc, vc, lengths)
    assert (flash_ops.LAUNCHES, dec_ops.LAUNCHES) == (n_flash + 1, n_dec + 1)
    with attention.use_flash_impl("reference"), \
            attention.use_decode_impl("reference"):
        ref = attention.causal_attention(q, k, v)
        dec_ref = attention.decode_attention(q1, kc, vc, lengths)
    torch.cuda.synchronize()
    assert (flash_ops.LAUNCHES, dec_ops.LAUNCHES) == (n_flash + 1, n_dec + 1)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(dec.float(), dec_ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,window", [(130, 0), (384, 2048), (384, 100),
                                       (37, 16)])
def test_flash_kernel_hd256(cuda, dtype, Sq, window):
    """K2 at recurrentgemma's attention widths: hd 256, 16 q heads on one
    kv head, in window mode with the window shorter and longer than S."""
    B, H, KV, hd = 2, 16, 1, 256
    q, k, v = _randn(21, [(B, Sq, H, hd), (B, Sq, KV, hd), (B, Sq, KV, hd)],
                     dtype, cuda)
    before = flash_ops.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, window=window)
    ref = flash_ops.flash_attention(q, k, v, window=window, impl="reference")
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(flash_ops.flash_attention(q, k, v, window=window), out)


@pytest.mark.parametrize("hd", [64, 128, 160, 256])
@pytest.mark.parametrize("G", [1, 3, 4, 7, 16])
@pytest.mark.parametrize("Sq,Skv,window", [(70, 70, 0), (45, 200, 48),
                                           (130, 130, 48)])
def test_flash_kernel_gqa_groups(cuda, hd, G, Sq, Skv, window):
    """The bf16 kernel's units hold whole GQA groups (rows are (position,
    head) pairs): every head dim at group sizes 1, 4 and 16, and 3 and 7,
    which do not divide a unit's rows; Sq below Skv, Sq not a multiple of
    a unit's positions, causal and window bands; a second launch gives the
    same bits."""
    B, KV = 2, 2
    H = KV * G
    q, k, v = _randn(24, [(B, Sq, H, hd), (B, Skv, KV, hd),
                          (B, Skv, KV, hd)], torch.bfloat16, cuda)
    before = flash_ops.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, window=window)
    ref = flash_ops.flash_attention(q, k, v, window=window, impl="reference")
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(flash_ops.flash_attention(q, k, v, window=window),
                       out)


@pytest.mark.parametrize("hd,G,window", [(128, 4, 0), (256, 16, 2048)])
def test_flash_kernel_reads_fused_qkv(cuda, hd, G, window):
    """q, k and v as views of one fused [B, S, H + 2 KV, hd] projection:
    the tensor maps take their strides."""
    B, S, KV = 2, 77, 1
    H = KV * G
    qkv, = _randn(25, [(B, S, H + 2 * KV, hd)], torch.bfloat16, cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    out = flash_ops.flash_attention(q, k, v, window=window)
    ref = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), window=window,
                                    impl="reference")
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv", [(2, 1500, 1500), (8, 64, 1500),
                                      (8, 1, 1500), (3, 37, 1500)])
def test_flash_kernel_whisper_shapes(cuda, dtype, B, Sq, Skv):
    """K2 without the causal mask at whisper-base's widths (8 heads, 8 kv
    heads, hd 64): the encoder's self-attention over its 1500 frames, and
    the decoder's cross-attention of a pass (Sq tokens) and of a decode
    step (one query) over them."""
    H = KV = 8
    hd = 64
    q, k, v = _randn(28, [(B, Sq, H, hd), (B, Skv, KV, hd),
                          (B, Skv, KV, hd)], dtype, cuda)
    before = flash_ops.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, causal=False)
    ref = flash_ops.flash_attention(q, k, v, causal=False, impl="reference")
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **CROSS_TOL[dtype])
    assert torch.equal(flash_ops.flash_attention(q, k, v, causal=False), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,window", [(1, 1, 0), (37, 37, 0),
                                           (300, 300, 0), (64, 300, 0),
                                           (130, 130, 48)])
def test_flash_kernel_hd160(cuda, dtype, Sq, Skv, window):
    """K2 at stablelm-12b's attention widths (32 q heads on 8 kv heads, hd
    160, laid out at 192 in shared memory): the zero-filled columns past
    160 change nothing, and a second launch gives the same bits."""
    B, H, KV, hd = 2, 32, 8, 160
    q, k, v = _randn(29, [(B, Sq, H, hd), (B, Skv, KV, hd),
                          (B, Skv, KV, hd)], dtype, cuda)
    out = flash_ops.flash_attention(q, k, v, window=window)
    ref = flash_ops.flash_attention(q, k, v, window=window, impl="reference")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(flash_ops.flash_attention(q, k, v, window=window), out)


def test_flash_kernel_rejects_what_tma_cannot_read(cuda):
    """A GQA group larger than a unit's rows (64 at hd 256), and a row
    stride that is not a multiple of 16 bytes, raise (no fallback); a
    group of exactly 64 at hd 256 runs."""
    q, k, v = _randn(26, [(1, 16, 65, 256), (1, 16, 1, 256),
                          (1, 16, 1, 256)], torch.bfloat16, cuda)
    before = flash_ops.LAUNCHES
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v)           # G = 65
    assert flash_ops.LAUNCHES == before
    out = flash_ops.flash_attention(q[:, :, :64], k, v)
    ref = flash_ops.flash_attention(q[:, :, :64], k, v, impl="reference")
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    wide, k, v = _randn(27, [(2, 16, 4, 65), (2, 16, 2, 64), (2, 16, 2, 64)],
                        torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(wide[..., :64], k, v)   # 130-byte rows


# ---------------------------------------------------------------------------
# K2's chunked-prefill entry (the continuous batcher's prefill steps)
# ---------------------------------------------------------------------------


def _chunk_case(seed, B, T, H, KV, hd, Smax, lengths, dtype, device, norm):
    """Projections, caches, norm scales, lengths and RoPE tables of one
    chunked step (rope_theta 1e6, positions lengths - T + t)."""
    q, k, v, ck, cv, w = _randn(seed, [
        (B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd), (B, Smax, KV, hd),
        (B, Smax, KV, hd), (2, hd)], dtype, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    pos = lens[:, None] - T + torch.arange(T, dtype=torch.int32,
                                           device=device)[None]
    cos, sin = rope_cos_sin(pos, hd, 1e6)
    norms = (1 + 0.2 * w[0], 1 + 0.2 * w[1]) if norm else (None, None)
    return (q, k, v, ck, cv, lens), dict(q_norm=norms[0], k_norm=norms[1],
                                         eps=1e-6, cos=cos, sin=sin), pos


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _check_chunked(args, kw, pos, dtype):
    """The kernels against the plain version on clones of the caches:
    outputs and caches within TOL and, in bf16, CHUNK_REL_TOL, queries
    before position 0 exactly 0, the v cache equal; one chunked call
    counted as its two launches, K2's own count unchanged."""
    q, k, v, ck, cv, lens = args
    kc, vc, kr, vr = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    before = (flash_ops.LAUNCHES, flash_ops.CHUNKED_LAUNCHES)
    out = flash_ops.chunked_attention(q, k, v, kc, vc, lens, **kw)
    assert (flash_ops.LAUNCHES, flash_ops.CHUNKED_LAUNCHES) == (
        before[0], before[1] + 2)
    ref = flash_ops.chunked_attention(q, k, v, kr, vr, lens, **kw,
                                      impl="reference")
    torch.cuda.synchronize()
    assert flash_ops.CHUNKED_LAUNCHES == before[1] + 2
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert not out[pos < 0].any()
    torch.testing.assert_close(kc.float(), kr.float(), **TOL[dtype])
    torch.testing.assert_close(vc, vr, rtol=0, atol=0)
    if dtype == torch.bfloat16:
        assert _rel_l2(out, ref) <= CHUNK_REL_TOL
        assert _rel_l2(kc, kr) <= CHUNK_REL_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_chunked_kernel(cuda, dtype, norm, hd, G):
    """The chunked entry (prologue: qk-norm, RoPE, cache append; attention
    with per-row query offsets) against its plain version: T = 32 over 64
    slots, rows of lengths 0 (a free slot), 17 (queries before position
    0), 45 and 84 (the chunk overruns the cache)."""
    args, kw, pos = _chunk_case(40 + hd + G, 4, 32, 2 * G, 2, hd, 64,
                                [0, 17, 45, 84], dtype, cuda, norm)
    _check_chunked(args, kw, pos, dtype)


@pytest.mark.parametrize("H,KV,hd,norm,nb", [
    (64, 8, 128, True, 1), (64, 8, 128, True, 8), (64, 8, 128, True, 64),
    (32, 8, 128, False, 8), (32, 8, 160, False, 8)])
def test_chunked_kernel_cell_shapes(cuda, H, KV, hd, norm, nb):
    """The served chunked step as the batcher gives it (B 8, T 32 over nb
    blocks of 32 slots; free slots at lengths T, rows ragged, one chunk
    past the view's end) at qwen3-32b's heads (64 q, 8 kv, hd 128,
    qk-norm), proxy-8b's (32 q, 8 kv, hd 128) and stablelm-12b's (hd
    160), both without a norm."""
    S = 32 * nb
    lengths = [32, 32, S, max(S - 5, 32), min(77, S + 3), S + 31,
               max(S // 2, 32), 40]
    args, kw, pos = _chunk_case(50 + nb + hd, 8, 32, H, KV, hd, S, lengths,
                                torch.bfloat16, cuda, norm)
    _check_chunked(args, kw, pos, torch.bfloat16)


def test_chunked_prefill_step_does_not_sync(cuda):
    """A chunked decode call of a bf16 model with qk-norm (qwen3-32b's
    smoke layers at hd 128) runs without a host synchronisation: CUDA's
    sync debug mode set to "error" raises at any (a boolean index, a
    ``nonzero``, an ``item``)."""
    cfg = dataclasses.replace(cfgs.get_smoke_config("qwen3-32b"),
                              head_dim=128)
    model = model_zoo.build(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_params(gen)
    B, T = 4, 32
    toks = torch.randint(4, cfg.vocab_size, (B, T), generator=gen,
                         device=cuda)
    cache = model.init_cache(B, 128, device=cuda)
    cache["len"] = torch.tensor([0, 5, 64, 100], dtype=torch.int32,
                                device=cuda)
    pos = cache["len"][:, None] + torch.arange(T, dtype=torch.int32,
                                               device=cuda)[None]
    batch = {"tokens": toks, "positions": pos}
    model.apply(params, batch, mode="decode", cache=cache)   # build, warm
    cache["len"] = pos[:, 0].contiguous()
    torch.cuda.synchronize()
    n = flash_ops.CHUNKED_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.apply(params, batch, mode="decode", cache=cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["chunked_layers"] == cfg.num_layers
    assert flash_ops.CHUNKED_LAUNCHES - n == 2 * cfg.num_layers
    with pytest.raises(RuntimeError):     # the plain path's write syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            with attention.use_flash_impl("reference"):
                model.apply(params, batch, mode="decode", cache=cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("arch", ["qwen3-32b", "proxy-8b", "oracle-70b",
                                  "command-r-35b", "minitron-8b",
                                  "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b",
                                  "stablelm-12b"])
def test_zoo_chunked_prefill_through_the_kernel(cuda, arch):
    """The batcher's models in fp32 at head_dim 64 (stablelm-12b at 160):
    a chunked decode step (T = 32, rows at lengths 32, 45 and 72 over 64
    slots) runs the chunked entry once a layer (two launches, and the
    forward counts the layer), and its hidden states and caches equal the
    plain path's within 2e-4."""
    cfg = dataclasses.replace(cfgs.get_smoke_config(arch), dtype="float32",
                              head_dim=160 if arch == "stablelm-12b" else 64)
    model = model_zoo.build(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_params(gen)
    B, T, Smax = 3, 32, 64
    toks = torch.randint(4, cfg.vocab_size, (B, T), generator=gen,
                         device=cuda)
    lens = torch.tensor([0, 13, 40], dtype=torch.int32, device=cuda)
    start = model.init_cache(B, Smax, device=cuda)
    for c in start["periods"].values():
        for leaf in c.values():
            leaf.normal_(generator=gen)

    def run(reference):
        cache = clone_tree(start)
        cache["len"] = lens.clone()
        pos = lens[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=cuda)[None]
        ctx = (attention.use_flash_impl("reference") if reference
               else contextlib.nullcontext())
        n = flash_ops.CHUNKED_LAUNCHES
        with ctx:
            out = model.apply(params, {"tokens": toks, "positions": pos},
                              mode="decode", cache=cache)
        return out, flash_ops.CHUNKED_LAUNCHES - n

    (out, n), (ref, n_ref) = run(False), run(True)
    torch.cuda.synchronize()
    assert (n, n_ref) == (2 * cfg.num_layers, 0)
    assert (out["chunked_layers"], ref["chunked_layers"]) == (
        cfg.num_layers, 0)
    torch.testing.assert_close(out["hidden"], ref["hidden"],
                               **TOL[torch.float32])
    for name, c in out["cache"]["periods"].items():
        for leaf in c:
            torch.testing.assert_close(
                c[leaf], ref["cache"]["periods"][name][leaf],
                **TOL[torch.float32])


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


# ---------------------------------------------------------------------------
# K4: RG-LRU scan; K5: RWKV-6 scan
# ---------------------------------------------------------------------------


def _decays(seed, shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.sigmoid(torch.randn(shape, generator=g, device=device) + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(3, 37, 300), (8, 384, 4096), (5, 1, 64),
                                   (1, 9, 1000), (1, 2560, 4096),
                                   (1, 300, 4096), (2, 0, 64), (2, 45, 37)])
def test_rglru_kernel(cuda, dtype, B, S, W):
    a = _decays(22, (B, S, W), cuda).to(dtype)
    b, h0 = _randn(23, [(B, S, W), (B, W)], dtype, cuda)
    h0 = h0.float()
    before = rglru_ops.LAUNCHES
    hs, hT = rglru_ops.rglru_scan(a, b, h0)
    ref_hs, ref_hT = rglru_ops.rglru_scan(a, b, h0, impl="reference")
    torch.cuda.synchronize()
    assert rglru_ops.LAUNCHES == before + 1
    assert hs.dtype == hT.dtype == torch.float32
    assert torch.equal(hs, ref_hs) and torch.equal(hT, ref_hT)


def test_rglru_kernel_unaligned_base(cuda):
    """a and b contiguous but 4 bytes past a 16-byte boundary: the ring
    copies them element by element, with the same bits."""
    B, S, W = 2, 70, 512
    a = _decays(27, (B * S * W + 1,), cuda)[1:].view(B, S, W)
    b = _randn(28, [(B * S * W + 1,)], torch.float32, cuda)[0][1:].view(
        B, S, W)
    h0 = _randn(29, [(B, W)], torch.float32, cuda)[0]
    assert a.data_ptr() % 16 and a.is_contiguous()
    hs, hT = rglru_ops.rglru_scan_cuda(a, b, h0)
    ref_hs, ref_hT = rglru_ops.rglru_scan(a, b, h0, impl="reference")
    torch.cuda.synchronize()
    assert torch.equal(hs, ref_hs) and torch.equal(hT, ref_hT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(3, 37, 300), (2, 384, 4096),
                                   (1, 2560, 4096), (5, 1, 64), (1, 9, 1000),
                                   (2, 0, 64), (2, 45, 37)])
@pytest.mark.parametrize("needs", [(True, True, True), (False, True, False),
                                   (True, False, True)])
def test_rglru_reverse_kernel(cuda, dtype, B, S, W, needs):
    """K4 in reverse against the plain reverse, bit for bit, with da, db
    or dh0 left out in turn (the outputs left out are None)."""
    a = _decays(52, (B, S, W), cuda).to(dtype)
    b, d_hs = _randn(53, [(B, S, W)] * 2, dtype, cuda)
    h0, d_hT = _randn(54, [(B, W)] * 2, torch.float32, cuda)
    hs, _ = rglru_ops.rglru_scan(a, b, h0)
    before = (rglru_ops.LAUNCHES, rglru_ops.REVERSE_LAUNCHES)
    got = rglru_ops.rglru_scan_bwd_cuda(a, hs, h0, d_hs.float(), d_hT, needs)
    want = rglru_scan_bwd_ref(a, hs, h0, d_hs.float(), d_hT)
    torch.cuda.synchronize()
    assert (rglru_ops.LAUNCHES, rglru_ops.REVERSE_LAUNCHES) == (
        before[0], before[1] + 1)
    for i, (g, w, n) in enumerate(zip(got, want, needs)):
        if not n:
            assert g is None
            continue
        assert g.dtype == (torch.float32 if i == 2 else dtype)
        assert torch.equal(g, w)


def _rwkv(seed, B, S, H, hd, dtype, device):
    r, k, v = _randn(seed, [(B, S, H, hd)] * 3, dtype, device)
    u, s0 = _randn(seed + 1, [(H, hd), (B, H, hd, hd)], torch.float32,
                   device)
    return r, k, v, _decays(seed + 2, (B, S, H, hd), device), u * 0.1, s0


def _close_rel(x, ref, tol=2e-4):
    scale = max(1.0, float(ref.abs().max()))
    assert float((x - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [(3, 37, 5, 64), (8, 384, 32, 64),
                                      (2, 19, 3, 16), (1, 1, 32, 64),
                                      (2, 20, 7, 16), (2, 45, 3, 16)])
def test_rwkv6_kernel(cuda, dtype, B, S, H, hd):
    args = _rwkv(24, B, S, H, hd, dtype, cuda)
    before = rwkv_ops.LAUNCHES
    o, sT = rwkv_ops.rwkv6_scan(*args)
    ref_o, ref_sT = rwkv_ops.rwkv6_scan(*args, impl="reference")
    torch.cuda.synchronize()
    assert rwkv_ops.LAUNCHES == before + 1
    assert o.dtype == sT.dtype == torch.float32
    _close_rel(o, ref_o)
    _close_rel(sT, ref_sT)
    again = rwkv_ops.rwkv6_scan(*args)
    assert torch.equal(again[0], o) and torch.equal(again[1], sT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 37, 384, 385])
def test_rwkv6_kernel_underflowing_decays(cuda, dtype, S):
    """Decays made as the model makes them, w = exp(-exp(x)), with x up to
    5 so that some underflow to 0, and pad steps (w = 1, k = 0) at the
    end of one row: within 2e-4 of the largest plain value, finite, the
    pad steps leave the state as it was, and a second launch gives the
    same bits."""
    B, H, hd = 3, 4, 64
    r, k, v, _, u, s0 = _rwkv(27, B, S, H, hd, dtype, cuda)
    x, = _randn(28, [(B, S, H, hd)], torch.float32, cuda)
    w = torch.exp(-torch.exp(x.clamp(-6, 3) + 2 * (x > 1.5)))
    assert bool((w == 0).any()) or S == 1
    pad = max(1, S // 4)
    w[1, S - pad:] = 1.0
    k[1, S - pad:] = 0
    o, sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
    again = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
    ref_o, ref_sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0, impl="reference")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(sT).all())
    _close_rel(o, ref_o)
    _close_rel(sT, ref_sT)
    assert torch.equal(again[0], o) and torch.equal(again[1], sT)
    if S > pad:
        _, s_cut = rwkv_ops.rwkv6_scan(r[:, :S - pad], k[:, :S - pad],
                                       v[:, :S - pad], w[:, :S - pad], u, s0)
        _close_rel(sT[1], s_cut[1])


@pytest.mark.parametrize("S,cut", [(385, 192), (384, 31), (70, 33)])
def test_rwkv6_kernel_chained_across_paths(cuda, S, cut):
    """Two launches, the second from the first's state, equal one launch
    over the whole sequence, where the halves take the chunked path, the
    step path or one of each."""
    r, k, v, w, u, s0 = _rwkv(29, 2, S, 4, 64, torch.bfloat16, cuda)
    o, sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
    o1, s1 = rwkv_ops.rwkv6_scan(r[:, :cut], k[:, :cut], v[:, :cut],
                                 w[:, :cut], u, s0)
    o2, s2 = rwkv_ops.rwkv6_scan(r[:, cut:], k[:, cut:], v[:, cut:],
                                 w[:, cut:], u, s1)
    _close_rel(torch.cat([o1, o2], 1), o)
    _close_rel(s2, sT)


def test_rwkv6_kernel_state_chaining(cuda):
    """Two launches over the halves, the second from the first's state,
    equal one launch over the whole sequence."""
    r, k, v, w, u, s0 = _rwkv(25, 2, 64, 4, 64, torch.float32, cuda)
    o, sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
    o1, s1 = rwkv_ops.rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], w[:, :32],
                                 u, s0)
    o2, s2 = rwkv_ops.rwkv6_scan(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:],
                                 u, s1)
    _close_rel(torch.cat([o1, o2], 1), o)
    _close_rel(s2, sT)


def test_scan_kernels_reject_unsupported(cuda):
    r, k, v, w, u, s0 = _rwkv(26, 1, 4, 2, 128, torch.float32, cuda)
    with pytest.raises(ValueError):
        rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)           # hd 128
    a = w[:, :, 0].half()                                 # [B,S,W] fp16
    with pytest.raises(TypeError):
        rglru_ops.rglru_scan(a, a, s0[:, 0, 0])
    with pytest.raises(ValueError):
        rglru_ops.rglru_scan(w, w, s0[:, 0, 0])           # not [B,S,W]


# ---------------------------------------------------------------------------
# gradients through K2, K4 and K5: each wrapper's autograd.Function
# launches the kernel forward; K2's and K5's backward recompute the plain
# version, K4's runs the kernel in reverse
# ---------------------------------------------------------------------------


def _grads(fn, inputs, seed):
    """Outputs of fn(*inputs) and the inputs' gradients against seeded
    output gradients."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gos = _randn(seed, [o.shape for o in outs], torch.float32,
                 outs[0].device)
    gos = [g.to(o.dtype) for g, o in zip(gos, outs)]
    return outs, torch.autograd.grad(outs, inputs, gos)


def _leaves(*ts):
    return [t.detach().requires_grad_() for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 160, 256])
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (70, 70, True, 0), (130, 130, True, 48), (45, 200, False, 0),
    (1100, 1100, True, 1000)])
def test_flash_kernel_grads(cuda, dtype, hd, Sq, Skv, causal, window):
    """Where q, k or v requires grad K2's output carries a grad_fn; the
    backward recomputes the plain version (over blocks of BACKWARD_ROWS
    query rows, so Sq 1100 takes two, each at its own query offset) and
    gives the plain path's gradients within the kernel's tolerance."""
    B, KV, G = 2, 2, 4
    q, k, v = _randn(31, [(B, Sq, KV * G, hd), (B, Skv, KV, hd),
                          (B, Skv, KV, hd)], dtype, cuda)
    before = flash_ops.LAUNCHES
    kern = _leaves(q, k, v)
    (out,), grads = _grads(lambda *t: flash_ops.flash_attention(
        *t, causal=causal, window=window), kern, 32)
    assert out.grad_fn is not None
    assert flash_ops.LAUNCHES == before + 1
    (ref,), ref_grads = _grads(lambda *t: flash_ops.flash_attention(
        *t, causal=causal, window=window, impl="reference"),
        _leaves(q, k, v), 32)
    torch.cuda.synchronize()
    assert flash_ops.LAUNCHES == before + 1
    for g, r in zip(grads, ref_grads):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), r.float(), **TOL[dtype])


def test_kernels_launch_without_autograd(cuda):
    """No input requiring grad (or under no_grad): the wrappers launch the
    kernel directly and the outputs carry no grad_fn."""
    q, = _randn(33, [(1, 40, 4, 64)], torch.bfloat16, cuda)
    a = _decays(34, (1, 40, 64), cuda)
    r, k, v, w, u, s0 = _rwkv(35, 1, 40, 2, 64, torch.bfloat16, cuda)
    outs = [flash_ops.flash_attention(q, q, q),
            *rglru_ops.rglru_scan(a, a, a[:, 0]),
            *rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)]
    with torch.no_grad():
        qg = q.detach().requires_grad_()
        outs.append(flash_ops.flash_attention(qg, q, q))
    assert all(o.grad_fn is None for o in outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(3, 37, 300), (2, 384, 4096),
                                   (1, 2560, 4096)])
def test_rglru_kernel_grads(cuda, dtype, B, S, W, monkeypatch):
    """The backward is K4 in reverse: one reverse launch, no run of the
    plain version (forward or reverse), autograd's bits."""
    a = _decays(36, (B, S, W), cuda).to(dtype)
    b, h0 = _randn(37, [(B, S, W), (B, W)], dtype, cuda)
    h0 = h0.float()
    before = rglru_ops.LAUNCHES
    reverse = rglru_ops.REVERSE_LAUNCHES

    def plain(*args, **kw):
        raise AssertionError("the kernel path ran the plain version")

    with monkeypatch.context() as m:
        m.setattr(rglru_ops, "rglru_scan_ref", plain)
        m.setattr(rglru_ops, "rglru_scan_bwd_ref", plain)
        outs, grads = _grads(rglru_ops.rglru_scan, _leaves(a, b, h0), 38)
    assert all(o.grad_fn is not None for o in outs)
    assert rglru_ops.LAUNCHES == before + 1
    assert rglru_ops.REVERSE_LAUNCHES == reverse + 1
    _, ref_grads = _grads(lambda *t: rglru_ops.rglru_scan(
        *t, impl="reference"), _leaves(a, b, h0), 38)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref_grads):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,hd", [(3, 37, 5, 64), (2, 96, 32, 64),
                                      (2, 19, 3, 16)])
def test_rwkv6_kernel_grads(cuda, dtype, B, S, H, hd):
    args = _leaves(*_rwkv(39, B, S, H, hd, dtype, cuda))
    before = rwkv_ops.LAUNCHES
    outs, grads = _grads(rwkv_ops.rwkv6_scan, args, 40)
    assert all(o.grad_fn is not None for o in outs)
    assert rwkv_ops.LAUNCHES == before + 1
    _, ref_grads = _grads(lambda *t: rwkv_ops.rwkv6_scan(
        *t, impl="reference"), _leaves(*args), 40)
    torch.cuda.synchronize()
    for g, r in zip(grads, ref_grads):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def _named(tree, prefix=""):
    """(path, tensor) pairs in the order of ``optim.leaves``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in _named(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _remat_launches(cfg):
    """K2, K4, K5 launches of one loss_fn backward with remat: twice for
    each layer whose period runs under activation checkpointing (its
    forward and the recompute), once for the tail's layers and whisper's
    encoder layers, which do not; K4's reverse once for every RG-LRU
    layer (its backward)."""
    if cfg.is_encoder_decoder:
        return {"flash": cfg.encoder_layers + 2 * 2 * cfg.num_layers,
                "rglru": 0, "rwkv": 0, "rglru_bwd": 0}
    n_body = cfg.num_periods * len(cfg.period)
    got = {"flash": 0, "rglru": 0, "rwkv": 0,
           "rglru_bwd": cfg.block_pattern.count(cfgs.RGLRU)}
    kernel = {cfgs.ATTN: "flash", cfgs.LOCAL_ATTN: "flash",
              cfgs.RGLRU: "rglru", cfgs.RWKV: "rwkv"}
    for layer, blk in enumerate(cfg.block_pattern):
        got[kernel[blk]] += 2 if layer < n_body else 1
    return got


@pytest.mark.parametrize("arch", ["proxy-8b", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "whisper-base"])
def test_smoke_model_grads_through_kernels(cuda, arch):
    """loss_fn's gradients of the fp32 smoke model (head_dim 64 where K2
    runs) through the kernels, against the plain path's, every leaf
    within 2e-4 of its largest plain value and nonzero (whisper's key
    biases, whose gradient is zero in exact arithmetic, within 2e-4 of
    the model's largest); the kernels
    launch as remat says (``_remat_launches``; K4's reverse once a
    RG-LRU layer), the plain path none.  S = 40 is past recurrentgemma's
    window of 32."""
    from repro_torch.train import optim as toptim
    from repro_torch.train import train_step as tstep
    cfg = dataclasses.replace(cfgs.get_smoke_config(arch), dtype="float32")
    if arch != "rwkv6-1.6b":
        cfg = dataclasses.replace(cfg, head_dim=64)
    model = model_zoo.build(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    B, S = 2, 40
    batch = {"tokens": torch.randint(4, cfg.vocab_size, (B, S),
                                     generator=gen, device=cuda),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, device=cuda)}
    if cfg.frontend == "frames":
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=cuda)

    def counts():
        return {"flash": flash_ops.LAUNCHES, "rglru": rglru_ops.LAUNCHES,
                "rwkv": rwkv_ops.LAUNCHES,
                "rglru_bwd": rglru_ops.REVERSE_LAUNCHES}

    def run(reference):
        ctx = contextlib.ExitStack()
        if reference:
            ctx.enter_context(blocks.use_scan_impl("reference"))
            ctx.enter_context(attention.use_flash_impl("reference"))
        with ctx:
            before = counts()
            loss, _, grads = tstep.make_grad_fn(model)(params, batch)
            torch.cuda.synchronize()
            return loss, grads, {k: v - before[k]
                                 for k, v in counts().items()}

    loss, grads, launched = run(False)
    ref_loss, ref_grads, ref_launched = run(True)
    assert launched == _remat_launches(cfg)
    assert sum(launched.values()) > 0
    assert set(ref_launched.values()) == {0}
    torch.testing.assert_close(loss, ref_loss, rtol=2e-4, atol=0)
    top = max(float(r.abs().max()) for r in toptim.leaves(ref_grads))
    for (name, g), r in zip(_named(grads), toptim.leaves(ref_grads)):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
        if name.endswith("/bk"):
            # zero in exact arithmetic (softmax ignores a shift of every
            # logit of a query): both sides are rounding
            assert max(float(g.abs().max()), float(r.abs().max())) \
                <= 2e-4 * top, name
        else:
            assert float((g - r).abs().max()) <= 2e-4 * float(
                r.abs().max()), name


# The gradient mechanics of the three Functions on the CPU, in float64,
# with the plain version standing in for the kernel's launch (a stand-in
# only these tests pass: the wrappers pass the kernel).


def _flash_stand_in(q, k, v, *, causal, window):
    return flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window,
        sm_scale=flash_ops.sm_scale_of(q.shape[-1])).transpose(1, 2)


def _f64(seed, shapes, positive=()):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        x = rng.random(s) if i in positive else rng.standard_normal(s)
        out.append(torch.from_numpy(x).requires_grad_())
    return out


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (7, 7, True, 0), (7, 7, True, 3), (5, 9, False, 0), (5, 9, True, 0),
    (6, 11, True, 4)])
def test_flash_autograd_function_gradcheck(Sq, Skv, causal, window):
    """Blocks of 2 query rows, so every block but the first recomputes at
    a query offset of its own."""
    q, k, v = _f64(41, [(2, Sq, 4, 8), (2, Skv, 2, 8), (2, Skv, 2, 8)])
    assert torch.autograd.gradcheck(
        lambda *t: flash_ops.FlashAttentionFn.apply(
            _flash_stand_in, *t, causal, window, flash_ops.sm_scale_of(8),
            2), (q, k, v))


def test_rglru_autograd_function_gradcheck():
    a, b, h0 = _f64(42, [(2, 5, 3), (2, 5, 3), (2, 3)], positive=(0,))
    assert torch.autograd.gradcheck(
        lambda *t: rglru_ops.RglruScanFn.apply(rglru_scan_ref, *t),
        (a, b, h0))


def test_rwkv6_autograd_function_gradcheck():
    args = _f64(43, [(1, 4, 2, 3)] * 4 + [(2, 3), (1, 2, 3, 3)],
                positive=(3,))
    assert torch.autograd.gradcheck(
        lambda *t: rwkv_ops.Rwkv6ScanFn.apply(rwkv6_scan_ref, *t), args)


# ---------------------------------------------------------------------------
# the recurrent smoke models on the card: every scan and attention through
# its kernel, counted, and held to the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b"])
def test_recurrent_smoke_model_through_kernels(cuda, arch):
    """The smoke model in fp32 (recurrentgemma at head_dim 64, which K1
    and K2 take): a ragged prefill longer than the window of 32, then
    decode steps past the ring's wrap.  Each pass launches K5 once per
    RWKV layer, K4 once per RG-LRU layer and K2 once per sliding-window
    layer; each decode step K5 per RWKV layer and K1 per sliding-window
    layer (RG-LRU decode is elementwise).  Logits equal the plain path's
    (every scan and attention through its plain version) within 2e-4."""
    cfg = cfgs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32",
                              head_dim=64 if cfg.attention_window else
                              cfg.head_dim)
    model = model_zoo.build(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_params(gen)
    n_rwkv = cfg.block_pattern.count(cfgs.RWKV)
    n_lru = cfg.block_pattern.count(cfgs.RGLRU)
    n_local = cfg.block_pattern.count(cfgs.LOCAL_ATTN)
    B, S = 2, 40
    toks = torch.randint(4, cfg.vocab_size, (B, S), generator=gen,
                         device=cuda)
    lens = torch.tensor([40, 29], dtype=torch.int32, device=cuda)

    def counts():
        return (rwkv_ops.LAUNCHES, rglru_ops.LAUNCHES, flash_ops.LAUNCHES,
                dec_ops.LAUNCHES)

    def serve(reference):
        ctx = contextlib.ExitStack()
        if reference:
            ctx.enter_context(blocks.use_scan_impl("reference"))
            ctx.enter_context(attention.use_flash_impl("reference"))
            ctx.enter_context(attention.use_decode_impl("reference"))
        with ctx:
            cache = model.init_cache(B, 64, device=cuda)
            before = counts()
            out = model.apply(params, {"tokens": toks, "lengths": lens},
                              mode="prefill", cache=cache)
            logits = [model.logits_of(params, out["last_hidden"])]
            got = [tuple(a - b for a, b in zip(counts(), before))]
            for step in range(6):
                before = counts()
                nxt = toks[:, step:step + 1]
                out = model.apply(params, {"tokens": nxt}, mode="decode",
                                  cache=cache)
                logits.append(model.logits_of(params, out["hidden"][:, 0]))
                got.append(tuple(a - b for a, b in zip(counts(), before)))
        return logits, got

    logits, got = serve(False)
    ref, ref_got = serve(True)
    torch.cuda.synchronize()
    assert got[0] == (n_rwkv, n_lru, n_local, 0)
    assert all(g == (n_rwkv, 0, 0, n_local) for g in got[1:])
    assert all(g == (0, 0, 0, 0) for g in ref_got)
    for a, b in zip(logits, ref):
        torch.testing.assert_close(a, b, **TOL[torch.float32])


@pytest.mark.parametrize("arch", ["qwen3-32b", "command-r-35b",
                                  "minitron-8b", "phi3.5-moe-42b-a6.6b",
                                  "qwen2-moe-a2.7b", "stablelm-12b"])
def test_zoo_smoke_model_through_kernels(cuda, arch):
    """The zoo's smoke models with qk-norm, parallel blocks and mixtures
    of experts in fp32, at head_dim 64 (160 for stablelm-12b, its full
    head dim; K1 and K2 take 64, 128, 160, 256): a ragged prefill launches
    K2 once a layer, each decode step K1 once a layer, and logits and the
    MoE aux loss equal the plain path's (every attention through its
    plain version) within 2e-4."""
    cfg = dataclasses.replace(cfgs.get_smoke_config(arch), dtype="float32",
                              head_dim=160 if arch == "stablelm-12b" else 64)
    model = model_zoo.build(cfg)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init_params(gen)
    L = cfg.num_layers
    B, S = 2, 40
    toks = torch.randint(4, cfg.vocab_size, (B, S), generator=gen,
                         device=cuda)
    lens = torch.tensor([40, 29], dtype=torch.int32, device=cuda)

    def serve(reference):
        ctx = contextlib.ExitStack()
        if reference:
            ctx.enter_context(attention.use_flash_impl("reference"))
            ctx.enter_context(attention.use_decode_impl("reference"))
        with ctx:
            cache = model.init_cache(B, 64, device=cuda)
            before = (flash_ops.LAUNCHES, dec_ops.LAUNCHES)
            out = model.apply(params, {"tokens": toks, "lengths": lens},
                              mode="prefill", cache=cache)
            logits = [model.logits_of(params, out["last_hidden"])]
            aux = [out["aux"]]
            got = [(flash_ops.LAUNCHES - before[0],
                    dec_ops.LAUNCHES - before[1])]
            for step in range(4):
                before = (flash_ops.LAUNCHES, dec_ops.LAUNCHES)
                out = model.apply(params, {"tokens": toks[:, step:step + 1]},
                                  mode="decode", cache=cache)
                logits.append(model.logits_of(params, out["hidden"][:, 0]))
                aux.append(out["aux"])
                got.append((flash_ops.LAUNCHES - before[0],
                            dec_ops.LAUNCHES - before[1]))
        return logits, aux, got

    logits, aux, got = serve(False)
    ref, ref_aux, ref_got = serve(True)
    torch.cuda.synchronize()
    assert got[0] == (L, 0) and all(g == (0, L) for g in got[1:])
    assert all(g == (0, 0) for g in ref_got)
    for a, b in zip(logits, ref):
        torch.testing.assert_close(a, b, **TOL[torch.float32])
    for a, b in zip(aux, ref_aux):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert (float(aux[0]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-7b"])
def test_multimodal_smoke_model_through_kernels(cuda, arch):
    """whisper-base and qwen2-vl-7b smoke models in fp32 at head_dim 64
    (qwen2-vl's M-RoPE sections scaled to 8 / 12 / 12 of its 32 rotary
    pairs), fed the engine's front-end inputs: whisper's prefill launches
    K2 for each encoder layer and twice for each decoder layer (causal
    self-attention, non-causal cross-attention), each decode step K1 and
    K2 (one query over the 32 frames) once a decoder layer; qwen2-vl's
    prefill over 16 patches + the text launches K2 once a layer, each
    decode step K1 once a layer.  Logits equal the plain path's within
    2e-4."""
    from repro_torch.inference.engine import TorchInferenceEngine
    cfg = dataclasses.replace(cfgs.get_smoke_config(arch), dtype="float32",
                              head_dim=64)
    if cfg.mrope_sections:
        cfg = dataclasses.replace(cfg, mrope_sections=(8, 12, 12))
    eng = TorchInferenceEngine(cfg, device="cuda", max_seq=64)
    model, params = eng.model, eng.params
    L = cfg.num_layers
    B, S = 2, 40
    gen = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(4, cfg.vocab_size, (B, S), generator=gen,
                         device=cuda)
    lens = torch.tensor([40, 29], dtype=torch.int32, device=cuda)
    from repro_torch.inference.backend import COMPLETE, Request
    extra = eng._modality_batch([Request(f"clip {i}", cfg.name, COMPLETE)
                                 for i in range(B)], B, S)
    per_pass = (cfg.encoder_layers + 2 * L, 0) if cfg.is_encoder_decoder \
        else (L, 0)
    per_step = (L, L) if cfg.is_encoder_decoder else (0, L)

    def serve(reference):
        ctx = contextlib.ExitStack()
        if reference:
            ctx.enter_context(attention.use_flash_impl("reference"))
            ctx.enter_context(attention.use_decode_impl("reference"))
        with ctx:
            cache = model.init_cache(B, 80, device=cuda)
            before = (flash_ops.LAUNCHES, dec_ops.LAUNCHES)
            out = model.apply(params, {"tokens": toks, "lengths": lens,
                                       **extra}, mode="prefill", cache=cache)
            logits = [model.logits_of(params, out["last_hidden"])]
            got = [(flash_ops.LAUNCHES - before[0],
                    dec_ops.LAUNCHES - before[1])]
            for step in range(4):
                before = (flash_ops.LAUNCHES, dec_ops.LAUNCHES)
                out = model.apply(params, {"tokens": toks[:, step:step + 1]},
                                  mode="decode", cache=cache)
                logits.append(model.logits_of(params, out["hidden"][:, 0]))
                got.append((flash_ops.LAUNCHES - before[0],
                            dec_ops.LAUNCHES - before[1]))
        return logits, got

    logits, got = serve(False)
    ref, ref_got = serve(True)
    torch.cuda.synchronize()
    assert got[0] == per_pass and all(g == per_step for g in got[1:])
    assert all(g == (0, 0) for g in ref_got)
    for a, b in zip(logits, ref):
        torch.testing.assert_close(a, b, **TOL[torch.float32])


# ---------------------------------------------------------------------------
# K3: similarity top-k
# ---------------------------------------------------------------------------


def _check_topk(q, c, k):
    """K3 against its plain version: values within TOPK_TOL, ids equal but
    for flips between rows the plain version scores within TOPK_TOL;
    a second launch gives the same bits."""
    before = topk_ops.LAUNCHES
    vals, idx = topk_ops.similarity_topk(q, c, k)
    rv, ri = topk_ops.similarity_topk(q, c, k + 1, impl="reference")
    torch.cuda.synchronize()
    assert topk_ops.LAUNCHES == before + 1
    assert vals.shape == idx.shape == (q.shape[0], k)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    torch.testing.assert_close(vals, rv[:, :k], rtol=0, atol=TOPK_TOL)
    flips = topk_flips(idx, rv, ri)
    assert all(f[-1] < TOPK_TOL for f in flips), flips
    again = topk_ops.similarity_topk(q, c, k)
    assert torch.equal(again[0], vals) and torch.equal(again[1], idx)
    return vals, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,N,D,k", [
    (13, 201, 48, 5), (32, 512, 64, 17), (1, 1000, 32, 1), (64, 64, 128, 64),
    (40, 3000, 64, 128),          # the fused path's largest k
    (5, 3000, 64, 129),           # the large path
    (3, 100_000, 32, 10),         # many corpus splits
])
def test_topk_kernel(cuda, dtype, Q, N, D, k):
    q, c = _randn(17, [(Q, D), (N, D)], dtype, cuda)
    _check_topk(q, c, k)


@pytest.mark.parametrize("N,k", [(4, 7), (150, 200), (1, 1)])
def test_topk_kernel_k_exceeds_corpus(cuda, N, k):
    q, c = _randn(18, [(3, 16), (N, 16)], torch.float32, cuda)
    vals, idx = _check_topk(q, c, k)
    assert (idx[:, N:] == -1).all() and torch.isneginf(vals[:, N:]).all()


def test_topk_kernel_sign_vector_ties(cuda):
    """Entries +-1 at D=16: every score is an exact multiple of 1/8, ties
    are everywhere, and only the tie rule orders them."""
    rng = np.random.default_rng(19)
    c = rng.choice([-1.0, 1.0], size=(700, 16)).astype(np.float32)
    c[300:320] = c[10]
    q = np.concatenate([rng.choice([-1.0, 1.0], size=(40, 16)), c[:4]])
    q, c = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (q, c))
    for k in (1, 8, 33, 128, 129, 700):
        vals, idx = topk_ops.similarity_topk(q, c, k)
        rv, ri = topk_ops.similarity_topk(q, c, k, impl="reference")
        assert torch.equal(idx, ri), k
        assert torch.equal(vals, rv), k


@pytest.mark.parametrize("Q,N,D,k", [
    (1, 100, 3, 1),               # N below one 128-row tile, D = 3
    (16, 1000, 100, 100),         # N not a multiple of the tile, D = 100
    (17, 3000, 1024, 128),        # Q past one 16-query block, D = 1024
    (1024, 5000, 64, 8),          # the 128-query block, on wgmma
    (300, 60000, 48, 32),         # 128-query block, columns past D zero
    (1024, 20000, 16, 4),         # 128-query block, one 32-column chunk
    (1024, 3000, 100, 32),        # D > 64: 16-query blocks, 4-byte copies
    (16, 300, 1024, 129),         # large path through the same tile
    (17, 129, 3, 129),            # large path, k = N
    (3, 50, 100, 100),            # k > N on the fused path
])
def test_topk_kernel_tensor_core_shapes(cuda, Q, N, D, k):
    """The 3xTF32 tiles and their rings at the edges of their shapes:
    ragged corpus tiles and 32-deep chunks, the 16- and 128-query blocks,
    both copy widths, both selection paths."""
    q, c = _randn(22, [(Q, D), (N, D)], torch.float32, cuda)
    vals, idx = _check_topk(q, c, k)
    if k > N:
        assert (idx[:, N:] == -1).all() and torch.isneginf(vals[:, N:]).all()


@pytest.mark.parametrize("Q,D,k", [(17, 100, 8), (1024, 64, 8),
                                   (16, 1024, 100), (5, 64, 200)])
def test_topk_kernel_duplicate_rows_tie_to_lower_index(cuda, Q, D, k):
    """Copies of a corpus row, spread over tiles and corpus splits, get
    bit-identical scores (a score depends only on its two rows), so the
    lower index always comes first."""
    rng = np.random.default_rng(23)
    N = 20_000
    c = rng.standard_normal((N, D)).astype(np.float32)
    src = rng.choice(N, size=Q, replace=False)
    for j, s in enumerate(src):                # three copies of each source
        for dst in (5003 * j + 7919, 13001 + 97 * j):
            c[dst % N] = c[s]
    q = c[src] + 0.05 * rng.standard_normal((Q, D)).astype(np.float32)
    q, c = (torch.from_numpy(x).to(cuda) for x in (q, c))
    vals, idx = _check_topk(q, c, k)
    rows = c.cpu().numpy()
    ids, got = idx.cpu().numpy(), vals.cpu().numpy()
    copies = 0
    for r in range(Q):
        seen = {}                              # row bytes -> (id, value)
        for i, v in zip(ids[r], got[r]):
            if i < 0:
                continue
            first = seen.setdefault(rows[i].tobytes(), (i, v))
            if first[0] != i:
                copies += 1
                assert first[0] < i and first[1] == v, (r, first, i, v)
    assert copies >= Q                 # the copies did reach the top k


@pytest.mark.parametrize("N,D,k", [(5000, 64, 8), (3000, 48, 32)])
def test_topk_kernel_scores_do_not_depend_on_the_batch(cuda, N, D, k):
    """A query's results are the same bits whether it comes in a batch of
    1024 (128-query blocks on wgmma), in batches of 16 (mma.sync), or
    against a corpus view that is not 16-byte aligned (mma.sync with
    4-byte copies): a score depends only on its two rows."""
    Q = 1024
    q, c = (topk_ops.l2_normalize(x)
            for x in _randn(28, [(Q, D), (N, D)], torch.float32, cuda))
    tiles = -(-N // topk_ops.BLOCK_N)
    assert topk_ops._block(cuda, Q, tiles, D, k, True)[0] == 128
    assert topk_ops._block(cuda, 16, tiles, D, k, True)[0] == 16
    assert topk_ops._block(cuda, Q, tiles, D, k, False)[0] == 16
    vals, idx = topk_ops.similarity_topk_cuda(q, c, k)
    parts = [topk_ops.similarity_topk_cuda(q[i:i + 16], c, k)
             for i in range(0, Q, 16)]
    assert torch.equal(torch.cat([p[0] for p in parts]), vals)
    assert torch.equal(torch.cat([p[1] for p in parts]), idx)
    shifted = torch.empty(N * D + 1, device=cuda)[1:].view(N, D)
    shifted.copy_(c)
    assert shifted.data_ptr() % 16
    sv, si = topk_ops.similarity_topk_cuda(q, shifted, k)
    assert torch.equal(sv, vals) and torch.equal(si, idx)


def test_index_launches_k3_per_search(cuda):
    rng = np.random.default_rng(20)
    vecs = rng.standard_normal((600, 32)).astype(np.float32)
    queries = rng.standard_normal((9, 32)).astype(np.float32)
    cfg = IvfConfig(nlist=8, nprobe=3)
    index = IvfFlatIndex(vecs, cfg, device="cuda")
    plain = IvfFlatIndex(vecs, IvfConfig(nlist=8, nprobe=3,
                                         impl="reference"), device="cuda")
    assert index.vectors.is_cuda
    before = topk_ops.LAUNCHES
    fv, fi = index.search_flat(queries, 10)
    assert topk_ops.LAUNCHES == before + 1
    pv, pi = plain.search_flat(queries, 10)
    np.testing.assert_array_equal(fi, pi)
    np.testing.assert_allclose(fv, pv, rtol=0, atol=TOPK_TOL)
    _, probe = plain._topk(plain._tensor(queries), plain._centroids, 3)
    cells = {int(c) for c in np.unique(probe) if len(index.cells[c])}
    before = topk_ops.LAUNCHES
    iv, ii = index.search(queries, 10)
    assert topk_ops.LAUNCHES == before + 1 + len(cells)
    jv, ji = plain.search(queries, 10)
    np.testing.assert_array_equal(ii, ji)
    np.testing.assert_allclose(iv, jv, rtol=0, atol=TOPK_TOL)
    mgr = SemanticIndexManager(SemIndexConfig())
    before = topk_ops.LAUNCHES
    cv, ci = mgr.topk_candidates(queries, vecs, 20)
    assert topk_ops.LAUNCHES == before + 1 and ci.dtype == np.int32
    np.testing.assert_array_equal(ci, plain.search_flat(queries, 20)[1])
