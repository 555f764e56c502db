"""The port's hand-written CUDA kernels held to their plain PyTorch
versions on the same tensors, on a CUDA device (skipped elsewhere: a CUDA
kernel has no CPU mode).  Imports no JAX, so it runs on a host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 2e-4 (summation
order differs), bf16 5e-2 (outputs round to bf16 at different points).
K4 (RG-LRU scan) is held to its plain version bit for bit (both round
the multiply and the add separately in fp32); K5 (RWKV-6 scan) within
2e-4 of the largest plain value (fp32 sums in another order).  K3
(similarity top-k) is held tighter: values within 1e-5, ids equal
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
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.kernels.similarity_topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.similarity_topk.ref import topk_flips  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.models import attention, blocks, model_zoo  # noqa: E402
from repro_torch.semindex import (IvfConfig, IvfFlatIndex,  # noqa: E402
                                  SemanticIndexManager, SemIndexConfig)

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
TOPK_TOL = 1e-5


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
@pytest.mark.parametrize("hd", [64, 128, 256])
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


@pytest.mark.parametrize("hd", [64, 128, 256])
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
# K4: RG-LRU scan; K5: RWKV-6 scan
# ---------------------------------------------------------------------------


def _decays(seed, shape, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.sigmoid(torch.randn(shape, generator=g, device=device) + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(3, 37, 300), (8, 384, 4096), (5, 1, 64),
                                   (1, 9, 1000)])
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
