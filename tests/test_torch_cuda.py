"""The port's hand-written CUDA kernels held to their plain PyTorch
versions on the same tensors, on a CUDA device (skipped elsewhere: a CUDA
kernel has no CPU mode).  Imports no JAX, so it runs on a host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 2e-4 (summation
order differs), bf16 5e-2 (outputs round to bf16 at different points).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


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
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
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


def test_kernels_reject_unsupported(cuda):
    q, kc, vc = _randn(13, [(2, 1, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)],
                       torch.float32, cuda)
    with pytest.raises(ValueError):
        dec_ops.flash_decode(q, kc, vc, torch.tensor([1, 2], device=cuda))
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
