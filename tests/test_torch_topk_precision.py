"""The arithmetic of K3's 3xTF32 scores, emulated in plain PyTorch on the
CPU (``similarity_topk/ref.py``): the same rounding as ``cvt.rna.tf32``,
the remainder, the three products summed in fp32.  On seeded unit vectors
the emulated scores stay within 1e-6 of the fp64 dot product at the
index's widths, and plain TF32 (one product of the high parts) does not.
This is the tolerance the card is held to before it runs the kernel."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.similarity_topk.ref import (  # noqa: E402
    l2_normalize, scores_3xtf32, similarity_topk_ref, split_tf32,
    tf32_round, topk_flips)

TOL_3XTF32 = 1e-6


def _unit(seed, Q, N, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, D))
    c = rng.standard_normal((N, D))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q32, c32 = q.astype(np.float32), c.astype(np.float32)
    exact = q32.astype(np.float64) @ c32.astype(np.float64).T
    return torch.from_numpy(q32), torch.from_numpy(c32), exact


def test_tf32_round_is_nearest_ties_away():
    one_ulp = 2.0 ** -10                   # a TF32 unit at 1.0
    x = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, 1 + 3 * 2 ** -11, 0.0, -0.0,
                      float("inf")], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + one_ulp, -(1 + one_ulp), 1.0,
                         1 + 2 * one_ulp, 0.0, -0.0, float("inf")],
                        dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32)[:7] & 0x1FFF == 0).all()
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


def test_split_tf32_keeps_the_value():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()


@pytest.mark.parametrize("D", [64, 1024])
def test_3xtf32_scores_within_1e6_of_fp64(D):
    q, c, exact = _unit(2 + D, 64, 512, D)
    err = np.abs(scores_3xtf32(q, c).double().numpy() - exact).max()
    assert err < TOL_3XTF32, err


@pytest.mark.parametrize("D", [64, 1024])
def test_plain_tf32_scores_miss_1e6(D):
    """One product of the TF32 high parts: off by ~1e-4, which is why the
    kernel carries the remainders."""
    q, c, exact = _unit(2 + D, 64, 512, D)
    qh, _ = split_tf32(q)
    ch, _ = split_tf32(c)
    err = np.abs((qh @ ch.T).double().numpy() - exact).max()
    assert err > 10 * TOL_3XTF32, err


@pytest.mark.parametrize("D,k", [(64, 8), (1024, 100)])
def test_3xtf32_top_k_flips_only_near_ties(D, k):
    """The emulated scores' top-k against the plain version's: values
    within 1e-5 and ids equal but between rows whose plain scores lie
    within 1e-5, the gate the card holds the kernel to."""
    q, c, _ = _unit(3 + D, 16, 2048, D)
    s = scores_3xtf32(l2_normalize(q), l2_normalize(c))
    order = torch.sort(-s, dim=1, stable=True).indices[:, :k]
    vals = torch.gather(s, 1, order)
    rv, ri = similarity_topk_ref(q, c, k + 1)
    torch.testing.assert_close(vals, rv[:, :k], rtol=0, atol=1e-5)
    assert all(f[-1] < 1e-5 for f in topk_flips(order.to(torch.int32), rv,
                                                  ri))
