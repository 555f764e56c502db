"""The gradient of K4 (RG-LRU scan) as the recurrence run in reverse.

On the CPU: the plain reverse ``rglru_scan_bwd_ref`` equals autograd of
the plain forward ``rglru_scan_ref`` bit for bit (each gradient is one
product and one sum of two terms, rounded apart, in both), and agrees
with ``jax.vjp`` of the JAX package's ``ref.py`` within the fp32
tolerance of ``tests/test_kernels.py`` (2e-4) on the same numpy inputs.
``RglruScanFn`` on CPU tensors runs its backward through the plain
reverse, skipping the gradients no input asks for.  The reverse kernel
itself is held to the plain reverse on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ref import rglru_scan_ref as j_rglru_ref  # noqa
from repro_torch.kernels.rglru_scan import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)

TOL = dict(rtol=2e-4, atol=2e-4)
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(2, 24, 256), (3, 13, 200), (1, 1, 64), (2, 0, 32)]


def _inputs(seed, B, S, W, dtype, zero_dhT):
    """a (decays in (0, 1)), b in ``dtype``; h0, d_hs, d_hT in fp32; as
    numpy arrays (a, b already rounded to ``dtype``)."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W)) - 2.0))
    b = rng.standard_normal((B, S, W))
    a, b = (torch.from_numpy(x.astype(np.float32)).to(TD[dtype]).float()
            .numpy() for x in (a, b))
    h0, d_hs, d_hT = (rng.standard_normal(s).astype(np.float32)
                      for s in ((B, W), (B, S, W), (B, W)))
    if zero_dhT:
        d_hT = np.zeros_like(d_hT)
    return a, b, h0, d_hs, d_hT


def _autograd(a, b, h0, d_hs, d_hT, dtype, needs=(True, True, True)):
    """Autograd of the plain forward: (da, db, dh0), None where not
    asked for, and the outputs."""
    ins = [torch.from_numpy(x).to(t).requires_grad_(n)
           for x, t, n in zip((a, b, h0), (TD[dtype], TD[dtype],
                                           torch.float32), needs)]
    hs, hT = rglru_scan_ref(*ins)
    outs = [(o, torch.from_numpy(g)) for o, g in ((hs, d_hs), (hT, d_hT))
            if o.requires_grad]
    wrt = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                   [g for _, g in outs], allow_unused=True))
    grads = [next(got) if n else None for n in needs]
    return [g if g is not None or not n else torch.zeros_like(t)
            for g, t, n in zip(grads, ins, needs)], hs.detach()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("zero_dhT", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", SHAPES)
def test_plain_reverse_equals_autograd_and_jax(B, S, W, dtype, zero_dhT):
    a, b, h0, d_hs, d_hT = _inputs(B * 7 + S + W, B, S, W, dtype, zero_dhT)
    want, hs = _autograd(a, b, h0, d_hs, d_hT, dtype)
    got = rglru_scan_bwd_ref(torch.from_numpy(a).to(TD[dtype]), hs,
                             torch.from_numpy(h0), torch.from_numpy(d_hs),
                             torch.from_numpy(d_hT))
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name} differs from autograd's bits"
    ja, jb = (jnp.asarray(x).astype(JD[dtype]) for x in (a, b))
    _, vjp = jax.vjp(j_rglru_ref, ja, jb, jnp.asarray(h0))
    for name, g, j in zip(("da", "db", "dh0"), got,
                          vjp((jnp.asarray(d_hs), jnp.asarray(d_hT)))):
        assert g.shape == j.shape, name
        np.testing.assert_allclose(_np(g), _np(j), **TOL, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("off", [0, 1, 2])
def test_function_backward_on_cpu_skips_unwanted_grads(off, dtype):
    """Each of a, b, h0 switched off in turn: ``RglruScanFn`` (the plain
    forward standing in for the launch, as on the CPU) gives the others
    autograd's bits through the plain reverse, None for the one off, and
    launches nothing."""
    B, S, W = 2, 17, 96
    a, b, h0, d_hs, d_hT = _inputs(61 + off, B, S, W, dtype, False)
    needs = tuple(i != off for i in range(3))
    want, _ = _autograd(a, b, h0, d_hs, d_hT, dtype, needs)
    ins = [torch.from_numpy(x).to(t).requires_grad_(n)
           for x, t, n in zip((a, b, h0), (TD[dtype], TD[dtype],
                                           torch.float32), needs)]
    launches = (rglru_ops.LAUNCHES, rglru_ops.REVERSE_LAUNCHES)
    hs, hT = rglru_ops.RglruScanFn.apply(rglru_scan_ref, *ins)
    wrt = [t for t in ins if t.requires_grad]
    got = iter(torch.autograd.grad((hs, hT), wrt, (torch.from_numpy(d_hs),
                                                   torch.from_numpy(d_hT))))
    for i, (t, w) in enumerate(zip(ins, want)):
        if i == off:
            assert w is None
            continue
        g = next(got)
        assert g.dtype == t.dtype and torch.equal(g, w)
    assert (rglru_ops.LAUNCHES, rglru_ops.REVERSE_LAUNCHES) == launches


def test_plain_reverse_in_fp64_and_for_a_b_of_two_types():
    """fp64 inputs stay fp64 (the gradient checks' type); a b of another
    dtype than a gets its gradient in its own."""
    B, S, W = 2, 9, 16
    a, b, h0, d_hs, d_hT = _inputs(71, B, S, W, "float32", False)
    ta = torch.from_numpy(a).double().requires_grad_()
    tb = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    th0 = torch.from_numpy(h0).double().requires_grad_()
    hs, hT = rglru_scan_ref(ta, tb, th0)
    assert hs.dtype == torch.float64
    g_hs, g_hT = torch.from_numpy(d_hs).double(), torch.from_numpy(d_hT)
    want = torch.autograd.grad((hs, hT), (ta, tb, th0), (g_hs, g_hT.double()))
    got = rglru_scan_bwd_ref(ta.detach(), hs.detach(), th0.detach(), g_hs,
                             g_hT, b_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
