"""The PyTorch port's model primitives (``repro_torch.models.common``) held
to the JAX package's element by element, on the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py``: fp32 rtol/atol 2e-4
(summation order differs between the frameworks), bf16 5e-2 (one bf16
rounding step apart)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.models import common as jc  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


def _close(j, t, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layernorm", [False, True])
def test_apply_norm(dtype, layernorm):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)) * 3 + 0.5
    scale = rng.standard_normal(48)
    jx, tx = _pair(x, dtype)
    js, ts = _pair(scale, dtype)
    jp, tp = {"scale": js}, {"scale": ts}
    if layernorm:
        b = rng.standard_normal(48)
        jp["bias"], tp["bias"] = _pair(b, dtype)
    out = tc.apply_norm(tp, tx, 1e-6)
    assert out.dtype == tx.dtype
    _close(jc.apply_norm(jp, jx, 1e-6), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_and_mlp(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 32))
    w = {k: rng.standard_normal(s) / np.sqrt(s[0])
         for k, s in (("wi", (32, 64)), ("wg", (32, 64)), ("wo", (64, 32)))}
    jx, tx = _pair(x, dtype)
    jw = {k: _pair(v, dtype)[0] for k, v in w.items()}
    tw = {k: _pair(v, dtype)[1] for k, v in w.items()}
    _close(jc.linear(jx, jw["wi"]), tc.linear(tx, tw["wi"]), dtype)
    out = tc.apply_mlp(tw, tx)
    assert out.dtype == tx.dtype
    _close(jc.apply_mlp(jw, jx), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(dtype, theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16))
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    np.testing.assert_allclose(tc.rope_inv_freq(16, theta).numpy(),
                               np.asarray(jc.rope_inv_freq(16, theta)),
                               rtol=1e-6)
    out = tc.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(jc.apply_rope(jx, jnp.asarray(pos), theta), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap(dtype):
    x = np.random.default_rng(3).standard_normal((4, 33)) * 40
    jx, tx = _pair(x, dtype)
    _close(jc.softcap(jx, 30.0), tc.softcap(tx, 30.0), dtype)
    assert tc.softcap(tx, 0.0) is tx


def test_init_distributions():
    """dense_init / embed_init draw N(0, scale/sqrt(d_in)) and N(0, 0.02),
    as the JAX versions do (the generators differ, the laws agree)."""
    gen = torch.Generator().manual_seed(0)
    w = tc.dense_init(gen, 256, 512, torch.float32, scale=2.0)
    assert w.shape == (256, 512)
    assert abs(w.std().item() - 2.0 / 16) < 0.01 * 2.0 / 16 * 5
    assert abs(w.mean().item()) < 1e-3
    e = tc.embed_init(gen, 1000, 64, torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert abs(e.float().std().item() - 0.02) < 0.02 * 0.05
