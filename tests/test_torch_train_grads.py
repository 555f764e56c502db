"""Gradients of the port's ``loss_fn`` (``repro_torch.train``,
``lm.ce_loss_chunked``, remat) held to ``jax.grad`` of the JAX package's
on the CPU, for a dense decoder, a mixture of experts, RWKV-6, the
RG-LRU hybrid, whisper (frames) and qwen2-vl (patches, M-RoPE, labels
over the patches and the text).

Both sides run fp32 smoke configs on params converted from JAX (with
nonzero biases and norm scales) and the same numpy batches.  Tolerances,
set from the dtype before the first run: each gradient leaf within 1e-4
of the leaf's largest |jax.grad| value (fp32 sums over the batch and the
layers run in another order in the two frameworks); the loss and its
parts within 1e-5; remat on and off bitwise equal in the port (the same
ops recomputed); the chunked loss within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_common as tt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

GRAD_TOL = 1e-4
GRAD_ARCHS = ("minitron-8b", "qwen2-moe-a2.7b", "rwkv6-1.6b",
              "recurrentgemma-9b", "whisper-base", "qwen2-vl-7b")


# ---------------------------------------------------------------------------
# gradients of loss_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_grads_match_jax(arch):
    jm, tm = tt.pair(arch)
    cfg = tm.cfg
    jparams = tt.nonzero_norms(jax.jit(jm.init_params)(jax.random.PRNGKey(0)),
                             11)
    tparams = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    jb, tb = tt.batch(cfg, 3, 2, 12)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(jm, p, jb, remat=True), has_aux=True))(
            jparams)
    grads = {}
    for remat in (True, False):
        loss, aux, g = tstep.make_grad_fn(tm, remat=remat)(tparams, tb)
        grads[remat] = g
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for k in ("ce", "aux", "tokens"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-7)
    tt.hold_leaves(grads[True], jg, cfg, GRAD_TOL, arch, zero=("bk",))
    for a, b in zip(toptim.leaves(grads[True]), toptim.leaves(grads[False])):
        assert torch.equal(a, b)


def test_ce_loss_chunked_pads_and_softcaps():
    """The chunked loss over 3 chunks with a padded tail and a softcap,
    against JAX's (hidden, labels and mask from numpy)."""
    jm, tm = tt.pair("recurrentgemma-9b")
    cfg = tm.cfg
    assert cfg.logit_softcap
    jparams = jax.jit(jm.init_params)(jax.random.PRNGKey(1))
    tparams = bridge.params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    lab = rng.integers(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    mask = (rng.random((2, 21)) > 0.3).astype(np.float32)
    jl, jc = jax.jit(jm.ce_loss, static_argnames="chunk")(
        jparams, jnp.asarray(h), jnp.asarray(lab), jnp.asarray(mask),
        chunk=8)
    tl, tc = tm.ce_loss(tparams, torch.from_numpy(h), torch.from_numpy(lab),
                        torch.from_numpy(mask), chunk=8)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tc) == float(jc) == mask.sum()
