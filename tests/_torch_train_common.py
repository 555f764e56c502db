"""Shared helpers of the port's training tests (``test_torch_train*.py``):
fp32 smoke models of both packages, numpy batches, and leaf-by-leaf
comparison of a port tree with a JAX one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs.base as jcfgs
from repro.models import model_zoo as jzoo
from repro.train import train_step as jstep
import repro_torch.configs.base as tcfgs
from repro_torch import bridge
from repro_torch.models import model_zoo

BIASES = ("bq", "bk", "bv", "bo", "bi", "bg", "bias")


def nonzero_norms(tree, seed):
    """Biases from N(0, 0.1^2) and norm scales from N(1, 0.1^2), seeded,
    so a misplaced bias or scale shows in the gradients."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in BIASES:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype)
        if name == "scale":
            return jnp.asarray(1 + 0.1 * rng.standard_normal(a.shape),
                               a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


def pair(arch, *, fp32=True):
    """(JAX model, port model) of ``arch``'s smoke config, fp32 unless
    asked otherwise."""
    jcfg = jcfgs.get_smoke_config(arch)
    tcfg = tcfgs.get_smoke_config(arch)
    if fp32:
        jcfg = dataclasses.replace(jcfg, dtype="float32")
        tcfg = dataclasses.replace(tcfg, dtype="float32")
    return jzoo.build(jcfg), model_zoo.build(tcfg)


def jstate(jm, seed):
    """JAX's ``init_state(...).tree()``, jitted (eager init takes seconds)."""
    return jax.jit(lambda k: jstep.init_state(jm, k).tree())(
        jax.random.PRNGKey(seed))


def batch(cfg, seed, B, S):
    """(jax batch, torch batch): tokens, labels over every position of
    the pass (P + S with patches), a loss mask with zeros, and the front
    end's frames / patches and M-RoPE positions."""
    rng = np.random.default_rng(seed)
    P = cfg.num_patches if cfg.frontend == "patches" else 0
    arrs = {"tokens": rng.integers(4, cfg.vocab_size, (B, S)).astype(
        np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, P + S)).astype(
            np.int32),
        "loss_mask": (rng.random((B, P + S)) > 0.2).astype(np.float32)}
    arrs["loss_mask"][:, :P] = 0.0
    if cfg.frontend == "frames":
        arrs["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        arrs["patches"] = rng.standard_normal((B, P, cfg.d_model)).astype(
            np.float32)
        arrs["positions"] = rng.integers(0, 64, (B, P + S, 3)).astype(
            np.int32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def as_np(x):
    """A tensor or a JAX array as an fp32 numpy array."""
    if isinstance(x, torch.Tensor):
        return bridge.numpy_of(x).astype(np.float32)
    return np.asarray(x, np.float32)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def hold_leaves(port_tree, jax_tree, cfg, rel, what="", zero=()):
    """Each leaf of the port tree within ``rel`` x the leaf's largest
    |JAX value| of the JAX tree converted to the port's layout.  Leaves
    named in ``zero`` have a zero gradient in exact arithmetic (a key
    bias shifts every logit of a query alike, and softmax ignores the
    shift), so both sides' values there are rounding: they are held to
    ``rel`` x the largest |JAX value| of the whole tree instead."""
    ref = flat(bridge.params_from_jax(cfg, jax.tree.map(np.asarray,
                                                        jax_tree)))
    got = flat(port_tree)
    assert got.keys() == ref.keys()
    top = max(float(np.abs(as_np(r)).max()) for r in ref.values())
    for k in ref:
        r, g = as_np(ref[k]), as_np(got[k])
        if k.split("/")[-1] in zero:
            assert max(np.abs(r).max(), np.abs(g).max()) <= rel * top, (
                what, k)
            continue
        scale = float(np.abs(r).max())
        err = float(np.abs(g - r).max())
        assert err <= rel * scale or err == 0.0, (what, k, err, scale)


def hold_updates(port_params, jax_params, jax_before, cfg, rel):
    """Each leaf's update since ``jax_before`` (port params minus the
    converted ``jax_before``) within ``rel`` of the leaf's largest JAX
    update."""
    delta = jax.tree.map(lambda a, b: np.asarray(a, np.float32)
                         - np.asarray(b, np.float32), jax_params, jax_before)
    before = bridge.params_from_jax(cfg, jax.tree.map(np.asarray,
                                                      jax_before))
    port_delta = jax.tree.map(lambda a, b: a.float() - b.float(),
                              port_params, before)
    hold_leaves(port_delta, delta, cfg, rel, "updates")
