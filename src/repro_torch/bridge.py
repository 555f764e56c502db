"""Turn the JAX package's param tree, given as numpy arrays, into the
port's parameters, and the port's params and train state back into the
JAX layout.

The JAX tree stacks each period position's params on a leading ``[P, ...]``
axis (``params["periods"]["b{i}"]``) and keeps the tail's blocks unstacked
(``params["tail"]["t{i}"]``); the port keeps one list of per-layer dicts
(layer ``p * len(period) + i``, then the tail's).  The whisper tree
stacks its encoder and decoder layers (``enc_layers``, ``dec_layers``) on
a leading axis; the port keeps a list of each.  Every other leaf (the
embedding, learned positions, final norms, biases) keeps its place.
bfloat16 is not a numpy type: a JAX bf16 array converts to a numpy array
of the
``ml_dtypes`` bfloat16 dtype, which goes through float32 here (exactly)
and back to torch bfloat16.
This module imports no JAX: the caller does the JAX-to-numpy step, e.g.
``jax.tree.map(np.asarray, params)``.

The way back (:func:`params_to_jax`, :func:`state_to_jax`) stacks the
layers again, on the device they lie on, and gives tensors, which keep
bf16 exactly (numpy has no bf16 without ``ml_dtypes``); :func:`numpy_of`
turns one into a numpy array (bf16 through float32, exactly), and the
checkpoint copies each to the host and stores bf16 as its ``uint16``
bits, as the JAX package's does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import base as cfgs


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (bf16 from ``ml_dtypes`` too) or a tensor -> a tensor
    on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _convert(tree, fn):
    if isinstance(tree, dict):
        return {k: _convert(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: cfgs.ModelConfig, tree: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """JAX param tree of numpy arrays -> port params on ``device``.  The
    tail's blocks (``tree["tail"]["t{i}"]``) follow the periods' layers;
    a tree with tied embeddings has no ``lm_head``; one with learned
    positions has ``pos_embed``.  Every leaf keeps its dtype (RWKV-6's
    ``u``, ``w0`` and ``gn_*`` and RG-LRU's gates stay fp32 beside bf16
    weights)."""
    def conv(a):
        return tensor_from_numpy(a, device)

    def unstack(sub, n):
        return [_convert(sub, lambda a, i=i: tensor_from_numpy(a[i], device))
                for i in range(n)]

    if cfg.is_encoder_decoder:
        out = {k: _convert(v, conv) for k, v in tree.items()
               if k not in ("enc_layers", "dec_layers")}
        out["enc_layers"] = unstack(tree["enc_layers"], cfg.encoder_layers)
        out["dec_layers"] = unstack(tree["dec_layers"], cfg.num_layers)
        return out
    out: Dict[str, Any] = {k: _convert(tree[k], conv)
                           for k in ("embed", "final_norm", "lm_head",
                                     "pos_embed")
                           if k in tree}
    n = len(cfg.period)
    layers = []
    for layer in range(cfg.num_periods * n):
        p, i = divmod(layer, n)
        layers.append(_convert(tree["periods"][f"b{i}"],
                               lambda a, p=p: tensor_from_numpy(a[p], device)))
    for i in range(len(cfg.tail)):
        layers.append(_convert(tree["tail"][f"t{i}"], conv))
    out["layers"] = layers
    return out


def numpy_of(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 as float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach()


def _stack(ts) -> torch.Tensor:
    return torch.stack([t.detach() for t in ts])


def _stack_tree(trees, stack):
    """A list of like trees (dicts of leaves) -> one tree of stack(list)."""
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees], stack)
                for k in trees[0]}
    return stack(trees)


def _params_layout(cfg: cfgs.ModelConfig, params: Dict[str, Any], one,
                   stack) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`'s layout: ``one(leaf)`` for
    an unstacked leaf, ``stack(leaves)`` for the layers' stacked ones."""
    if cfg.is_encoder_decoder:
        out = {k: _convert(v, one) for k, v in params.items()
               if k not in ("enc_layers", "dec_layers")}
        out["enc_layers"] = _stack_tree(params["enc_layers"], stack)
        out["dec_layers"] = _stack_tree(params["dec_layers"], stack)
        return out
    out = {k: _convert(v, one) for k, v in params.items() if k != "layers"}
    layers = params["layers"]
    n, P = len(cfg.period), cfg.num_periods
    out["periods"] = {f"b{i}": _stack_tree(layers[i:P * n:n], stack)
                      for i in range(n)}
    if cfg.tail:
        out["tail"] = {f"t{i}": _convert(layers[P * n + i], one)
                       for i in range(len(cfg.tail))}
    return out


def params_to_jax(cfg: cfgs.ModelConfig, params: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Port params -> the JAX param tree (``periods/b{i}`` stacked [P,
    ...], ``tail/t{i}``; whisper's ``enc_layers`` / ``dec_layers``
    stacked), as tensors of the same dtypes on the params' device (the
    stacked leaves are copies, the others the params' own)."""
    return _params_layout(cfg, params, _leaf, _stack)


def _state_layout(cfg, state, one, stack):
    opt = state["opt_state"]
    return {"params": _params_layout(cfg, state["params"], one, stack),
            "opt_state": {"mu": _params_layout(cfg, opt["mu"], one, stack),
                          "nu": _params_layout(cfg, opt["nu"], one, stack),
                          "count": one(opt["count"])},
            "step": one(state["step"])}


def state_to_jax(cfg: cfgs.ModelConfig, state: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """A train state ``{"params", "opt_state": {"mu", "nu", "count"},
    "step"}`` -> the JAX package's ``TrainState.tree()`` layout, as
    tensors of the same dtypes on the state's device (as
    :func:`params_to_jax`)."""
    return _state_layout(cfg, state, _leaf, _stack)


def state_dtypes(cfg: cfgs.ModelConfig, state: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """The JAX layout of ``state`` with each leaf's dtype in its place:
    what ``CheckpointManager.restore`` reads of its ``like`` tree, made
    without copying the state."""
    return _state_layout(cfg, state, lambda t: t.dtype,
                         lambda ts: ts[0].dtype)


def state_from_jax(cfg: cfgs.ModelConfig, tree: Dict[str, Any],
                   device="cpu") -> Dict[str, Any]:
    """The JAX layout of a train state (numpy arrays or tensors) -> the
    port's, on ``device``."""
    opt = tree["opt_state"]
    return {"params": params_from_jax(cfg, tree["params"], device),
            "opt_state": {"mu": params_from_jax(cfg, opt["mu"], device),
                          "nu": params_from_jax(cfg, opt["nu"], device),
                          "count": tensor_from_numpy(opt["count"], device)},
            "step": tensor_from_numpy(tree["step"], device)}
