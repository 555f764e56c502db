"""Turn the JAX package's param tree, given as numpy arrays, into the
port's parameters.

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
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import base as cfgs


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
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
