"""Turn the JAX package's param tree, given as numpy arrays, into the
port's parameters.

The JAX tree stacks each period position's params on a leading ``[P, ...]``
axis (``params["periods"]["b{i}"]``); the port keeps a list of per-layer
dicts (layer ``p * len(period) + i``).  bfloat16 is not a numpy type: a JAX
bf16 array converts to a numpy array of the ``ml_dtypes`` bfloat16 dtype,
which goes through float32 here (exactly) and back to torch bfloat16.
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
    """JAX param tree of numpy arrays -> port params on ``device``."""
    if cfg.tail:
        raise NotImplementedError("tail blocks are not yet ported")
    out: Dict[str, Any] = {
        k: _convert(tree[k], lambda a: tensor_from_numpy(a, device))
        for k in ("embed", "final_norm", "lm_head")}
    n = len(cfg.period)
    layers = []
    for layer in range(cfg.num_layers):
        p, i = divmod(layer, n)
        layers.append(_convert(tree["periods"][f"b{i}"],
                               lambda a, p=p: tensor_from_numpy(a[p], device)))
    out["layers"] = layers
    return out
