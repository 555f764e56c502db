"""Kernel wrappers on DTensors: the local-shard call of the mesh path.

A kernel launches on plain tensors through their data pointers; a DTensor
is a wrapper subclass whose pointer is not its data.  A wrapper handed
DTensors runs itself on each rank's local shard through :func:`run_local`
(what ``local_map`` does, with the placements resolved from per-dimension
tokens): every argument is first redistributed so that its ``"dp"``
dimension is sharded over the mesh's data-parallel axes and its ``"tp"``
dimension over ``model`` (each only where every argument's dimension
divides), and everything else is replicated.  The outputs come back as
DTensors with their tokens' placements.  The redistributions, ``to_local``
and ``from_local`` carry gradients, so the training path goes through
too.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

Dims = Tuple[Any, ...]        # per dimension: "dp", "tp" or None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _spec(dims: Dims, use: dict) -> Tuple[Any, ...]:
    return tuple(use.get(d) if isinstance(d, str) else None for d in dims)


def run_local(fn: Callable, args: Sequence[Any], dims: Sequence[Dims],
              out_dims):
    """Call ``fn(*locals)`` on this rank's shards of ``args`` and wrap its
    outputs as DTensors.  ``dims[i]`` gives the tokens of ``args[i]``
    (None for an argument that is not a tensor); a plain tensor argument
    is the full (replicated) value and is sliced here.  ``out_dims`` is
    one tuple of tokens, or a tuple of them for a tuple of outputs."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.launch import sharding
    from repro_torch.launch.sharding import placements
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    names = sharding.axis_names(mesh)
    dp = tuple(a for a in names if a != "model")
    size = {"dp": sharding._axis_size(mesh, dp) if dp else 1,
            "tp": sharding._axis_size(mesh, "model") if "model" in names
            else 1}
    use = {"dp": dp or None, "tp": "model" if "model" in names else None}
    for a, d in zip(args, dims):
        for n, tok in zip(a.shape, d or ()):
            if tok in use and n % size[tok]:
                use[tok] = None
    locs = []
    for a, d in zip(args, dims):
        if d is None:
            locs.append(a)
            continue
        want = placements(mesh, _spec(d, use))
        if is_dtensor(a):
            if tuple(a.placements) != want:
                a = a.redistribute(mesh, want)
            locs.append(a.to_local())
        else:
            locs.append(distribute_tensor(a, mesh, want,
                                          src_data_rank=None).to_local())
    out = fn(*locs)
    many = isinstance(out_dims[0], tuple) if out_dims else False

    def wrap(t, d):
        return DTensor.from_local(t, mesh, placements(mesh, _spec(d, use)),
                                  run_check=False)
    if many:
        return tuple(wrap(t, d) for t, d in zip(out, out_dims))
    return wrap(out, out_dims)
