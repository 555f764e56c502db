"""Sharding-constraint context for model internals: the PyTorch
counterpart of ``repro.models.shardctx``.

``enable(mesh, ...)`` arms the context (launchers and step cells only;
the serving engines never arm it, so ``constrain`` is a no-op there).
Armed, ``constrain(x, *dims)`` redistributes a DTensor ``x`` to the
placements its dims resolve to; a plain tensor passes through.  Dims that
don't divide their axis are dropped per dim, so one rule set serves every
architecture.

Tokens understood in a constraint spec: "dp" (all data-parallel axes),
"tp" (the model axis), "sp" (sequence: tp when sequence parallelism is on,
else unsharded), None.

:func:`armed` is ``enable`` for the length of a ``with`` block, with
DTensor's implicit replication on, so the plain tensors the model makes
(positions, masks) meet the DTensor params as replicated values.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

from repro_torch.kernels.local import is_dtensor  # noqa: F401 (re-export)
from repro_torch.launch import sharding

_STATE = {"mesh": None, "dp": ("data",), "tp": "model", "sp": False}


def enable(mesh, *, dp: Optional[Tuple[str, ...]] = None, tp: str = "model",
           sp: bool = False) -> None:
    _STATE["mesh"] = mesh
    _STATE["dp"] = dp or tuple(a for a in sharding.axis_names(mesh)
                               if a != tp)
    _STATE["tp"] = tp
    _STATE["sp"] = sp


def disable() -> None:
    _STATE["mesh"] = None


def enabled() -> bool:
    return _STATE["mesh"] is not None


@contextlib.contextmanager
def armed(mesh, *, sp: bool = False):
    """Arm the context (and DTensor's implicit replication) for a block."""
    from torch.distributed.tensor.experimental import implicit_replication
    enable(mesh, sp=sp)
    try:
        with implicit_replication():
            yield
    finally:
        disable()


def mesh_info():
    """(mesh, dp_axes, tp_axis) or (None, None, None)."""
    if _STATE["mesh"] is None:
        return None, None, None
    return _STATE["mesh"], _STATE["dp"], _STATE["tp"]


def tp_size() -> int:
    mesh = _STATE["mesh"]
    return 1 if mesh is None else sharding.axis_sizes(mesh)[_STATE["tp"]]


def dp_for(batch: int):
    """The subset of dp axes usable for a batch dim of this size."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return ()
    dp = _STATE["dp"]
    return dp if batch % sharding._axis_size(mesh, dp) == 0 else ()


def resolve(mesh, shape, dims) -> Tuple[Any, ...]:
    """The spec of ``dims`` (tokens or axis names) for ``shape``: each
    token's axes, or None where they don't divide the dim."""
    spec = []
    for size, d in zip(shape, dims):
        axis = ({"dp": _STATE["dp"], "tp": _STATE["tp"],
                 "sp": _STATE["tp"] if _STATE["sp"] else None}.get(d, d)
                if isinstance(d, str) else d)
        if axis is None or size % sharding._axis_size(mesh, axis):
            spec.append(None)
        else:
            spec.append(axis)
    return tuple(spec)


def constrain(x, *dims: Any):
    """Redistribute the DTensor ``x`` to the placements of ``dims``; a
    no-op unless a launcher armed the context, and on a plain tensor."""
    mesh = _STATE["mesh"]
    if mesh is None or not is_dtensor(x) or len(dims) != x.dim():
        return x
    want = sharding.placements(x.device_mesh,
                               resolve(mesh, tuple(x.shape), dims))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def assign(dst, src):
    """``dst.copy_(src)`` for cache writes on the mesh path: a DTensor
    ``dst`` (a cache placed by its specs) takes, on each rank, its own
    slice of ``src``'s full value; a plain ``dst`` takes the full value.
    Returns ``dst``."""
    if is_dtensor(src):
        src = src.full_tensor()
    if not is_dtensor(dst):
        dst.copy_(src)
        return dst
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    dst.to_local().copy_(src[tuple(slice(o, o + n)
                                   for o, n in zip(offset, shape))])
    return dst
