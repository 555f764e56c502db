"""Device meshes: the PyTorch counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the axes
``("data", "model")`` over the world of the process group the caller has
initialised (``torch.distributed.init_process_group``; nothing here starts
one).  ``data`` is data parallelism and FSDP, ``model`` tensor, expert and
sequence parallelism, as in the JAX package.  The production mesh (the
JAX package's ``make_production_mesh``) is not ported yet.

gloo with CUDA tensors (ranks that share a card): gloo's asynchronous
functional collectives, which DTensor's redistributions use, crash on
CUDA tensors (torch 2.11: the wait on an all-gather segfaults, while the
blocking c10d calls work).  ``make_host_mesh`` therefore runs the
functional collectives of such a world as blocking c10d calls
(:func:`blocking_collectives`); gloo stages CUDA tensors through the host
either way, so nothing else changes.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch import sharding


def make_host_mesh(*, model: int = 1, device_type: str = "cuda"):
    """A ``(world // model, model)`` mesh over the initialised process
    group's ranks, on ``device_type`` ("cuda" or "cpu")."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"of {n} ranks")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        blocking_collectives("CUDA")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}
_LIBS = {}


def _group(name):
    if isinstance(name, dist.ProcessGroup):
        return name
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def _all_reduce(x, op, group):
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=_group(group))
    return out


def _all_gather(x, size, group):
    out = x.new_empty((x.shape[0] * size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=_group(group))
    return out


def _reduce_scatter(x, op, size, group):
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=_OPS[op],
                               group=_group(group))
    return out


def _all_to_all(x, out_splits, in_splits, group):
    out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), list(out_splits),
                           list(in_splits), group=_group(group))
    return out


def blocking_collectives(dispatch_key: str = "CUDA"):
    """Run the functional collectives (``_c10d_functional``: all-reduce,
    all-gather, reduce-scatter, all-to-all) on ``dispatch_key`` tensors
    as blocking c10d calls in this process; their waits then find no work
    pending.  Returns the registration (``_destroy()`` undoes it)."""
    if dispatch_key not in _LIBS:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        for name, fn in (("all_reduce", _all_reduce),
                         ("all_gather_into_tensor", _all_gather),
                         ("reduce_scatter_tensor", _reduce_scatter),
                         ("all_to_all_single", _all_to_all)):
            lib.impl(name, fn, dispatch_key)
        _LIBS[dispatch_key] = lib
    return _LIBS[dispatch_key]


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except ``model``)."""
    return tuple(a for a in sharding.axis_names(mesh) if a != "model")


def tp_axis(mesh) -> str:
    return "model"
