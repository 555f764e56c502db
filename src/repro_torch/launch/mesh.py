"""Device meshes: the PyTorch counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the axes
``("data", "model")`` over the world of the process group the caller has
initialised (``torch.distributed.init_process_group``; nothing here starts
one).  ``data`` is data parallelism and FSDP, ``model`` tensor, expert and
sequence parallelism, as in the JAX package.

The production mesh (:func:`make_production_mesh`) keeps the JAX
package's card counts, 256 a pod, as H100s: ``model`` defaults to 8, the
cards of one H100 node on NVLink, so tensor and expert parallelism and
the sequence-sharded decode's combines stay inside a node, and ``data``
and ``pod`` cross nodes over InfiniBand (``launch/roofline``);
``model=16`` gives the JAX package's TPU layout, (16, 16) and
(2, 16, 16).  The dry-run (``launch/dryrun``) builds it over a fake
process group of 256 or 512 ranks.

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


POD_CARDS = 256         # cards a pod, the JAX package's production count


def production_shape(*, multi_pod: bool = False, model: int = 8):
    """(shape, axis names) of the production mesh."""
    if model < 1 or POD_CARDS % model:
        raise ValueError(f"model axis {model} does not divide a pod of "
                         f"{POD_CARDS} cards")
    if multi_pod:
        return (2, POD_CARDS // model, model), ("pod", "data", "model")
    return (POD_CARDS // model, model), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, model: int = 8,
                         device_type: str = "cuda"):
    """The production mesh over the initialised world: ``("data",
    "model")`` = (256 // model, model) on one pod, ``("pod", "data",
    "model")`` = (2, 256 // model, model) on two.  Raises unless the world
    has exactly that many ranks."""
    shape, names = production_shape(multi_pod=multi_pod, model=model)
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group (torch.distributed."
                           "init_process_group)")
    n = 1
    for d in shape:
        n *= d
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


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
