"""Per-device cost of an eager step, counted at op boundaries: the
PyTorch counterpart of ``repro.launch.hlo_cost``.

XLA compiles a step into fused HLO, which ``hlo_cost`` walks.  Eager
PyTorch has no such artifact; :class:`OpCounter`, a
``TorchDispatchMode``, counts every op the step dispatches on this rank:

  * ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``: 2*M*N*K FLOPs (dots);
  * transcendental ops: 8 FLOPs an output element; other elementwise ops
    1 an output element, reductions 1 an input element;
  * bytes: every tensor an op reads and writes (views, which move
    nothing, and allocations count none).  Every op boundary counts, so
    this is an upper bound on HBM traffic that XLA's fusion would lower:
    it is not comparable with the JAX package's bytes;
  * collectives (the functional and the c10d ops, on DTensors or not):
    wire bytes by :func:`_wire_bytes`, the JAX package's ring formulas,
    over the group the op runs on.

The hand-written kernels launch through ctypes, below the dispatcher;
each wrapper reports its own launch's work (``kernels.report``, the
formulas of ``chip_smoke.py``'s bounds), which the counter takes in while
it is active.  ``flops_by_path`` tags dots ``dot`` and each kernel's work
by the kernel's name.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

aten = torch.ops.aten

_DOTS = {"mm", "bmm", "addmm", "baddbmm"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "pow", "sin", "cos", "erf",
                   "atan2", "reciprocal", "silu", "gelu", "log_sigmoid_forward",
                   "_softmax", "_log_softmax", "logsumexp",
                   "sigmoid_backward", "tanh_backward", "silu_backward",
                   "gelu_backward", "_softmax_backward_data",
                   "log_sigmoid_backward"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "var", "std",
               "argmax", "argmin", "prod", "norm", "linalg_vector_norm",
               "cumsum", "sort", "topk"}
_NO_TRAFFIC = {"view", "_unsafe_view", "reshape", "as_strided", "t",
               "transpose", "permute", "expand", "select", "slice",
               "unsqueeze", "squeeze", "detach", "alias", "split",
               "split_with_sizes", "chunk", "unbind", "view_as_real",
               "view_as_complex", "_reshape_alias", "empty", "empty_like",
               "empty_strided", "new_empty", "new_empty_strided",
               "lift_fresh", "_to_copy_noop", "unfold", "diagonal",
               "wait_tensor", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "is_same_size", "set_"}
# op name -> collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _wire_bytes(kind: str, result_bytes: int, operand_bytes: int,
                group: int) -> float:
    """Ring-algorithm bytes over the slowest link, per device (the JAX
    package's ``hlo_cost._wire_bytes``)."""
    n = max(group, 1)
    if n == 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) / n * operand_bytes
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0               # per device
    bytes: float = 0.0               # read + written at op boundaries
    collective_bytes: float = 0.0    # wire bytes per device
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    flops_by_path: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def dot_flops(self) -> float:
        return sum(self.flops_by_path.values())


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args, kwargs) -> int:
    """The size of the process group a collective runs on: a group name
    (functional collectives) or a ProcessGroup (c10d ops)."""
    import torch.distributed as dist
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                return _resolve_process_group(a).size()
            except Exception:       # not a group name: another str arg
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        size = getattr(a, "size", None)
        if callable(size) and type(a).__name__.endswith("ProcessGroup"):
            return a.size()
    return dist.get_world_size() if dist.is_initialized() else 1


def _dot_flops(name, args) -> float:
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = args[-2], args[-1]                     # bmm / baddbmm
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched (and the kernels launched) inside its
    ``with`` block into ``self.cost``."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self._prev_hook = None

    def __enter__(self):
        self._prev_hook = kernels.WORK_HOOK
        kernels.WORK_HOOK = self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.WORK_HOOK = self._prev_hook
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        c.flops_by_path[name] = c.flops_by_path.get(name, 0.0) + flops
        c.kernel_launches[name] = c.kernel_launches.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func._schema.name.split("::")[-1]
        ins, outs = _tensors(args), _tensors(out)
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            rbytes = _nbytes(outs) if name not in ("allreduce_",) else \
                _nbytes(ins)
            ob = _nbytes(ins)
            if name.endswith("_"):               # c10d ops: in place
                rbytes = ob if kind != "all-gather" else _nbytes(outs)
            c.collective_bytes += _wire_bytes(kind, rbytes, ob,
                                              _group_size(args, kwargs))
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            return
        if name in _NO_TRAFFIC or not outs:
            return
        if name in _DOTS:
            f = _dot_flops(name, args)
            c.flops += f
            c.flops_by_path["dot"] = c.flops_by_path.get("dot", 0.0) + f
        elif name in _TRANSCENDENTAL:
            c.flops += 8.0 * sum(t.numel() for t in outs)
        elif name in _REDUCTIONS:
            c.flops += float(ins[0].numel()) if ins else 0.0
        else:
            c.flops += float(sum(t.numel() for t in outs))
        c.bytes += _nbytes(ins) + _nbytes(outs)


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`: returns
    (its result, the :class:`OpCost`)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
