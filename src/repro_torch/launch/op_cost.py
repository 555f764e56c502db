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
  * collectives (the functional and the c10d ops): wire bytes by
    :func:`_wire_bytes`, the JAX package's ring formulas, over the group
    the op runs on, and by mesh axis where the counter knows the mesh.

On a mesh the counter counts this rank's work, as XLA's per-partition
module does.  An op on DTensors reaches the mode at the DTensor level,
with global shapes; the counter steps aside (``NotImplemented``), so
DTensor runs it on the local shards, redistributing first, and the
counter sees those local ops and collectives.  DTensor also runs each op
once on fake tensors of the global shapes to learn the output's metadata
(its sharding propagation); an op on ``FakeTensor`` objects is that, not
work, and counts nothing.  The local shards may be real or meta tensors (the
dry-run's): both count alike.

The counter also keeps a live-bytes tally: each new
storage an op's output holds (not one of its inputs', so views and
in-place ops add nothing) counts from its first op until it is freed,
rounded up to the 512-byte blocks of the CUDA caching allocator;
``OpCost.peak_bytes`` is the tally's maximum.  Storages that existed when
the counter started (the step's arguments) are not in it.

The hand-written kernels launch through ctypes, below the dispatcher;
each wrapper reports its own launch's work (``kernels.report``, the
formulas of ``chip_smoke.py``'s bounds), which the counter takes in while
it is active; so does a kernel's meta route in a dry-run.
``flops_by_path`` tags dots ``dot`` and each kernel's work by the
kernel's name.
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
    # wire bytes by mesh axis ("other" for a group of no axis of the mesh)
    collective_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # wire bytes by "<kind>@<axis>"
    collective_by_path: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    flops_by_path: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0          # live-bytes tally's maximum

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


def _group_of(args, kwargs):
    """(name, size) of the process group a collective runs on: a group
    name (functional collectives) or a ProcessGroup (c10d ops, which
    reach the dispatcher boxed in a ``ScriptObject``)."""
    import torch.distributed as dist
    for a in list(args) + list((kwargs or {}).values()):
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith("c10d.ProcessGroup"):
            a = dist.ProcessGroup.unbox(a)
        if isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                return a, _resolve_process_group(a).size()
            except Exception:       # not a group name: another str arg
                continue
        if isinstance(a, dist.ProcessGroup) or (
                callable(getattr(a, "size", None))
                and type(a).__name__.endswith("ProcessGroup")):
            return getattr(a, "group_name", None), a.size()
    return None, dist.get_world_size() if dist.is_initialized() else 1


def _dot_flops(name, args) -> float:
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = args[-2], args[-1]                     # bmm / baddbmm
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


BLOCK = 512          # the CUDA caching allocator's block granularity


def _block_bytes(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched (and the kernels launched) inside its
    ``with`` block into ``self.cost``, as this rank's work.  ``mesh`` (a
    ``DeviceMesh``) names the axis of each collective's group."""

    def __init__(self, mesh=None):
        super().__init__()
        self.cost = OpCost()
        self._prev_hook = None
        self._axis_of = {}
        if mesh is not None:
            for a in mesh.mesh_dim_names:
                self._axis_of[mesh.get_group(a).group_name] = a
        self._live = 0
        self._held = {}          # id(storage) -> weakref to it

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
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # counted on the local shards
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors(args), _tensors(out)
        if not _is_fake(ins + outs):
            self._hold(ins, outs)
            self._count(func, args, kwargs, ins, outs)
        return out

    def _hold(self, ins, outs) -> None:
        import weakref
        seen = {id(_storage(t)) for t in ins}
        for t in outs:
            st = _storage(t)
            key = id(st)
            if st is None or key in seen or key in self._held:
                continue
            seen.add(key)
            n = _block_bytes(st.nbytes())
            self._held[key] = weakref.ref(st, lambda _, k=key, n=n:
                                          self._free(k, n))
            self._live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _free(self, key, n) -> None:
        self._held.pop(key, None)
        self._live -= n

    def _count(self, func, args, kwargs, ins, outs) -> None:
        c = self.cost
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            rbytes = _nbytes(outs) if name not in ("allreduce_",) else \
                _nbytes(ins)
            ob = _nbytes(ins)
            if name.endswith("_"):               # c10d ops: in place
                rbytes = ob if kind != "all-gather" else _nbytes(outs)
            group, size = _group_of(args, kwargs)
            wire = _wire_bytes(kind, rbytes, ob, size)
            axis = self._axis_of.get(group, "other")
            c.collective_bytes += wire
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            c.collective_by_axis[axis] = c.collective_by_axis.get(
                axis, 0.0) + wire
            path = f"{kind}@{axis}"
            c.collective_by_path[path] = c.collective_by_path.get(
                path, 0.0) + wire
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


def _storage(t):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # a tensor with none
        return None


def _is_fake(ts) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in ts)


def count(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`: returns
    (its result, the :class:`OpCost`)."""
    with OpCounter(mesh=mesh) as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
