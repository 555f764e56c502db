"""Roofline terms of a step on the H100: the PyTorch counterpart of
``repro.launch.roofline``.

Three terms per step, all in seconds, per device:

  compute    = FLOPs / peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = wire bytes of the collectives / link bandwidth

``launch/op_cost.py`` counts the three at op boundaries while the step
runs (the JAX package walks its compiled HLO instead).  Eager PyTorch
has a boundary at every op where XLA fuses, so ``hlo_bytes`` and
``t_memory`` here are an upper bound that is not comparable with the JAX
package's; the dot FLOPs and ``model_flops`` are.  The fields keep the
JAX names (``hlo_flops``, ``hlo_bytes``) so a report reads the same.

Hardware constants: data-sheet figures, not measurements.  NVIDIA H100
SXM: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB of it, 450 GB/s NVLink
a direction between the 8 cards of a node.  NVIDIA ConnectX-7: 400 Gb/s
(NDR InfiniBand), 50 GB/s a card, between nodes.

On a mesh, each axis's collectives cross their own link (:func:`link_bw`):
NVLink where the axis's groups lie inside a node, InfiniBand where they
span nodes; ``t_collective`` sums each axis's wire bytes over its link.
:func:`analyze_step` runs a step once under the counter (on meta
tensors in a dry-run) and adds the memory a device holds;
:func:`analyze_cell`, the same for a step cell, is the dry-run's
counterpart of the JAX package's ``analyze(cell, lowered, compiled)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

PEAK_FLOPS = 989e12          # dense bf16, H100 SXM data sheet
HBM_BW = 3.35e12             # bytes/s, H100 SXM data sheet (HBM3)
LINK_BW = 450e9              # bytes/s a direction, NVLink 4 (data sheet)
IB_BW = 50e9                 # bytes/s a card, ConnectX-7 NDR (data sheet)
NODE_CARDS = 8               # H100s a node, joined by NVLink
HBM_BYTES = 80e9             # H100 SXM memory (data sheet)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # per device
    hlo_bytes: float             # per device (op boundaries)
    collective_bytes: float      # per device (wire)
    model_flops: float           # analytic 6ND / 2ND (global)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    memory_per_device: Optional[Dict[str, float]] = None
    detail: Optional[Dict[str, Any]] = None
    # wire bytes by mesh axis ("other": a group of no axis) and each
    # axis's link (bytes/s); t_collective charges each to its own
    axis_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    axis_bw: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / self.axis_bw[a] for a, b in self.axis_bytes.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs x chips): how much of the counted compute
        is useful (catches remat and redundancy)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilisation upper bound at the roofline: useful
        FLOPs / (chips x peak x bound time)."""
        denom = self.chips * PEAK_FLOPS * self.t_bound
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu_bound": self.mfu_bound,
            "collectives": self.collectives,
            "memory_per_device": self.memory_per_device,
            "detail": self.detail,
        }


def link_bw(mesh) -> Dict[str, float]:
    """The link each mesh axis's collectives cross (bytes/s).  Ranks are
    laid out row-major, ``NODE_CARDS`` consecutive ones a node: an axis
    whose groups span at most a node (its size times the sizes of the
    axes after it) takes NVLink, any other InfiniBand; "other" (a group
    of no axis) spans the whole mesh, one card without one."""
    from repro_torch.launch import sharding
    out, span = {}, 1
    if mesh is not None:
        sizes = sharding.axis_sizes(mesh)
        for a in reversed(sharding.axis_names(mesh)):
            span *= sizes[a]
            out[a] = LINK_BW if span <= NODE_CARDS else IB_BW
    out["other"] = LINK_BW if span <= NODE_CARDS else IB_BW
    return out


def mesh_name(mesh) -> str:
    from repro_torch.launch import sharding
    if mesh is None:
        return "1"
    sizes = sharding.axis_sizes(mesh)
    return "x".join(str(sizes[a]) for a in sharding.axis_names(mesh))


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree's tensors (each storage
    once)."""
    from repro_torch.train.optim import leaves
    seen, n = set(), 0
    for t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        loc = t.to_local() if hasattr(t, "to_local") else t
        st = loc.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += loc.numel() * loc.element_size()
    return n


def analyze_step(fn, args, *, arch: str, shape: str,
                 model_flops: float = 0.0, mesh=None) -> Roofline:
    """Run ``fn(*args)`` once under ``op_cost``'s counter and return its
    roofline: this rank's work, the wire bytes by mesh axis (none on one
    card, ``mesh=None``), and the memory a device holds:
    ``argument_bytes`` (this rank's shards of the arguments),
    ``output_bytes``, ``peak_bytes`` (arguments plus the tally's peak of
    what the step allocates), ``temp_bytes`` (peak - arguments) and
    ``fits`` (peak within ``HBM_BYTES``).  On real tensors the step runs
    for real (its kernels launch), so pass arguments it may consume or
    mutate."""
    from repro_torch.launch import op_cost
    arg_bytes = float(local_bytes(args))
    out, cost = op_cost.count(fn, *args, mesh=mesh)
    peak = arg_bytes + cost.peak_bytes
    mem = {"argument_bytes": arg_bytes,
           "output_bytes": float(local_bytes(out)),
           "temp_bytes": float(cost.peak_bytes), "peak_bytes": peak,
           "fits": peak <= HBM_BYTES}
    bw = link_bw(mesh)
    detail = {
        "flops_by_path": dict(sorted(cost.flops_by_path.items(),
                                     key=lambda kv: -kv[1])),
        "collective_by_path": dict(sorted(cost.collective_by_path.items(),
                                          key=lambda kv: -kv[1])),
        "collective_by_axis": dict(cost.collective_by_axis),
        "link_bw_by_axis": {a: bw[a] for a in cost.collective_by_axis},
        "kernel_launches": dict(cost.kernel_launches)}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name(mesh),
        chips=1 if mesh is None else mesh.size(), hlo_flops=cost.flops,
        hlo_bytes=cost.bytes, collective_bytes=cost.collective_bytes,
        model_flops=model_flops, collectives=dict(cost.collective_counts),
        memory_per_device=mem, detail=detail,
        axis_bytes=dict(cost.collective_by_axis), axis_bw=bw)


def analyze_cell(cell, *args) -> Roofline:
    """:func:`analyze_step` of a step cell on its placed arguments."""
    return analyze_step(cell.run, args, arch=cell.arch,
                        shape=cell.shape.name, model_flops=cell.model_flops,
                        mesh=cell.mesh)


def fmt_row(r: Roofline) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:9s} "
            f"C={r.t_compute*1e3:9.2f}ms M={r.t_memory*1e3:9.2f}ms "
            f"X={r.t_collective*1e3:9.2f}ms -> {r.bottleneck:10s} "
            f"useful={r.useful_flop_ratio:6.2%} mfu_bound={r.mfu_bound:6.2%}")
