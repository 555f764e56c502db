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

Hardware constants: the NVIDIA H100 SXM data sheet's figures (not
measurements): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a
direction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16, H100 SXM data sheet
HBM_BW = 3.35e12             # bytes/s, H100 SXM data sheet (HBM3)
LINK_BW = 450e9              # bytes/s a direction, NVLink 4 (data sheet)


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

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

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


def analyze_step(fn, args, *, arch: str, shape: str,
                 model_flops: float = 0.0, chips: int = 1,
                 mesh: str = "1") -> Roofline:
    """Run ``fn(*args)`` once under ``op_cost``'s counter and return its
    roofline terms.  The step runs for real (its kernels launch), so pass
    arguments it may consume or mutate."""
    from repro_torch.launch import op_cost
    _, cost = op_cost.count(fn, *args)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=cost.collective_bytes, model_flops=model_flops,
        collectives=dict(cost.collective_counts),
        detail={"flops_by_path": dict(cost.flops_by_path),
                "kernel_launches": dict(cost.kernel_launches)})


def fmt_row(r: Roofline) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:9s} "
            f"C={r.t_compute*1e3:9.2f}ms M={r.t_memory*1e3:9.2f}ms "
            f"X={r.t_collective*1e3:9.2f}ms -> {r.bottleneck:10s} "
            f"useful={r.useful_flop_ratio:6.2%} mfu_bound={r.mfu_bound:6.2%}")
