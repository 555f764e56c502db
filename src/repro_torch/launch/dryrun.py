"""Dry-run on the production mesh: every (arch x shape) cell traced on
H100 meshes of 256 or 512 cards with nothing allocated, and its memory
and roofline recorded; the PyTorch counterpart of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell on forced host devices.
Here a cell runs once as rank 0 of a fake world
(``torch.distributed``'s ``"fake"`` backend: collectives return at once)
on meta tensors: shape and dtype, no storage.  Its ``DeviceMesh`` is of
device type ``"cpu"`` (a ``"meta"`` mesh cannot copy), its arguments are
DTensors placed by the cell's specs whose local shards are meta, and the
kernels take their meta routes (checks, allocations and reported work,
no launch).  ``launch/roofline.analyze_cell`` counts rank 0's work,
collectives by mesh axis, and the bytes a card holds.  Every rank's
shard has rank 0's shape wherever an axis divides its dimension (the
sharding rules drop an axis that does not), so rank 0 stands for all.
A decode cell decodes one token against a cache of ``seq_len`` slots,
all of them valid, as the JAX cell does.  On a ``"cpu"`` mesh DTensor
moves a shard from one tensor dimension to another by an all-gather and
a slice where a card mesh takes an all-to-all (the sequence-parallel and
expert-parallel layouts), so such a step's records count the gather.

The dry-run needs no card.  It starts its own world, so it runs in a
process of its own, never inside one that holds a real process group.

Usage:
  python -m repro_torch.launch.dryrun                 # all cells, both meshes
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --model 16 --single-pod-only \\
      --json results_torch/dryrun_h100_model16.json

Each record has the JAX package's keys (``Roofline.to_dict()`` plus
``ok``, ``compile_s`` (here the seconds the trace took), ``multi_pod``
and ``skipped``), so ``python -m benchmarks.report_roofline <json>``
renders it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from repro_torch.configs import base as cfgs
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import model_zoo

# Per-arch train-cell settings of the JAX package's dry-run (its
# ``--optimized``): sequence parallelism for MoE / VL, gradient
# accumulation for the dense and recurrent archs.
TRAIN_POLICY = {
    "phi3.5-moe-42b-a6.6b": {"sp": True},
    "qwen2-moe-a2.7b": {"sp": True},
    "qwen2-vl-7b": {"sp": True},
    "minitron-8b": {"grad_accum": 8},
    "qwen3-32b": {"grad_accum": 16},
    "command-r-35b": {"grad_accum": 16},
    "stablelm-12b": {"grad_accum": 8},
    "whisper-base": {"grad_accum": 8},
    "rwkv6-1.6b": {"grad_accum": 4},
    "recurrentgemma-9b": {"grad_accum": 4},
}

_MESHES: Dict[Any, Any] = {}


def smoke_config(arch: str) -> cfgs.ModelConfig:
    """The arch's smoke config at a head dim the attention kernels take:
    64 (qwen2-vl's M-RoPE sections scaled to its 32 rotary pairs), as the
    on-card tests run the smoke models; the attention-free RWKV model as
    it is."""
    import dataclasses
    cfg = cfgs.get_smoke_config(arch)
    if not (cfg.is_encoder_decoder or any(
            b in (cfgs.ATTN, cfgs.LOCAL_ATTN) for b in cfg.block_pattern)):
        return cfg
    cfg = dataclasses.replace(cfg, head_dim=64)
    if cfg.mrope_sections:
        cfg = dataclasses.replace(cfg, mrope_sections=(8, 12, 12))
    return cfg


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks (the
    one it holds if that is one already)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run starts its own fake world: run "
                               "it in a process that holds no process group")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
        _MESHES.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def production_mesh(*, multi_pod: bool, model: int = 8):
    """The production mesh (``launch/mesh``) on a fake world of its size,
    device type "cpu"."""
    key = (multi_pod, model)
    if key not in _MESHES:
        shape, _ = production_shape(multi_pod=multi_pod, model=model)
        n = 1
        for d in shape:
            n *= d
        fake_world(n)
        _MESHES[key] = make_production_mesh(multi_pod=multi_pod, model=model,
                                            device_type="cpu")
    return _MESHES[key]


def abstract_args(cell: steps.Cell):
    """The cell's arguments as meta tensors (no storage), unplaced."""
    cfg, shape = cell.model.cfg, cell.shape
    batch = model_zoo.input_specs(cfg, shape)
    if shape.kind == "train":
        return steps._abstract_state(cfg), batch
    params = model_zoo.abstract_params(cfg)
    if shape.kind == "prefill":
        return params, batch
    return params, model_zoo.cache_specs(cfg, shape), batch


def placed_args(cell: steps.Cell):
    """The cell's arguments placed by its specs: DTensors whose local
    shards are meta tensors."""
    return tuple(steps.placed_zeros(cell.mesh, a, s, "meta")
                 for a, s in zip(abstract_args(cell), cell.in_specs))


def run_cell(arch: Union[str, cfgs.ModelConfig],
             shape: Union[str, cfgs.ShapeSpec], *, multi_pod: bool = False,
             model: int = 8, grad_accum: Optional[int] = None,
             remat: bool = True, sp: bool = False, smoke: bool = False,
             mesh=None, verbose: bool = True) -> Dict[str, Any]:
    """Trace one cell on the production mesh (or on ``mesh``) and return
    its record."""
    if mesh is None:
        mesh = production_mesh(multi_pod=multi_pod, model=model)
    if smoke and isinstance(arch, str):
        arch = smoke_config(arch)
    t0 = time.perf_counter()
    cell = steps.build_cell(arch, shape, mesh, grad_accum=grad_accum,
                            remat=remat, sp=sp)
    roof = rl.analyze_cell(cell, *placed_args(cell))
    dt = time.perf_counter() - t0
    rec = roof.to_dict()
    rec.update({"ok": True, "compile_s": dt, "multi_pod": multi_pod})
    if verbose:
        mem = rec["memory_per_device"]
        print(f"[OK] {rec['arch']} × {rec['shape']} × {rec['mesh']} "
              f"({dt:.1f}s trace)")
        print(f"     memory/device: args={_gb(mem['argument_bytes'])} "
              f"out={_gb(mem['output_bytes'])} "
              f"temp={_gb(mem['temp_bytes'])} "
              f"{'fits' if mem['fits'] else 'DOES NOT FIT'}")
        print("     " + rl.fmt_row(roof))
    return rec


def _gb(b) -> str:
    return f"{b/2**30:.2f}GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="one arch, or several joined by commas "
                         "(default: all)")
    ap.add_argument("--shape", default=None,
                    help="one shape, or several joined by commas "
                         "(default: all)")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel layer carry for train cells")
    ap.add_argument("--optimized", action="store_true",
                    help="the per-arch train settings of TRAIN_POLICY")
    ap.add_argument("--model", type=int, default=8, choices=(8, 16),
                    help="cards on the model axis")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at head dim 64 (tests)")
    ap.add_argument("--json", default=None, help="append records to file")
    args = ap.parse_args(argv)

    archs = args.arch.split(",") if args.arch else list(cfgs.ARCH_IDS)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    records: List[Dict[str, Any]] = []
    failures: List[str] = []
    for arch in archs:
        names = args.shape.split(",") if args.shape else None
        shapes = ([cfgs.SHAPE_BY_NAME[n] for n in names] if names
                  else cfgs.cells(arch))
        for (s, reason) in cfgs.skipped_cells(arch):
            if names and s.name not in names:
                continue
            shapes = [x for x in shapes if x.name != s.name]
            records.append({"arch": arch, "shape": s.name, "ok": True,
                            "skipped": reason})
            print(f"[SKIP] {arch} × {s.name}: {reason}")
        for shape in shapes:
            for mp in meshes:
                try:
                    pol = (TRAIN_POLICY.get(arch, {})
                           if args.optimized and shape.kind == "train"
                           else {})
                    records.append(run_cell(
                        arch, shape.name, multi_pod=mp, model=args.model,
                        grad_accum=args.grad_accum or pol.get("grad_accum"),
                        remat=not args.no_remat,
                        sp=pol.get("sp", args.sp and shape.kind == "train"),
                        smoke=args.smoke))
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append(f"{arch}×{shape.name}×mp={mp}: {e}")
                    traceback.print_exc()
                    records.append({"arch": arch, "shape": shape.name,
                                    "multi_pod": mp, "ok": False,
                                    "error": str(e)})
    if args.json:
        existing = []
        try:
            with open(args.json) as f:
                existing = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        with open(args.json, "w") as f:
            json.dump(existing + records, f, indent=1)
    n_ok = sum(1 for r in records if r.get("ok"))
    print(f"\n{n_ok}/{len(records)} cells OK")
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  " + f)
        return 1
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
