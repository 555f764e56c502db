"""Where a dry-run cell's wire bytes come from: each collective of the
step, as ``launch/op_cost`` counts it, filed under the DTensor op that
issued it (its redistribution) and the line of ``repro_torch`` that
called that op; and the counter's counts by kind beside those of
torch's own ``CommDebugMode`` over the same step, so a collective
counted twice or missed shows.

    PYTHONPATH=src python tools/dryrun_collectives.py \\
        --arch qwen3-32b --shape train_4k --layers 2 [--multi-pod] \\
        [--model 8] [--top 25]

Runs as rank 0 of a fake world on meta tensors, as ``launch/dryrun.py``
does (no card).  ``--layers`` cuts the depth (each layer adds the same
collectives); the train cell keeps its config's gradient accumulation.
Prints one line a (op, kind, axis, local input shape, source line) with
its count and wire bytes, largest first.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import traceback

import torch

from repro_torch.configs import base as cfgs
from repro_torch.launch import dryrun, op_cost, steps

# torch's collective ops (CommDebugMode's names) by the kind they are
_KIND = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
         "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all"}


class Attributed(op_cost.OpCounter):
    """The counter, with each collective's wire bytes also filed under
    the DTensor op being run and the ``repro_torch`` line that ran it."""

    def __init__(self, mesh):
        super().__init__(mesh=mesh)
        self.op = None
        self.rows = collections.defaultdict(lambda: [0, 0.0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        name = func._schema.name.split("::")[-1]
        if any(issubclass(t, DTensor) for t in types):
            self.op = name
        before = dict(self.cost.collective_by_path)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if name in op_cost._COLLECTIVE_OPS:
            for path, b in self.cost.collective_by_path.items():
                if b != before.get(path, 0.0):
                    ins = op_cost._tensors(args)
                    key = (self.op, path, tuple(ins[0].shape) if ins
                           else (), _caller())
                    self.rows[key][0] += 1
                    self.rows[key][1] += b - before.get(path, 0.0)
        return out


def _caller() -> str:
    for f in reversed(traceback.extract_stack()):
        if ("repro_torch" in f.filename
                and not f.filename.endswith("op_cost.py")):
            return (f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} "
                    f"{f.name}")
    return "?"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model", type=int, default=8, choices=(8, 16))
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = cfgs.get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    mesh = dryrun.production_mesh(multi_pod=args.multi_pod,
                                  model=args.model)
    cell = steps.build_cell(cfg, args.shape, mesh)
    counter = Attributed(mesh)
    with counter:
        cell.run(*dryrun.placed_args(cell))
    cost = counter.cost
    with CommDebugMode() as cm:
        cell.run(*dryrun.placed_args(cell))
    theirs = collections.Counter()
    for k, n in cm.get_comm_counts().items():
        theirs[_KIND[str(k).rsplit(".", 1)[-1]]] += n
    print(f"{args.arch} x {args.shape} at {cfg.num_layers} layers on "
          f"{dryrun.rl.mesh_name(mesh)}: wire bytes a device "
          f"{cost.collective_bytes / 1e9:.3f} GB")
    print("  by path (GB): " + ", ".join(
        f"{p} {b / 1e9:.3f}" for p, b in sorted(
            cost.collective_by_path.items(), key=lambda kv: -kv[1])))
    print(f"  counts: counter {dict(sorted(cost.collective_counts.items()))}"
          f", CommDebugMode {dict(sorted(theirs.items()))}")
    same = dict(theirs) == cost.collective_counts
    print(f"  counts equal: {same}")
    print("  count | wire GB | path | DTensor op | local input | caller")
    rows = sorted(counter.rows.items(), key=lambda kv: -kv[1][1])
    for (op, path, shape, where), (n, b) in rows[:args.top]:
        print(f"  {n:5d} | {b / 1e9:9.3f} | {path} | {op} | {list(shape)} "
              f"| {where}")
    return 0 if same else 1


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
