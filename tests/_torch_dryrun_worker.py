"""The port's side of ``tests/test_torch_dryrun.py``, in a process of its
own: the dry-run starts fake worlds (``torch.distributed``'s "fake"
backend), which must not outlive a test in the pytest process.  Imports
no JAX.

    python tests/_torch_dryrun_worker.py JOB.pkl OUT.pkl

JOB: {"cells": [(arch, kind, seq_len, batch)], "dots": [(arch, kind,
seq_len, batch, mesh shape)], "comm": [(arch, kind, seq_len, batch)],
"json": path}.
"""
import os
import pickle
import sys
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


class FakeSeen(TorchDispatchMode):
    """Records whether any op ran on FakeTensors (DTensor's sharding
    propagation) while it was active."""

    def __init__(self):
        super().__init__()
        self.seen = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        self.seen += any(isinstance(a, FakeTensor) for a in args)
        return func(*args, **(kwargs or {}))


def matmul(mesh):
    """Counts of a sharded matmul on 4 ranks against one rank's, on meta
    and on CPU tensors: mm with x [64,128] Shard(0), w [128,256]
    replicated; bmm with both [4,...] Shard(0)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import op_cost
    out = {}
    for dev in ("meta", "cpu"):
        for name, xs, ws, wpl in (("mm", (64, 128), (128, 256), Replicate()),
                                  ("bmm", (4, 64, 128), (4, 128, 256),
                                   Shard(0))):
            x, w = torch.ones(xs, device=dev), torch.ones(ws, device=dev)
            _, one = op_cost.count(torch.matmul, x, w)
            xd = DTensor.from_local(torch.ones((xs[0] // 4,) + xs[1:],
                                               device=dev), mesh,
                                    (Replicate(), Shard(0)), run_check=False)
            wl = (torch.ones(ws, device=dev) if name == "mm" else
                  torch.ones((ws[0] // 4,) + ws[1:], device=dev))
            wd = DTensor.from_local(wl, mesh, (Replicate(), wpl),
                                    run_check=False)
            spy = FakeSeen()
            with spy:
                _, four = op_cost.count(torch.matmul, xd, wd, mesh=mesh)
            out[(dev, name)] = {"one": (one.flops, one.bytes),
                                "four": (four.flops, four.bytes),
                                "collectives": four.collective_bytes,
                                "fake_ops": spy.seen}
    return out


def redistributions(mesh):
    """Wire bytes by path of single redistributions of a local [8, 16]
    fp32 shard (512 bytes) on the (2, 2) mesh, one per collective kind,
    and of a c10d all-reduce of one on the model axis's group."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.launch import op_cost
    cases = {"gather_data": ((Shard(0), Replicate()),
                             (Replicate(), Replicate())),
             "gather_model": ((Replicate(), Shard(1)),
                              (Replicate(), Replicate())),
             "reduce_model": ((Replicate(), Partial()),
                              (Replicate(), Replicate())),
             "scatter_data": ((Partial(), Replicate()),
                              (Shard(0), Replicate()))}
    out = {}
    for name, (src, dst) in cases.items():
        x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh, src,
                               run_check=False)
        _, cost = op_cost.count(lambda t: t.redistribute(mesh, dst), x,
                                mesh=mesh)
        out[name] = dict(cost.collective_by_path)
    # a c10d op (the sequence-sharded decode's combine) on the model axis
    import torch.distributed as dist
    _, cost = op_cost.count(
        lambda t: dist.all_reduce(t, group=mesh.get_group("model")),
        torch.empty(8, 16, device="meta"), mesh=mesh)
    out["c10d_reduce_model"] = dict(cost.collective_by_path)
    return out


def comm_counts(cells, mesh):
    """Each cell's record, and torch's own count of its step's
    collectives (``CommDebugMode``) by op name, on meta as the dry-run
    runs it."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import base as cfgs
    from repro_torch.launch import dryrun, steps
    out = {}
    for arch, kind, S, B in cells:
        c = steps.build_cell(dryrun.smoke_config(arch),
                             cfgs.ShapeSpec(f"t_{kind}", S, B, kind), mesh,
                             grad_accum=1)
        args = dryrun.placed_args(c)
        with CommDebugMode() as cm:
            c.run(*args)
        out[(arch, kind)] = {
            "torch": {str(k).rsplit(".", 1)[-1]: v
                      for k, v in cm.get_comm_counts().items()},
            "record": cell(arch, kind, S, B, mesh)}
    return out


def cell(arch, kind, S, B, mesh, *, meta=True, smoke_hd64=True):
    """One cell's record on ``mesh``: through ``dryrun.run_cell`` on meta,
    or (``meta=False``) the same step on placed CPU zeros."""
    from repro_torch.configs import base as cfgs
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import roofline as rl
    shape = cfgs.ShapeSpec(f"t_{kind}", S, B, kind)
    cfg = (dryrun.smoke_config(arch) if smoke_hd64
           else cfgs.get_smoke_config(arch))
    if meta:
        return dryrun.run_cell(cfg, shape, mesh=mesh, grad_accum=1,
                               verbose=False)
    c = steps.build_cell(cfg, shape, mesh, grad_accum=1)
    args = tuple(steps.placed_zeros(mesh, a, s, "cpu")
                 for a, s in zip(dryrun.abstract_args(c), c.in_specs))
    return rl.analyze_cell(c, *args).to_dict()


def main(argv):
    torch.set_num_threads(1)
    with open(argv[1], "rb") as f:
        job = pickle.load(f)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    res = {"cells": {}, "dots": {}, "mesh": {}}
    try:
        dryrun.fake_world(4)
        meshes = {s: init_device_mesh("cpu", s, mesh_dim_names=("data",
                                                                "model"))
                  for s in ((2, 2), (1, 4), (4, 1))}
        try:
            make_production_mesh(device_type="cpu")
        except ValueError as e:
            res["refused"] = str(e)
        res["matmul"] = matmul(meshes[(1, 4)])
        for arch, kind, S, B, shape in job["dots"]:
            rec = cell(arch, kind, S, B, meshes[shape], meta=False,
                       smoke_hd64=False)
            res["dots"][(arch, kind, shape)] = rec["detail"]["flops_by_path"]
        for arch, kind, S, B in job["cells"]:
            res["cells"][(arch, kind)] = cell(arch, kind, S, B,
                                              meshes[(2, 2)])
        res["redistributions"] = redistributions(meshes[(2, 2)])
        res["comm"] = comm_counts(job["comm"], meshes[(2, 2)])
        for mp in (False, True):
            for model in (8, 16):
                m = dryrun.production_mesh(multi_pod=mp, model=model)
                res["mesh"][(mp, model)] = (tuple(m.shape),
                                            tuple(m.mesh_dim_names))
        res["full"] = dryrun.run_cell("proxy-8b", "decode_32k",
                                      multi_pod=False, model=8,
                                      verbose=False)
        argv_main = ["--arch", "qwen3-32b", "--shape", "decode_32k",
                     "--single-pod-only", "--smoke", "--json", job["json"]]
        res["main_rc"] = [dryrun.main(argv_main), dryrun.main(argv_main)]
    except Exception:
        res["error"] = traceback.format_exc()
    with open(argv[2], "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
