"""The ranks of ``tests/test_torch_mesh.py``: a world of two CPU ranks on
gloo (rendezvous through a ``FileStore``) that runs the port's mesh path
on the jobs the test hands over in a pickle, and writes what it computed
to another.  Imports no JAX.

    python tests/_torch_mesh_worker.py JOB.pkl OUT.pkl STORE
"""
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORLD = 2


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy() if x.is_floating_point() \
        else x.detach().cpu().numpy()


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _cfg(arch, overrides):
    import dataclasses
    from repro_torch.configs import base as cfgs
    return dataclasses.replace(cfgs.get_smoke_config(arch), dtype="float32",
                               **overrides)


def _params(cfg, tree):
    from repro_torch import bridge
    return bridge.params_from_jax(cfg, tree, "cpu")


def decode_unit(job, mesh):
    """flash_decode_sharded + write_kv_sharded on a (1, 2) mesh."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.sharding import placements
    from repro_torch.models import attention as attn, shardctx
    d = _t(job)
    spec = (None, "model", None, None)
    ck = distribute_tensor(d["ck"], mesh, placements(mesh, spec),
                           src_data_rank=None)
    cv = distribute_tensor(d["cv"], mesh, placements(mesh, spec),
                           src_data_rank=None)
    rep = placements(mesh, ())
    q, kn, vn = (distribute_tensor(d[k], mesh, rep, src_data_rank=None)
                 for k in ("q", "kn", "vn"))
    with shardctx.armed(mesh):
        assert attn.seq_sharded_decode_ready(ck)
        out, ck2, cv2 = attn.sharded_cache_decode(q, ck, cv, kn, vn,
                                                  d["lengths"])
        # a length-0 row: every chunk empty, the output zeros, no NaN
        # (on copies: the write of row 0 lands at position 0)
        z = attn.sharded_cache_decode(q, ck.clone(), cv.clone(), kn, vn,
                                      torch.tensor([1, 0]))[0]
    assert ck2 is ck and cv2 is cv
    return {"out": _np(out), "ck": _np(ck), "cv": _np(cv),
            "empty": _np(z)}


class Calls:
    """Counts the calls of a module's function (wrapped in place)."""

    def __init__(self, mod, name):
        self.n, fn = 0, getattr(mod, name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        setattr(mod, name, counted)


def cells(job, mesh):
    """The prefill cell, then the decode cell on its cache."""
    from repro_torch.configs import base as cfgs
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.launch import steps
    sharded = Calls(dec_ops, "flash_decode_sharded")
    out = {}
    for case in job:
        cfg = _cfg(case["arch"], case["overrides"])
        B, S = case["B"], case["S"]
        pc = steps.build_cell(cfg, cfgs.ShapeSpec("prefill_t", S, B,
                                                  "prefill"), mesh)
        dc = steps.build_cell(cfg, cfgs.ShapeSpec("decode_t", S, B,
                                                  "decode"), mesh)
        params, batch = pc.place(_params(cfg, case["params"]),
                                 _t(case["prefill"]))
        tok, cache, logits = pc.run(params, batch)
        dbatch = steps.shd.distribute(mesh, _t(case["decode"]),
                                      dc.in_specs[2])
        before = sharded.n
        tok2, cache, logits2 = dc.run(params, cache, dbatch)
        from repro_torch.train.optim import leaves
        split = [t for t in leaves(params)
                 if tuple(t.to_local().shape) != tuple(t.shape)]
        lens, n_sharded = _np(cache["len"]), sharded.n - before
        roof = None
        if case["name"] == "proxy-8b":
            # one more decode step under the op counter: the collectives
            # of the mesh path (DTensor's and the c10d ones) are counted
            from repro_torch.launch import roofline
            roof = roofline.analyze_step(
                dc.run, (params, cache, dbatch), arch=case["arch"],
                shape="decode_t", model_flops=dc.model_flops,
                mesh=mesh).to_dict()
        out[case["name"]] = {"roofline": roof,
                             "prefill": _np(logits), "decode": _np(logits2),
                             "len": lens,
                             "sharded_decodes": n_sharded,
                             "split_leaves": len(split),
                             "leaves": len(leaves(params))}
    return out


def rg_train(job, mesh):
    """recurrentgemma's train step cell from JAX's initial state: loss
    and grad norm (the RG-LRU's log-sigmoid of its DTensor a_param has a
    backward on the mesh)."""
    from repro_torch import bridge
    from repro_torch.configs import base as cfgs
    from repro_torch.launch import steps
    cfg = _cfg(job["arch"], {})
    shape = cfgs.ShapeSpec("train_t", job["S"], job["B"], "train")
    cell = steps.build_cell(cfg, shape, mesh, grad_accum=1)
    state, batch = cell.place(bridge.state_from_jax(cfg, job["state"]),
                              _t(job["batch"]))
    _, met = cell.run(state, batch)
    return {k: float(_np(met[k])) for k in ("loss", "grad_norm")}


def moe(job, meshes):
    """Train-mode forward of the MoE smoke models: logits and aux."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import blocks, model_zoo, shardctx
    ep = Calls(blocks, "_moe_ep")
    out = {}
    for case in job:
        cfg = _cfg(case["arch"], {})
        model = model_zoo.build(cfg)
        for mname, mesh in meshes.items():
            params = _params(cfg, case["params"])
            params = shd.distribute(mesh, params, shd.param_specs(
                mesh, params, cfg=cfg))
            batch = _t(case["batch"])
            batch = shd.distribute(mesh, batch, shd.batch_specs(mesh, batch))
            before = ep.n
            with shardctx.armed(mesh), torch.no_grad():
                o = model.apply(params, batch, mode="train")
                logits = model.logits_of(params, o["hidden"])
            out[(case["arch"], mname)] = {"logits": _np(logits),
                                          "aux": _np(o["aux"]),
                                          "ep_layers": ep.n - before}
    return out


def worker(rank, job_path, out_path, store_path):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        m12 = make_host_mesh(model=2, device_type="cpu")
        m21 = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data",
                                                              "model"))
        if "decode_unit" in job:
            res["decode_unit"] = decode_unit(job["decode_unit"], m12)
        if "cells" in job:
            res["cells"] = cells(job["cells"], m12)
        if "rg_train" in job:
            res["rg_train"] = rg_train(job["rg_train"], m12)
        if "moe" in job:
            # the blocking collectives that gloo ranks on CUDA tensors
            # run, here on CPU tensors: the MoE job goes through them
            from repro_torch.launch.mesh import _LIBS, blocking_collectives
            blocking_collectives("CPU")
            try:
                res["moe"] = moe(job["moe"], {"1x2": m12, "2x1": m21})
            finally:
                _LIBS.pop("CPU")._destroy()
    except Exception:
        res["error"] = traceback.format_exc()
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def main(argv):
    job, out, store = argv[1:4]
    ctx = mp.start_processes(worker, args=(job, out, store), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = float(os.environ.get("MESH_WORKER_TIMEOUT", "240"))
    import time
    t0 = time.time()
    while not ctx.join(timeout=5):
        if time.time() - t0 > deadline:
            for p in ctx.processes:
                p.kill()
            raise SystemExit("mesh worker timed out")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
