#!/usr/bin/env python3
"""Where the two-rank decode's distance from one rank comes from.

``chip_smoke.py``'s mesh phase runs proxy-8b's decode cell on two gloo
ranks sharing one card, on a (data=1, model=2) mesh: the weights tensor-
parallel and the cache sequence-sharded, so each rank's K1 covers its
chunk and the chunks are combined by logsumexp.  This probe runs that
cell at the same size (full width, B=4, the 32768-slot bf16 cache filled
from the same seeds, 4 steps fed the one-rank path's greedy tokens)
twice on the two ranks: ``sequence`` as the served path runs it;
``gathered`` with every call of ``flash_decode_sharded`` also gathering
the layer's cache and running K1 over the whole of it, and carrying on
with that output, so that only the tensor-parallel sums differ from one
rank.  Then ``fp32``: the served path with the weights and the cache in
fp32 at full depth (38 GB a rank, which ``chip_smoke.py`` cannot hold
beside its own process, so it runs 16 layers).  It prints the largest
relative L2 between the combined and the whole-cache outputs (the
combine's own error), and, for each run held to the unarmed one-rank
path of its dtype, each step's largest row relative L2.

    python3 tools/mesh_probe.py

Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

SPLITS = ("sequence", "gathered")


def configs():
    """proxy-8b at full width in bf16 (as served) and in fp32."""
    cfg = smoke.mesh_configs()["bf16"]
    return {"bf16": cfg, "fp32": dataclasses.replace(cfg, dtype="float32")}


def reference(torch, tmp: str) -> None:
    """The unarmed one-rank path's tokens and logits in each dtype, into
    ``tmp``/mesh_<bf16|fp32>.pt."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store1"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, device_type="cuda")
        for tag, cfg in configs().items():
            _, _, _, tokens, logits, _ = smoke.mesh_unarmed(torch, cfg, mesh,
                                                            dev)
            torch.save({"tokens": tokens.cpu(), "logits": logits},
                       str(Path(tmp) / f"mesh_{tag}.pt"))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def gathered_decode(orig, dec_ops, errs: list):
    """``flash_decode_sharded`` run as ``orig`` runs it and as one K1
    launch over the layer's whole cache (gathered on every rank): appends
    the relative L2 between the two to ``errs`` and returns the whole-cache
    output."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def fn(q, k_cache, v_cache, lengths, *, mesh, seq_axis, dp_axes,
           **kw):
        out = orig(q, k_cache, v_cache, lengths, mesh=mesh,
                   seq_axis=seq_axis, dp_axes=dp_axes, **kw)
        whole = dec_ops.flash_decode(full(q), full(k_cache), full(v_cache),
                                     full(lengths))
        errs.append(float((full(out).float() - whole.float()).norm()
                          / whole.float().norm()))
        return DTensor.from_local(whole, mesh, out.placements,
                                  run_check=False)
    return fn


def rank_main(rank: int, tmp: str, n: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.configs import base as cfgs
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store2"), n), rank=rank, world_size=n)
    try:
        mesh = make_host_mesh(model=n, device_type="cuda")
        cfg = configs()["bf16"]
        model = model_zoo.build(cfg)
        shape = cfgs.ShapeSpec("decode_32k_b4", smoke.MESH_SLOTS,
                               smoke.MESH_B, "decode")
        cell = steps.build_cell(cfg, shape, mesh)
        params, = cell.place(model.init_params(
            torch.Generator(device=dev).manual_seed(smoke.SEED)))
        ref = torch.load(str(Path(tmp) / "mesh_bf16.pt"))
        res = {}
        orig = dec_ops.flash_decode_sharded
        for split in SPLITS:
            cache = cell.zeros_cache(dev)
            smoke.fill_mesh_cache(torch, cache, rank)
            errs = []
            if split == "gathered":
                dec_ops.flash_decode_sharded = gathered_decode(orig, dec_ops,
                                                               errs)
            try:
                got, ms, k1, sharded = smoke.mesh_decode(
                    torch, cell, params, cache, ref["tokens"].to(dev),
                    dec_ops)
            finally:
                dec_ops.flash_decode_sharded = orig
            rel = ((got - ref["logits"]).norm(dim=-1)
                   / ref["logits"].norm(dim=-1))              # [STEPS, B]
            res[split] = {"rel": rel, "ms": ms, "calls": sharded,
                          "combine": max(errs, default=None)}
            del cache
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out = smoke.mesh_rank_proxy(torch, mesh, rank, n, tmp,
                                    configs()["fp32"], "fp32")
        ref = torch.load(str(Path(tmp) / "mesh_fp32.pt"))
        rel = ((out["logits"] - ref["logits"]).norm(dim=-1)
               / ref["logits"].norm(dim=-1))
        res["fp32"] = {"rel": rel, "ms": out["step_ms"],
                       "calls": out["sharded"], "combine": None,
                       "peak_gb": out["peak_gb"]}
        torch.save(res, str(Path(tmp) / f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("mesh_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.card_line())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_probe_") as tmp:
        reference(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        mp.start_processes(rank_main, args=(tmp, 2), nprocs=2,
                           start_method="spawn")
        res = torch.load(str(Path(tmp) / "rank0.pt"))
    for split in SPLITS + ("fp32",):
        r = res[split]
        steps = [f"{float(x):.4g}" for x in r["rel"].max(dim=1).values]
        comb = ("" if r["combine"] is None else f", combined vs "
                f"whole-cache K1 largest rel. L2 {r['combine']:.4g}")
        if "peak_gb" in r:
            comb += f", peak {r['peak_gb']:.1f} GB a rank"
        print(f"mesh_probe {split}: {r['calls']} calls of "
              f"flash_decode_sharded{comb}; step median "
              f"{statistics.median(r['ms']):.1f} ms; largest row rel. L2 "
              f"against one rank {float(r['rel'].max()):.4g}, by step "
              f"{steps}")
    print(f"mesh_probe: {time.perf_counter() - t0:.1f} s; "
          f"{smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
