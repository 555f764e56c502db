"""End-to-end training driver: the PyTorch counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Trains on the card; ``--device cpu`` trains on the CPU instead.  By
default it trains the reduced (smoke) config, as the JAX driver does;
``--no-smoke`` takes the full-width config, and ``--layers N`` cuts its
depth to N layers (the period's pattern repeated, then the tail).
Features: deterministic resume, checkpoint/restart (in the JAX package's
format), straggler telemetry.

``--model-parallel N`` trains on a ``(world // N, N)`` mesh
(``launch/mesh.py``): the state is placed by ``launch/sharding``'s
``state_specs`` (weights and moments TP-sharded over ``model``, FSDP over
``data``), the batch by ``batch_specs``, and each step runs with the shard
context armed.  Outside a process group the launcher starts its N ranks
itself (a ``FileStore`` rendezvous in a temporary directory) and waits
for them; inside one (under ``torchrun``) the world is the group's.
``--backend`` is explicit: ``nccl`` (the default) needs a card per rank
and raises with fewer; ``gloo`` runs the ranks on the CPU or, with CUDA
tensors, shares the cards.  Checkpoints are gathered to full tensors and
written by rank 0 in the JAX package's format; a restore places them
again.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --backend gloo --model-parallel 2 --arch proxy-8b --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import sys
import tempfile
import time
from typing import Any, Dict

from repro_torch.configs import base as cfgs
from repro_torch.models import model_zoo
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import AdamWConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b",
                    choices=list(cfgs.KNOWN_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="the params' and activations' type (default: the "
                         "config's)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="steps between checkpoints (and one at the end); "
                         "0 writes none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="the process group's backend with --model-parallel "
                         "> 1 (no fallback: nccl needs a card per rank)")
    ap.add_argument("--device", default="cuda",
                    help="where to train (no fallback: without CUDA, pass "
                         "cpu)")
    return ap


def run(argv=None) -> Dict[str, Any]:
    """Train as ``main`` does and return the trainer's output (``state``,
    ``history``, ``resumed_from``, ``straggler_steps``) with the config
    under ``cfg``; prints the summary line.  A launcher that started its
    ranks returns rank 0's output without ``state``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.model_parallel > 1 or _in_group():
        return _run_mesh(args, argv)
    return _train(args)


def _in_group() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _train(args, mesh=None, device=None) -> Dict[str, Any]:
    model = model_zoo.build(args.arch, smoke=args.smoke)
    cut = {k: v for k, v in (("num_layers", args.layers),
                             ("dtype", args.dtype)) if v}
    if cut:
        model = model_zoo.build(dataclasses.replace(model.cfg, **cut))
    pipe = TokenPipeline(model.cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir)
    trainer = Trainer(
        model, pipe, ckpt,
        loop=LoopConfig(total_steps=args.steps,
                        checkpoint_every=args.ckpt_every),
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        seed=args.seed, device=device or args.device, mesh=mesh)
    out = trainer.run()
    hist = out["history"]
    if mesh is None or _rank() == 0:
        print(f"arch={args.arch} steps={len(hist)} "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"resumed_from={out['resumed_from']} "
              f"stragglers={out['straggler_steps']}", flush=True)
    return {**out, "cfg": model.cfg}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _rank_device(args, rank: int) -> str:
    import torch
    if args.device == "cpu":
        return "cpu"
    return f"cuda:{rank % torch.cuda.device_count()}"


def _check_backend(args, world: int) -> None:
    import torch
    if args.backend == "nccl":
        if args.device == "cpu":
            raise ValueError("--backend nccl runs on cards: pass --backend "
                             "gloo with --device cpu")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise ValueError(f"--backend nccl needs a card per rank: "
                             f"{world} ranks, {n} cards (pass --backend "
                             f"gloo to share them)")


def _run_mesh(args, argv) -> Dict[str, Any]:
    """Train on a mesh: inside a process group, this rank's part;
    outside one, start the ranks and wait for them."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if _in_group():
        world, rank = dist.get_world_size(), dist.get_rank()
        _check_backend(args, world)
        dev = _rank_device(args, rank)
        mesh = make_host_mesh(model=args.model_parallel,
                              device_type="cpu" if dev == "cpu" else "cuda")
        return _train(args, mesh, dev)
    world = args.model_parallel
    _check_backend(args, world)
    import torch.multiprocessing as mp
    deadline = time.time() + float(os.environ.get("REPRO_RANK_TIMEOUT",
                                                  "3600"))
    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(argv, tmp, world),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {world} ranks did not finish in "
                                   "time")
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            return pickle.load(f)


def _rank_main(rank: int, argv, tmp: str, world: int) -> None:
    """One spawned rank: join the group through a FileStore, train, and
    (rank 0) leave the run's summary for the launcher."""
    import torch
    import torch.distributed as dist
    args = _parser().parse_args(argv)
    dev = _rank_device(args, rank)
    if dev != "cpu":
        torch.cuda.set_device(torch.device(dev))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(args.backend, store=store, rank=rank,
                            world_size=world)
    try:
        out = run(argv)
        if rank == 0:
            keep = {k: v for k, v in out.items() if k != "state"}
            with open(os.path.join(tmp, "rank0.pkl"), "wb") as f:
                pickle.dump(keep, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
