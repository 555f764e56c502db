"""End-to-end training driver: the PyTorch counterpart of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Trains on the card; ``--device cpu`` trains on the CPU instead.  By
default it trains the reduced (smoke) config, as the JAX driver does;
``--no-smoke`` takes the full-width config, and ``--layers N`` cuts its
depth to N layers (the period's pattern repeated, then the tail).
Features: deterministic resume, checkpoint/restart (in the JAX package's
format), straggler telemetry.  One card: ``--model-parallel`` above 1
raises, since the port has no sharded train path yet.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict

from repro_torch.configs import base as cfgs
from repro_torch.models import model_zoo
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import AdamWConfig


def run(argv=None) -> Dict[str, Any]:
    """Train as ``main`` does and return the trainer's output (``state``,
    ``history``, ``resumed_from``, ``straggler_steps``) with the config
    under ``cfg``; prints the summary line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b",
                    choices=list(cfgs.KNOWN_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where to train (no fallback: without CUDA, pass "
                         "cpu)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: the port trains on one device; the mesh, "
            "sharding and shardctx come with ROADMAP item 13")
    model = model_zoo.build(args.arch, smoke=args.smoke)
    if args.layers:
        model = model_zoo.build(dataclasses.replace(model.cfg,
                                                    num_layers=args.layers))
    pipe = TokenPipeline(model.cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir)
    trainer = Trainer(
        model, pipe, ckpt,
        loop=LoopConfig(total_steps=args.steps,
                        checkpoint_every=args.ckpt_every),
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        seed=args.seed, device=args.device)
    out = trainer.run()
    hist = out["history"]
    print(f"arch={args.arch} steps={len(hist)} "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"resumed_from={out['resumed_from']} "
          f"stragglers={out['straggler_steps']}")
    return {**out, "cfg": model.cfg}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
