"""Training loop with the fleet-operations envelope: the PyTorch
counterpart of ``repro.train.loop``.

  * checkpoint every N steps + auto-resume from the newest valid one
    (the checkpoint holds the state in the JAX layout, so a run of either
    package resumes in the other);
  * injected failures (``FailureInjector``) exercise the crash-restart
    path end-to-end in tests;
  * straggler watchdog: per-step wall-time EWMA; steps slower than
    ``straggler_factor``x the EWMA are counted and surfaced;
  * deterministic data: resuming at step k replays exactly batch k.

A step's time ends when its loss reaches the host (``.item()``), which
waits for the card as JAX's ``block_until_ready`` does.

Given a ``mesh`` (``launch/mesh.py``), the trainer places the state by
``launch/sharding.state_specs`` and each batch by ``batch_specs`` and runs
each step with the shard context armed; every rank draws the same fresh
state from the seed.  A checkpoint is gathered to full tensors on every
rank and written by rank 0; a restore reads it on every rank and places
it again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import bridge
from repro_torch.launch import sharding
from repro_torch.models import model_zoo, shardctx
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import TokenPipeline
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.train_step import init_state, make_train_step


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given global steps (before commit)."""
    fail_at_steps: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 20
    checkpoint_every: int = 5       # 0: write no checkpoint
    straggler_factor: float = 3.0
    log_every: int = 5


class Trainer:
    def __init__(self, model: model_zoo.Model, pipeline: TokenPipeline,
                 ckpt: CheckpointManager, *,
                 loop: Optional[LoopConfig] = None,
                 opt: Optional[AdamWConfig] = None,
                 injector: Optional[FailureInjector] = None,
                 seed: int = 0, device="cuda", mesh=None):
        self.model = model
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.loop_cfg = loop or LoopConfig()
        self.opt_cfg = opt or AdamWConfig()
        self.injector = injector
        self.seed = seed
        self.device = torch.device(device)
        self.mesh = mesh
        self.step_fn = make_train_step(model, self.opt_cfg)
        self.history: List[Dict[str, float]] = []
        self.straggler_steps = 0
        self.resumed_from: Optional[int] = None

    # ------------------------------------------------------------------
    def _fresh_state(self):
        return init_state(self.model, self.seed, self.device).tree()

    def _place(self, tree, specs):
        return tree if self.mesh is None else sharding.distribute(
            self.mesh, tree, specs)

    def _step(self, state, batch):
        if self.mesh is None:
            return self.step_fn(state, batch)
        with shardctx.armed(self.mesh):
            return self.step_fn(state, batch)

    def _save(self, step: int, state) -> None:
        """Write the state in the JAX layout: on a mesh, gathered to full
        tensors on every rank (a collective) and written by rank 0."""
        cfg = self.model.cfg
        if self.mesh is None:
            self.ckpt.save(step, bridge.state_to_jax(cfg, state))
            return
        import torch.distributed as dist
        full = _full_tree(state)
        if dist.get_rank() == 0:
            self.ckpt.save(step, bridge.state_to_jax(cfg, full))
        del full
        dist.barrier()

    def run(self) -> Dict[str, Any]:
        cfg = self.model.cfg
        state = self._fresh_state()
        latest = self.ckpt.restore_latest(bridge.state_dtypes(cfg, state))
        start = 0
        if latest is not None:
            start, tree = latest
            del state
            state = bridge.state_from_jax(cfg, tree, self.device)
            self.resumed_from = start
        if self.mesh is not None:
            state = self._place(state, sharding.state_specs(
                self.mesh, state, cfg=cfg))
        ewma = None
        for step in range(start, self.loop_cfg.total_steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            if self.mesh is not None:
                batch = self._place(batch, sharding.batch_specs(self.mesh,
                                                                batch))
            t0 = time.perf_counter()
            if self.injector is not None:
                self.injector.maybe_fail(step)
            state, metrics = self._step(state, batch)
            loss = _item(metrics["loss"])
            dt = time.perf_counter() - t0
            if ewma is None:
                ewma = dt
            elif dt > self.loop_cfg.straggler_factor * ewma:
                self.straggler_steps += 1
            ewma = 0.9 * (ewma or dt) + 0.1 * dt
            self.history.append({"step": step + 1, "loss": loss,
                                 "grad_norm": _item(metrics["grad_norm"]),
                                 "seconds": dt})
            done = step + 1
            every = self.loop_cfg.checkpoint_every
            if every > 0 and (done % every == 0
                              or done == self.loop_cfg.total_steps):
                self._save(done, state)
        return {"state": state, "history": self.history,
                "straggler_steps": self.straggler_steps,
                "resumed_from": self.resumed_from}


def _item(x) -> float:
    """A scalar (a DTensor's full value on the mesh) as a float."""
    if shardctx.is_dtensor(x):
        x = x.full_tensor()
    return x.item()


def _full_tree(tree):
    """The tree with every DTensor gathered to its full tensor."""
    if isinstance(tree, dict):
        return {k: _full_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_full_tree(v) for v in tree]
    return tree.full_tensor() if shardctx.is_dtensor(tree) else tree


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 4) -> Dict[str, Any]:
    """Supervisor: restart the trainer on failure (the fleet controller)."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            out = trainer.run()
            out["restarts"] = restarts
            return out
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
