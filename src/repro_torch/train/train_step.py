"""The train step for every zoo architecture: the PyTorch counterpart of
``repro.train.train_step``.

Structure (bottom to top): ``ce_loss_chunked`` (never materialises
[B,S,V]) -> :func:`loss_fn` (+ MoE aux) -> gradients -> microbatch
accumulation (in fp32, divided by the count, when ``grad_accum`` > 1) ->
AdamW update.  The state is a plain dict ``{"params", "opt_state",
"step"}`` in the port's layout (``bridge.state_to_jax`` gives the JAX
one); a step updates it in place and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import model_zoo, shardctx
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update,
                                     leaves, map_tree)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor        # int32 scalar

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step}

    @classmethod
    def from_tree(cls, t):
        return cls(t["params"], t["opt_state"], t["step"])


def init_state(model: model_zoo.Model, seed: int = 0, device="cuda",
               opt_cfg: Optional[AdamWConfig] = None) -> TrainState:
    """Params drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, zero moments, step 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init_params(gen)
    return TrainState(params, adamw_init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def loss_fn(model: model_zoo.Model, params, batch, *, remat: bool = True):
    out = model.apply(params, batch, mode="train", remat=remat)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    loss, count = model.ce_loss(params, out["hidden"], labels, mask)
    return loss + out["aux"], {"ce": loss, "aux": out["aux"],
                               "tokens": count}


def _microbatches(batch: Dict[str, Any], n: int):
    """Split the leading (batch) axis into n microbatches of consecutive
    rows, as the JAX package does.  On the mesh a DTensor batch is first
    replicated (a view cannot split a sharded axis unevenly) and each
    microbatch is placed by the batch rule again (``shardctx``)."""
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch[{name!r}] has {x.shape[0]} rows, not "
                             f"a multiple of {n} microbatches")

    def split(x):
        if not shardctx.is_dtensor(x):
            return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))

    def place(x):
        return shardctx.constrain(x, "dp", *([None] * (x.dim() - 1)))

    split_batch = {k: split(x) for k, x in batch.items()}
    return [{k: place(x[i]) for k, x in split_batch.items()}
            for i in range(n)]


def make_grad_fn(model: model_zoo.Model, *, grad_accum: int = 1,
                 remat: bool = True):
    """Returns grads(params, batch) -> (loss, aux, grads): the loss and
    its gradients (a tree like ``params``), summed in fp32 over
    ``grad_accum`` microbatches and divided by their count when it is
    over 1.  Then ``aux`` reports 0 for the MoE loss and the tokens, as
    the JAX package's accumulation branch does."""
    def forward_backward(params, batch):
        live = map_tree(lambda p: p.detach().requires_grad_(), params)
        loss, aux = loss_fn(model, live, batch, remat=remat)
        gs = iter(torch.autograd.grad(loss, leaves(live), allow_unused=True))

        def grad_of(p):
            g = next(gs)     # None where the loss does not reach p: 0 in JAX
            return torch.zeros_like(p) if g is None else g

        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                map_tree(grad_of, live))

    def grads(params, batch):
        if grad_accum <= 1:
            return forward_backward(params, batch)
        # fp32 zeros placed as the params are (DTensors on the mesh)
        acc = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        loss_sum = 0.0
        for mb in _microbatches(batch, grad_accum):
            loss, _aux, g = forward_backward(params, mb)
            for a, gi in zip(leaves(acc), leaves(g)):
                a += gi
            loss_sum = loss_sum + loss
        for a in leaves(acc):
            a /= grad_accum
        loss = loss_sum / grad_accum
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"ce": loss, "aux": zero, "tokens": zero}, acc

    return grads


def make_train_step(model: model_zoo.Model,
                    opt_cfg: Optional[AdamWConfig] = None, *,
                    grad_accum: Optional[int] = None, remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics), ``state`` the
    dict ``{"params", "opt_state", "step"}``, updated in place.  The
    gradients come from ``train_step.grads`` (:func:`make_grad_fn`) with
    ``grad_accum`` microbatches (default ``cfg.grad_accum_steps``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    accum = grad_accum or model.cfg.grad_accum_steps
    grads_of = make_grad_fn(model, grad_accum=accum, remat=remat)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        loss, aux, grads = grads_of(params, batch)
        params, opt, om = adamw_update(opt_cfg, grads, state["opt_state"],
                                       params)
        metrics = {"loss": loss, **aux, **om}
        state.update(params=params, opt_state=opt, step=state["step"] + 1)
        return state, metrics

    train_step.grads = grads_of
    return train_step


def make_eval_step(model: model_zoo.Model, *, remat: bool = False):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, aux = loss_fn(model, params, batch, remat=remat)
        return {"loss": loss, **aux}
    return eval_step
