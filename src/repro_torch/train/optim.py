"""AdamW over the port's param trees: the PyTorch counterpart of
``repro.train.optim`` (not ``torch.optim.AdamW``, whose arithmetic
differs).

Moments are fp32 whatever the (bf16) param dtype; the update runs in fp32
and casts back, the standard mixed-precision recipe.  Every scalar
(learning rate, clip scale, bias corrections) is an fp32 tensor computed
in the JAX package's order, so the two agree to the last bits that fp32
elementwise arithmetic leaves.  The update is made in place, leaf by
leaf, under ``torch.no_grad()``: at full width the moments are the
largest tensors on the card, and a second copy of them does not fit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def map_tree(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``, called in
    the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay (an fp32 scalar on ``step``'s
    device)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step, in place: ``params``, ``opt_state["mu"]`` and
    ``["nu"]`` are overwritten and ``opt_state["count"]`` replaced.
    Returns (params, opt_state, metrics)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=count.device),
                          count.to(torch.float32))
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=count.device),
                          count.to(torch.float32))
    for p, g, mu, nu in zip(leaves(params), leaves(grads),
                            leaves(opt_state["mu"]), leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
