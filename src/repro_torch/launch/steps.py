"""Step cells: the PyTorch counterpart of ``repro.launch.steps``.

``build_cell(arch, shape, mesh)`` returns a :class:`Cell`: the step
function of one (arch x shape) cell and the specs its inputs are placed
by.  The JAX package lowers a cell ahead of time; PyTorch has no such
step, so a port cell runs: :meth:`Cell.place` distributes the inputs by
the specs (``launch/sharding``) and :meth:`Cell.run` calls the step with
the shard context armed around it, as ``Cell.lower`` does.

Cell kinds:
  train   -> train_step(state, batch) -> (state, metrics)   (AdamW)
  prefill -> prefill_step(params, batch) -> (next tokens, cache, logits)
  decode  -> serve_step(params, cache, batch) -> (next tokens, cache,
             logits)                    (one token against the cache)

The serving steps also return the last position's logits (fp32, full),
which the JAX cells leave out, so that a run can be held to a reference.
``shape`` is a name of ``configs.base.SHAPES`` or any ``ShapeSpec`` (a
cell runs, so the tests use small ones).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.configs import base as cfgs
from repro_torch.launch import sharding as shd
from repro_torch.models import model_zoo, shardctx
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class Cell:
    arch: str
    shape: cfgs.ShapeSpec
    mesh: Any
    model: model_zoo.Model
    fn: Callable
    in_specs: Tuple[Any, ...]        # one spec tree per argument of fn
    model_flops: float
    sp: bool = False                 # sequence parallelism on the carry

    def place(self, *args):
        """Distribute the arguments (full tensors, the same on every rank)
        by ``in_specs``, in place; returns them."""
        return tuple(shd.distribute(self.mesh, a, s)
                     for a, s in zip(args, self.in_specs))

    def zeros_cache(self, device):
        """The cell's cache of zeros, placed by its specs (each rank
        allocates only its shard)."""
        meta = model_zoo.cache_specs(self.model.cfg, self.shape)
        return placed_zeros(self.mesh, meta, shd.cache_specs_tree(
            self.mesh, meta), device)

    def run(self, *args):
        """The step on placed arguments, with the shard context armed."""
        with shardctx.armed(self.mesh, sp=self.sp):
            if self.shape.kind == "train":
                return self.fn(*args)
            with torch.no_grad():
                return self.fn(*args)


def placed_zeros(mesh, meta_tree, specs, device):
    """A tree of zero DTensors shaped as ``meta_tree`` and placed by
    ``specs``: each rank allocates its own shard only."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, s):
        pl = shd.placements(mesh, s)
        shape, _ = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, pl)
        return DTensor.from_local(
            torch.zeros(tuple(shape), dtype=t.dtype, device=device), mesh,
            pl, run_check=False, shape=tuple(t.shape),
            stride=_contiguous_stride(tuple(t.shape)))

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, si) for v, si in zip(t, s)]
        return one(t, s)
    return walk(meta_tree, specs)


def _contiguous_stride(shape):
    """The strides of a contiguous tensor of ``shape`` (nothing made: a
    dry-run counts every tensor its step makes)."""
    out, step = [], 1
    for n in reversed(shape):
        out.append(step)
        step *= max(n, 1)
    return tuple(reversed(out))


def _full(x):
    return x.full_tensor() if shardctx.is_dtensor(x) else x


def _abstract_state(cfg):
    params = model_zoo.abstract_params(cfg)
    from repro_torch.train.optim import map_tree

    def zeros(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": params,
            "opt_state": {"mu": map_tree(zeros, params),
                          "nu": map_tree(zeros, params), "count": scalar},
            "step": scalar}


def build_cell(arch: Union[str, cfgs.ModelConfig],
               shape: Union[str, cfgs.ShapeSpec], mesh, *,
               smoke: bool = False, grad_accum: Optional[int] = None,
               remat: bool = True, sp: bool = False) -> Cell:
    if isinstance(arch, cfgs.ModelConfig):
        cfg = arch
    else:
        cfg = cfgs.get_smoke_config(arch) if smoke else cfgs.get_config(arch)
    if isinstance(shape, str):
        shape = cfgs.SHAPE_BY_NAME[shape]
    model = model_zoo.build(cfg)
    batch_spec = shd.batch_specs(mesh, model_zoo.input_specs(cfg, shape))
    mf = model_zoo.model_flops(cfg, shape)
    name = cfg.name

    if shape.kind == "train":
        state_spec = shd.state_specs(mesh, _abstract_state(cfg), cfg=cfg)
        step_fn = make_train_step(model, AdamWConfig(),
                                  grad_accum=grad_accum, remat=remat)
        return Cell(name, shape, mesh, model, step_fn,
                    (state_spec, batch_spec), mf, sp=sp)

    dp_size = 1
    for a, n in shd.axis_sizes(mesh).items():
        if a != "model":
            dp_size *= n
    # serving weight layout: TP-only when DP has batch to split; B=1
    # long-context cells keep FSDP weight sharding
    serve_fsdp = None if shape.global_batch % dp_size == 0 else "data"
    params_spec = shd.param_specs(mesh, model_zoo.abstract_params(cfg),
                                  fsdp=serve_fsdp, cfg=cfg)
    B, S = shape.global_batch, shape.seq_len
    cache_meta = model_zoo.cache_specs(cfg, shape)
    cache_spec = shd.cache_specs_tree(mesh, cache_meta)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            dev = _device_of(params)
            cache = placed_zeros(mesh, cache_meta, cache_spec, dev)
            out = model.apply(params, batch, mode="prefill", cache=cache)
            logits = _full(model.logits_of(params, out["last_hidden"]))
            return (torch.argmax(logits, -1).to(torch.int32), out["cache"],
                    logits)
        return Cell(name, shape, mesh, model, prefill_step,
                    (params_spec, batch_spec), mf, sp=sp)

    def serve_step(params, cache, batch):
        out = model.apply(params, batch, mode="decode", cache=cache)
        logits = _full(model.logits_of(params, out["hidden"][:, 0]))
        return (torch.argmax(logits, -1).to(torch.int32), out["cache"],
                logits)
    return Cell(name, shape, mesh, model, serve_step,
                (params_spec, cache_spec, batch_spec), mf, sp=sp)


def _device_of(tree) -> torch.device:
    """The device of a tree's first tensor (its local shard's)."""
    from repro_torch.train.optim import leaves
    t = leaves(tree)[0]
    return (t.to_local() if shardctx.is_dtensor(t) else t).device
