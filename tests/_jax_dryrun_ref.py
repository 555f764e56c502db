"""The JAX package's references for ``tests/test_torch_dryrun.py``: run in a
process of its own, with ``XLA_FLAGS`` asking for 512 host devices before
JAX is first imported (the pytest process has one).

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \
        python tests/_jax_dryrun_ref.py JOB.pkl OUT.pkl

JOB: {"cells": [(arch, kind, seq_len, batch)], "dots": [(arch, kind,
seq_len, batch, mesh shape)], "exact_train": arch}.  The cells are the
smoke configs at head dim 64 (``repro_torch.launch.dryrun.smoke_config``'s
rule, applied here to the JAX configs) on a (2, 2) mesh of the first four
devices; the dots cells are the plain smoke configs.  OUT: the production
meshes' shapes and axis names, each cell's per-device argument bytes,
and the per-partition dot FLOPs of the dots cells.
"""
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402


def _mesh(shape):
    auto = (jax.sharding.AxisType.Auto,) * 2
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"), axis_types=auto)


def _hd64(cfg):
    import dataclasses
    from repro.configs import base as cfgs
    if not (cfg.is_encoder_decoder or any(
            b in (cfgs.ATTN, cfgs.LOCAL_ATTN) for b in cfg.block_pattern)):
        return cfg
    cfg = dataclasses.replace(cfg, head_dim=64)
    if cfg.mrope_sections:
        cfg = dataclasses.replace(cfg, mrope_sections=(8, 12, 12))
    return cfg


def _shape(kind, S, B):
    from repro.configs import base as cfgs
    name = f"t_{kind}_{S}_{B}"
    cfgs.SHAPE_BY_NAME[name] = cfgs.ShapeSpec(name, S, B, kind)
    return name


def _shard_bytes(cell) -> int:
    """Per-device bytes of the cell's arguments: each leaf's shard shape
    under its NamedSharding (what XLA allocates for a parameter)."""
    from repro.launch import sharding as shd
    total = 0
    for avals, spec in zip(cell.in_avals, cell.in_shardings):
        sh = shd.named(cell.mesh, spec)
        for a, s in zip(jax.tree.leaves(avals), jax.tree.leaves(
                sh, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))):
            total += int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
    return total


def _lower_all(cell):
    """``cell.lower()`` with ``keep_unused=True``: jax.jit drops by default
    the arguments a step never reads (a parallel block's ln2, whisper's
    encoder in a decode step), which the port's step holds all the same."""
    from repro.launch import sharding as shd
    from repro.models import shardctx
    shardctx.enable(cell.mesh, sp=cell.sp)
    try:
        with cell.mesh:
            return jax.jit(
                cell.fn, in_shardings=shd.named(cell.mesh, cell.in_shardings),
                out_shardings=shd.named(cell.mesh, cell.out_shardings),
                donate_argnums=cell.donate, keep_unused=True,
            ).lower(*cell.in_avals)
    finally:
        shardctx.disable()


def main(argv):
    with open(argv[1], "rb") as f:
        job = pickle.load(f)
    assert len(jax.devices()) == 512, len(jax.devices())
    from repro.configs import base as cfgs
    from repro.launch import hlo_cost, steps
    from repro.launch.mesh import make_production_mesh
    res = {"mesh": {}, "args": {}, "dots": {}}
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        res["mesh"][mp] = (tuple(m.devices.shape), tuple(m.axis_names))
    plain = cfgs.get_smoke_config
    mesh = _mesh((2, 2))
    cfgs.get_smoke_config = lambda a: _hd64(plain(a))
    try:
        for arch, kind, S, B in job["cells"]:
            cell = steps.build_cell(arch, _shape(kind, S, B), mesh,
                                    smoke=True)
            if kind == "train" and arch != job["exact_train"]:
                # XLA's compile of a train step takes seconds; its
                # argument bytes are the shard sums (checked on one)
                res["args"][(arch, kind)] = _shard_bytes(cell)
                continue
            ma = _lower_all(cell).compile().memory_analysis()
            res["args"][(arch, kind)] = int(ma.argument_size_in_bytes)
            if kind == "train":
                res["train_shard_sum"] = _shard_bytes(cell)
    finally:
        cfgs.get_smoke_config = plain
    for arch, kind, S, B, shape in job["dots"]:
        cell = steps.build_cell(arch, _shape(kind, S, B), _mesh(shape),
                                smoke=True)
        hc = hlo_cost.analyze_hlo(cell.lower().compile().as_text())
        res["dots"][(arch, kind, shape)] = float(
            sum(hc.flops_by_path.values()))
    with open(argv[2], "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
