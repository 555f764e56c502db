"""The port's sharding rules (``repro_torch.launch.sharding``), the
analytic FLOPs of its model zoo and the collective wire-byte formulas of
``launch/op_cost.py`` held to the JAX package's, on stand-in meshes (any
object with ``.shape`` and ``.axis_names`` serves both packages: their
``_fit`` reads nothing else).

For every architecture, on its full and its smoke config: the spec of
every leaf of the params (serving and training layout), the train state,
a batch of each shape cell and the cache of each decode cell equals the
JAX package's ``PartitionSpec`` entry for entry.  The port keeps one dict
per layer where the JAX tree stacks them; a layer leaf's spec is the JAX
spec without its leading stacked ``None``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.launch import hlo_cost as jhlo  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import model_zoo, shardctx  # noqa: E402

ARCHES = tuple(jcfgs.ARCH_IDS) + tuple(jcfgs.EXTRA_IDS)
MESHES = {"16x16": {"data": 16, "model": 16}, "2x2": {"data": 2, "model": 2}}


def _mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _cfgs(arch, smoke):
    if smoke:
        return jcfgs.get_smoke_config(arch), cfgs.get_smoke_config(arch)
    return jcfgs.get_config(arch), cfgs.get_config(arch)


def _jax_specs(spec_tree):
    """{key path: spec tuple} of a JAX tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jshd._key_of(p): tuple(s) for p, s in flat[0]}


def _port_specs(spec_tree, cfg):
    """{JAX key path: (spec, per-layer leaf?)} of a port spec tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            key = shd._key_of(path, cfg)
            layered = any(isinstance(p, int) for p in path)
            if key in out:
                assert out[key] == (tuple(t), layered), key
            out[key] = (tuple(t), layered)
    walk(spec_tree, ())
    return out


def _stacked(key):
    return key.split("/")[0] in ("periods", "enc_layers", "dec_layers") or \
        "/periods/" in key or "/enc_layers/" in key or "/dec_layers/" in key


def _assert_same(port_tree, jax_tree, cfg):
    got = _port_specs(port_tree, cfg)
    want = _jax_specs(jax_tree)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key, (spec, layered) in got.items():
        w = want[key]
        if layered and _stacked(key) and w:
            assert w[0] is None, (key, w)
            w = w[1:]
        assert spec == w, (key, spec, w)


def _port_state(params):
    zeros = lambda t: torch.empty(t.shape, dtype=torch.float32,  # noqa: E731
                                  device="meta")
    from repro_torch.train.optim import map_tree
    return {"params": params,
            "opt_state": {"mu": map_tree(zeros, params),
                          "nu": map_tree(zeros, params),
                          "count": torch.empty((), dtype=torch.int32,
                                               device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _jax_state(model):
    from repro.launch.steps import _abstract_state
    return _abstract_state(model)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHES)
def test_specs_equal_jax(arch, smoke):
    jcfg, cfg = _cfgs(arch, smoke)
    jmodel = jzoo.build(jcfg)
    jparams = jax.eval_shape(lambda: jmodel.init_params(
        jax.random.PRNGKey(0)))
    params = model_zoo.abstract_params(cfg)
    jstate = _jax_state(jmodel)
    state = _port_state(params)
    for sizes in MESHES.values():
        jm, m = _mesh(sizes), _mesh(sizes)
        for fsdp in ("data", None):
            _assert_same(shd.param_specs(m, params, fsdp=fsdp, cfg=cfg),
                         jshd.param_specs(jm, jparams, fsdp=fsdp), cfg)
        _assert_same(shd.state_specs(m, state, cfg=cfg),
                     jshd.state_specs(jm, jstate), cfg)
        for js, s in zip(jcfgs.SHAPES, cfgs.SHAPES):
            _assert_same(shd.batch_specs(m, model_zoo.input_specs(cfg, s)),
                         jshd.batch_specs(jm, jzoo.input_specs(jcfg, js)),
                         cfg)
            if s.kind == "decode":
                _assert_same(
                    shd.cache_specs_tree(m, model_zoo.cache_specs(cfg, s)),
                    jshd.cache_specs_tree(jm, jzoo.cache_specs(jcfg, js)),
                    cfg)


@pytest.mark.parametrize("arch", ARCHES)
def test_input_and_cache_shapes_equal_jax(arch):
    jcfg, cfg = _cfgs(arch, True)
    for js, s in zip(jcfgs.SHAPES, cfgs.SHAPES):
        jb = jzoo.input_specs(jcfg, js)
        b = model_zoo.input_specs(cfg, s)
        assert set(b) == set(jb)
        for k in b:
            assert tuple(b[k].shape) == jb[k].shape, k
            assert str(b[k].dtype).split(".")[-1] == str(jb[k].dtype), k


@pytest.mark.parametrize("arch", ARCHES)
def test_model_and_attention_flops_equal_jax(arch):
    for smoke in (False, True):
        jcfg, cfg = _cfgs(arch, smoke)
        for js, s in zip(jcfgs.SHAPES, cfgs.SHAPES):
            assert model_zoo.model_flops(cfg, s) == jzoo.model_flops(jcfg, js)
            assert (model_zoo.attention_flops(cfg, s)
                    == jzoo.attention_flops(jcfg, js))


def test_layer_keys_are_the_jax_keys():
    cfg = cfgs.get_smoke_config("recurrentgemma-9b")   # 1 period of 3, 2 tail
    assert (cfg.period, cfg.num_periods, len(cfg.tail)) == (
        ("rglru", "rglru", "local"), 1, 2)
    assert shd._key_of(("layers", 0, "rec", "in_x"), cfg) == \
        "periods/b0/rec/in_x"
    assert shd._key_of(("layers", 2, "attn", "wq"), cfg) == \
        "periods/b2/attn/wq"
    assert shd._key_of(("layers", 4, "mlp", "wi"), cfg) == "tail/t1/mlp/wi"
    assert shd._key_of(("opt_state", "mu", "dec_layers", 3, "attn", "wq"),
                       cfg) == "opt_state/mu/dec_layers/attn/wq"
    with pytest.raises(ValueError):
        shd._key_of(("layers", 0, "attn", "wq"))


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 16])
def test_wire_bytes_equal_jax(kind, group):
    for rb, ob in ((1000, 1000), (1600, 100), (64, 1024)):
        assert op_cost._wire_bytes(kind, rb, ob, group) == \
            pytest.approx(jhlo._wire_bytes(kind, rb, ob, group))


def test_constrain_is_a_noop_when_disarmed():
    assert not shardctx.enabled()
    x = torch.arange(12.0).reshape(3, 4)
    assert shardctx.constrain(x, "dp", "tp") is x
    shardctx.enable(_mesh({"data": 1, "model": 2}))
    try:
        assert shardctx.constrain(x, "dp", "tp") is x   # a plain tensor
        assert shardctx.dp_for(3) == ("data",)
        assert shardctx.resolve(shardctx.mesh_info()[0], (3, 4),
                                ("dp", "tp")) == (("data",), "model")
        assert shardctx.resolve(shardctx.mesh_info()[0], (3, 5),
                                ("dp", "tp")) == (("data",), None)
    finally:
        shardctx.disable()
    assert shardctx.mesh_info() == (None, None, None)


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh({"data": 2, "model": 2})
    assert shd.placements(m, (None, "data", "model")) == (Shard(1), Shard(2))
    assert shd.placements(m, (("data",), None)) == (Shard(0), Replicate())
    assert shd.placements(m, ()) == (Replicate(), Replicate())


@pytest.mark.parametrize("n", [2, 4])
def test_combine_partials_over_chunks(n):
    """``combine_partials``, the combine of ``flash_decode_sharded``, over
    the plain flash-decode of n sequence chunks (its all-reduces as
    reductions over the stacked chunks) equals one pass over the whole
    cache on every row that holds a key.  An empty chunk weighs 0 whatever
    its lse (the TPU kernel writes 0 there), and a row whose every chunk
    is empty gives zeros."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    rng = np.random.default_rng(5)
    B, Smax, KV, H, hd = 5, 64, 2, 8, 16
    q, kc, vc = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                 for s in [(B, 1, H, hd), (B, Smax, KV, hd),
                           (B, Smax, KV, hd)])
    lengths = torch.tensor([0, 1, 20, 40, 64], dtype=torch.int32)
    chunk = Smax // n
    outs, lses, locs = [], [], []
    for c in range(n):
        loc = dec_ops.chunk_lengths(lengths, c, chunk)
        o, lse = dec_ops.flash_decode(q, kc[:, c * chunk:(c + 1) * chunk],
                                      vc[:, c * chunk:(c + 1) * chunk], loc,
                                      return_lse=True)
        outs.append(o)
        lses.append(torch.where((loc == 0)[:, None, None],
                                torch.zeros_like(lse), lse))
        locs.append(loc)

    def over_chunks(t, op):
        r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
        return r.expand_as(t).clone()
    got = dec_ops.combine_partials(torch.stack(outs), torch.stack(lses),
                                   torch.stack(locs), over_chunks)
    assert torch.isfinite(got).all()
    for c in range(1, n):
        assert torch.equal(got[c], got[0])
    whole = dec_ops.flash_decode(q[1:], kc[1:], vc[1:], lengths[1:])
    torch.testing.assert_close(got[0][1:], whole, atol=1e-5, rtol=1e-5)
    assert torch.equal(got[0][0], torch.zeros_like(got[0][0]))
