"""The port's roofline (``repro_torch.launch.roofline``, ``op_cost``)
held to the JAX package's on the CPU.

  * The dot FLOPs the port counts at op boundaries for proxy-8b's fp32
    smoke prefill, decode and train steps equal the sum of the JAX
    package's ``flops_by_path`` (its HLO walk, ``hlo_cost.analyze_hlo``,
    what ``roofline.analyze_jitted`` runs) on the same step, within 1%.
    The train step takes two chunks of the loss (S = 1024 against the
    chunk of 512): over one chunk XLA unrolls the loss loop and drops
    the checkpointed recompute of its logits product, which eager
    PyTorch runs (``PERF.md``).
  * ``Roofline.to_dict`` has the JAX package's keys; the H100 constants
    are the data sheet's.
  * A kernel's reported work reaches the counter (the kernels launch
    through ctypes, below the dispatcher).
  * ``backend_roofline()`` keeps the contract of
    ``tests/test_backend.py::test_backend_stats_and_roofline``: kinds
    prefill and decode, tokens_per_step > 0, 0 <= mfu_bound <= 1, and {}
    on the static backend and before any request; the served state is
    unchanged by the report.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgs  # noqa: E402
from repro.inference.backend import COMPLETE, SCORE  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.train.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.train.train_step import init_state as jinit  # noqa: E402
from repro.train.train_step import make_train_step as jtrain  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import base as cfgs  # noqa: E402
from repro_torch.inference.backend import Request  # noqa: E402
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.launch import op_cost, roofline  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.train.train_step import init_state, make_train_step  # noqa

DOT_TOL = 0.01
ARCH = "proxy-8b"
SHAPES = {"prefill": (2, 64), "decode": (2, 64), "train": (1, 1024)}


def _models():
    jcfg = dataclasses.replace(jcfgs.get_smoke_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(cfgs.get_smoke_config(ARCH), dtype="float32")
    return jzoo.build(jcfg), model_zoo.build(cfg)


def _jax_dots(fn, *args) -> float:
    hc = hlo_cost.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())
    return sum(hc.flops_by_path.values())


def _steps(kind):
    """(JAX step and args, port step and args) of one kind."""
    jm, m = _models()
    B, S = SHAPES[kind]
    rng = np.random.default_rng(0)
    tok = rng.integers(3, m.cfg.vocab_size, (B, S), dtype=np.int32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    p = m.init_params(torch.Generator().manual_seed(0))
    if kind == "prefill":
        lens = np.asarray([S, S - 5], np.int32)

        def jstep(p, b):
            o = jm.apply(p, b, mode="prefill", cache=jm.init_cache(B, S))
            return jm.logits_of(p, o["last_hidden"])

        def tstep(p, b):
            o = m.apply(p, b, mode="prefill", cache=m.init_cache(B, S))
            return m.logits_of(p, o["last_hidden"])
        return ((jstep, jp, {"tokens": jnp.asarray(tok),
                             "lengths": jnp.asarray(lens)}),
                (tstep, p, {"tokens": torch.from_numpy(tok),
                            "lengths": torch.from_numpy(lens)}))
    if kind == "decode":
        cur = tok[:, :1]

        def jstep(p, c, b):
            o = jm.apply(p, b, mode="decode", cache=c)
            return jm.logits_of(p, o["hidden"][:, 0])

        def tstep(p, c, b):
            o = m.apply(p, b, mode="decode", cache=c)
            return m.logits_of(p, o["hidden"][:, 0])
        return ((jstep, jp, jm.init_cache(B, S),
                 {"tokens": jnp.asarray(cur)}),
                (tstep, p, m.init_cache(B, S),
                 {"tokens": torch.from_numpy(cur)}))
    mask = np.ones((B, S), np.float32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok),
          "loss_mask": torch.from_numpy(mask)}
    return ((jtrain(jm, JAdamW()), jinit(jm, jax.random.PRNGKey(0)).tree(),
             jb),
            (make_train_step(m), init_state(m, 0, "cpu").tree(), tb))


@pytest.mark.parametrize("kind", list(SHAPES))
def test_dot_flops_match_jax(kind):
    (jfn, *jargs), (tfn, *targs) = _steps(kind)
    want = _jax_dots(jfn, *jargs)
    if kind == "train":
        _, cost = op_cost.count(tfn, *targs)
    else:
        with torch.no_grad():
            _, cost = op_cost.count(tfn, *targs)
    assert want > 0
    assert abs(cost.dot_flops - want) <= DOT_TOL * want, (cost.dot_flops,
                                                          want)
    assert cost.flops >= cost.dot_flops and cost.bytes > 0
    assert cost.collective_bytes == 0.0


def test_to_dict_keys_and_constants_match_jax():
    kw = dict(arch="a", shape="s", mesh="1", chips=1, hlo_flops=1e12,
              hlo_bytes=2e9, collective_bytes=0.0, model_flops=5e11)
    mine, theirs = roofline.Roofline(**kw), jroof.Roofline(**kw)
    assert set(mine.to_dict()) == set(theirs.to_dict())
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert mine.t_compute == pytest.approx(1e12 / 989e12)
    assert mine.bottleneck == "compute"
    assert mine.useful_flop_ratio == pytest.approx(0.5)
    assert 0.0 <= mine.mfu_bound <= 1.0
    assert "mfu_bound" in roofline.fmt_row(mine)


def test_kernel_work_reaches_the_counter():
    seen = []
    with op_cost.OpCounter() as c:
        kernels.report("decode_attention", lambda: (seen.append(1) or 40.0,
                                                    64.0))
        torch.ones(4) + 1
    assert seen == [1]
    assert c.cost.flops_by_path["decode_attention"] == 40.0
    assert c.cost.kernel_launches == {"decode_attention": 1}
    assert c.cost.bytes >= 64.0
    kernels.report("decode_attention", lambda: seen.append(2))
    assert seen == [1] and kernels.WORK_HOOK is None   # no counter: no call


def _ragged_workload():
    reqs, rid = [], 0
    for i, mt in enumerate([40, 4, 9, 2]):
        rid += 1
        reqs.append(Request("w" * (3 + 11 * i) + f" complete case {i}",
                            ARCH, COMPLETE, max_tokens=mt, request_id=rid))
    for i in range(2):
        rid += 1
        reqs.append(Request(f"score this ragged row {i}" + "?" * (7 * i),
                            ARCH, SCORE, request_id=rid))
    return reqs


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{n}/").items()}
    return {prefix: tree}


def test_backend_roofline_contract():
    eng = TorchInferenceEngine(ARCH, smoke=True, max_seq=192,
                               backend="continuous", seed=0, device="cpu")
    assert eng.backend_roofline() == {}                # before any request
    eng.submit_batch(copy.deepcopy(_ragged_workload()))
    stats = eng.backend_stats()
    assert stats["prefill_steps"] > 0 and stats["decode_steps"] > 0
    pool = _flat(eng._batcher.kv.pool)
    before = {k: t.clone() for k, t in pool.items()}
    rep = eng.backend_roofline()
    assert set(rep) == {"prefill", "decode"}
    for kind in rep.values():
        assert kind["tokens_per_step"] > 0
        assert 0.0 <= kind["mfu_bound"] <= 1.0
        assert kind["hlo_flops_per_dev"] > 0
        assert set(kind) >= set(jroof.Roofline(
            "a", "s", "1", 1, 0, 0, 0, 0).to_dict())
    after = _flat(eng._batcher.kv.pool)
    assert after.keys() == before.keys()
    for k, t in after.items():
        assert t is pool[k] and torch.equal(t, before[k]), k
    st = TorchInferenceEngine(ARCH, smoke=True, backend="static",
                              device="cpu")
    assert st.backend_stats()["backend"] == "static"
    assert st.backend_roofline() == {}
