"""The port's SQL layer over real smoke engines, held to the JAX package's,
and oracle-70b's model carried across.

Both packages host the cascade pair, ``proxy-smoke`` and ``oracle-smoke``
(oracle-70b's smoke config: 6 q heads on 2 kv heads, G = 3), in fp32,
with the port's params converted from the JAX engines'.  AI_FILTER with
cascades on, AI_CLASSIFY and AI_COMPLETE run through both
``AisqlEngine``s.  Rows, ``ai_calls``, credits and ``calls_by_model``
must be equal.  A filter row may differ only where a JAX SCORE it was
judged by lies within VALUE_TOL of the threshold it was held to (fp32
sums run in another order in each framework); none does on these inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.base as jcfgs  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.data.datasets as jD  # noqa: E402
import repro.inference.api as japi  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data.datasets as tD  # noqa: E402
import repro_torch.inference.api as tapi  # noqa: E402
from repro.inference.engine import JaxInferenceEngine  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference.backend import (SCORE, Request,  # noqa: E402
                                           credits_for)
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.models import attention, model_zoo  # noqa: E402

VALUE_TOL = 1e-5
TOL = dict(rtol=2e-4, atol=2e-4)    # tests/test_torch_model.py's fp32 bar
PAIR = ("proxy-8b", "oracle-70b")


def _fp32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


@pytest.fixture(scope="module")
def engines():
    """{arch: (JAX engine, port engine)} with the port's params bridged."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcfgs, "get_smoke_config", _fp32(jcfgs.get_smoke_config))
    mp.setattr(tcfgs, "get_smoke_config", _fp32(tcfgs.get_smoke_config))
    try:
        out = {}
        for i, arch in enumerate(PAIR):
            kw = dict(smoke=True, max_batch=4, max_seq=128, seed=3 + i)
            jeng = JaxInferenceEngine(arch, **kw)
            teng = TorchInferenceEngine(arch, device="cpu", **kw)
            teng.params = bridge.params_from_jax(
                teng.cfg, jax.tree.map(np.asarray, jeng.params))
            out[arch] = (jeng, teng)
    finally:
        mp.undo()
    return out


# ---------------------------------------------------------------------------
# AISQL queries on both packages
# ---------------------------------------------------------------------------


def _filter(core, D):
    cat = core.Catalog({"reviews": D.cascade_table("IMDB", rows=16)})
    return cat, ("SELECT * FROM reviews AS r WHERE "
                 "AI_FILTER(PROMPT('positive? {0}', r.text))"), \
        {"executor": core.ExecConfig(use_cascade=True,
                                     cascade=core.CascadeConfig(seed=0))}


def _classify(core, D):
    cat = core.Catalog({"reviews": D.cascade_table("IMDB", rows=8)})
    return cat, ("SELECT r.id, AI_CLASSIFY(PROMPT('sentiment of {0}', "
                 "r.text), ['positive','negative','neutral']) AS s "
                 "FROM reviews AS r"), {}


def _complete(core, D):
    cat = core.Catalog({"reviews": D.cascade_table("IMDB", rows=8)})
    return cat, ("SELECT r.id, AI_COMPLETE(PROMPT('summarize: {0}', r.text),"
                 " max_tokens => 4) AS c FROM reviews AS r LIMIT 4"), {}


QUERIES = {"filter_cascade": _filter, "classify": _classify,
           "complete": _complete}


def _run(pkg, backends, name):
    """One query through ``pkg``'s AisqlEngine over ``backends``; returns
    (rows, report numbers, {(model, prompt): score}, cascade taus)."""
    core, D, api, kw = pkg
    scores = {}
    for be in backends:
        real = be.submit_batch

        def spy(reqs, real=real):
            out = real(reqs)
            for r, res in zip(reqs, out):
                if r.kind == SCORE:
                    scores[(res.model, r.prompt)] = res.score
            return out
        be.submit_batch = spy
    try:
        sched = api.Scheduler()
        for be in backends:
            sched.register(be)
        client = api.CortexClient(sched, default_model="oracle-70b",
                                  proxy_model="proxy-8b",
                                  pipeline=api.PipelineConfig())
        cat, sql, ekw = QUERIES[name](core, D)
        eng = core.AisqlEngine(cat, client, **kw, **ekw)
        out = eng.sql(sql)
    finally:
        for be in backends:
            del be.submit_batch
    rep = eng.last_report
    cols = list(out.column_names)
    rows = [tuple(np.asarray(out.column(c)[i]).tolist() for c in cols)
            for i in range(out.num_rows)]
    taus = [(c.stats.tau_low, c.stats.tau_high)
            for c in eng.cascades.values()]
    return ((cols, rows), (rep.ai_calls, rep.ai_credits,
                           dict(client.calls_by_model)), scores, taus)


def _flip_margin(row_text, scores, taus):
    """Smallest distance of a JAX SCORE of the row to a threshold it was
    held to: 0.5 for the oracle's label, the cascade's taus for the
    proxy's score."""
    thresholds = [0.5] + [t for pair in taus for t in pair]
    return min(abs(s - t) for (_, prompt), s in scores.items()
               if row_text in prompt for t in thresholds)


@pytest.mark.parametrize("name", list(QUERIES))
def test_sql_matches_jax_over_engines(engines, name):
    jpkg = (jcore, jD, japi, {})
    tpkg = (tcore, tD, tapi, {"device": "cpu"})
    j = _run(jpkg, [engines[a][0] for a in PAIR], name)
    t = _run(tpkg, [engines[a][1] for a in PAIR], name)
    assert t[1] == j[1]                      # calls, credits, per model
    assert j[1][0] > 0
    if name == "filter_cascade":
        assert set(j[1][2]) == set(PAIR)      # both models of the pair
        # every SCORE within VALUE_TOL of JAX's, on the same prompts
        assert set(t[2]) == set(j[2])
        assert max(abs(t[2][k] - j[2][k]) for k in j[2]) <= VALUE_TOL
        cols, jrows = j[0]
        assert t[0][0] == cols
        text = cols.index("r.text")
        flipped = set(jrows) ^ set(t[0][1])
        for row in flipped:
            margin = _flip_margin(row[text], j[2], j[3])
            print(f"flipped filter row {row[0]}: JAX score margin {margin}")
            assert margin <= VALUE_TOL
        keep = [r for r in jrows if r not in flipped]
        assert [r for r in t[0][1] if r not in flipped] == keep
    else:
        assert t[0] == j[0]


# ---------------------------------------------------------------------------
# oracle-70b's model, prefill and decode logits
# ---------------------------------------------------------------------------


def test_oracle_prefill_and_decode_match_jax():
    jcfg = dataclasses.replace(jcfgs.get_smoke_config("oracle-70b"),
                               dtype="float32")
    tcfg = dataclasses.replace(tcfgs.get_smoke_config("oracle-70b"),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.num_heads // tcfg.num_kv_heads == 3
    jm = jzoo.build(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(1))
    tm = model_zoo.build(tcfg)
    tparams = bridge.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(2)
    B, S, smax = 3, 10, 20
    toks = rng.integers(4, tcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([10, 4, 1], np.int32)
    j = jm.apply(jparams, {"tokens": jnp.asarray(toks),
                           "lengths": jnp.asarray(lens)},
                 mode="prefill", cache=jm.init_cache(B, smax))
    t = tm.apply(tparams, {"tokens": torch.from_numpy(toks),
                           "lengths": torch.from_numpy(lens)},
                 mode="prefill", cache=tm.init_cache(B, smax))
    np.testing.assert_allclose(
        tm.logits_of(tparams, t["last_hidden"]).numpy(),
        np.asarray(jm.logits_of(jparams, j["last_hidden"])), **TOL)
    jc, tc = j["cache"], t["cache"]
    for step, impl in enumerate(("dense", "auto")):
        nxt = rng.integers(4, tcfg.vocab_size, (B, 1)).astype(np.int32)
        with jattn.use_decode_impl(impl):
            j = jm.apply(jparams, {"tokens": jnp.asarray(nxt)},
                         mode="decode", cache=jc)
        with attention.use_decode_impl(impl):
            t = tm.apply(tparams, {"tokens": torch.from_numpy(nxt)},
                         mode="decode", cache=tc)
        np.testing.assert_allclose(
            tm.logits_of(tparams, t["hidden"][:, 0]).numpy(),
            np.asarray(jm.logits_of(jparams, j["hidden"][:, 0])), **TOL)
        jc, tc = j["cache"], t["cache"]


def test_engine_takes_a_model_config():
    """A config with its depth cut is served and metered under its name."""
    cfg = dataclasses.replace(tcfgs.get_smoke_config("oracle-70b"),
                              name="oracle-70b", num_layers=1)
    eng = TorchInferenceEngine(cfg, device="cpu", max_batch=2, max_seq=64)
    assert eng.arch == "oracle-70b" and eng.engine_id == "oracle-70b#0"
    assert eng.cfg.num_layers == 1 and len(eng.params["layers"]) == 1
    assert eng.hosted_models() == ["oracle-70b"]
    res = eng.submit_batch([Request("is it?", "oracle-70b", SCORE,
                                    request_id=1)])
    assert res[0].model == "oracle-70b" and 0.0 <= res[0].score <= 1.0
    assert res[0].credits == credits_for("oracle-70b", res[0].tokens_in)
