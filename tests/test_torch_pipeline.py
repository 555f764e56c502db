"""The port's client stack (CortexClient -> RequestPipeline -> Scheduler)
held to the JAX package's, on the CPU.

One mixed request stream with duplicates goes through both packages, in
two waves and then once more (so the pipeline dedups within a wave and
serves the repeat from its memo cache), eager and pipelined.  Over each
package's simulated backend the results, credits, pipeline and scheduler
counters and the span tree (under a tick clock) must be identical.  Over
real smoke engines in fp32, with the port's params converted from the
JAX engine's, token ids, labels, counts and credits must be identical and
SCORE and EMBED values agree within 1e-5 (fp32 sums are taken in another
order by each framework).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.configs.base as jcfgs  # noqa: E402
import repro.inference.api as japi  # noqa: E402
import repro.inference.backend as jbe  # noqa: E402
import repro.inference.simulator as jsim  # noqa: E402
import repro.inference.tokenizer as jtok  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch.configs.base as tcfgs  # noqa: E402
import repro_torch.inference.api as tapi  # noqa: E402
import repro_torch.inference.backend as tbe  # noqa: E402
import repro_torch.inference.simulator as tsim  # noqa: E402
import repro_torch.inference.tokenizer as ttok  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.inference.engine import JaxInferenceEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402

VALUE_TOL = 1e-5
JAX = (japi, jbe, jobs)
TORCH = (tapi, tbe, tobs)


def _stream(be):
    R = be.Request
    reqs = [R(f"is row {i % 4} about billing?", "proxy-8b", be.SCORE)
            for i in range(6)]
    reqs += [R(f"summarize item {i % 2}", "proxy-8b", be.COMPLETE,
               max_tokens=mt) for i, mt in enumerate([5, 2, 5])]
    reqs += [R("sentiment of 'a great film'", "proxy-8b", be.CLASSIFY,
               labels=("pos", "neg")) for _ in range(2)]
    reqs.append(R("which topics?", "proxy-8b", be.CLASSIFY,
                  labels=("sports", "money", "art"), multi_label=True))
    reqs += [R(t, "proxy-8b", be.EMBED, metadata={"embed_dim": 16})
             for t in ("alpha text", "beta text", "alpha text")]
    return reqs


def _run(pkg, backend, pipelined):
    """Serve the stream through ``pkg``'s client stack over ``backend``.
    Returns (results, client meters, scheduler counters, span tree)."""
    api, be, obs = pkg
    sched = api.Scheduler()
    sched.register(backend)
    client = api.CortexClient(
        sched, default_model="proxy-8b", proxy_model="proxy-8b",
        pipeline=api.PipelineConfig(max_batch=4) if pipelined else None)
    tracer = obs.Tracer(clock=obs.TickClock())
    results = []
    with obs.activate(tracer), tracer.span("stream", kind="query"):
        for wave in range(2):
            reqs = _stream(be)
            futs = client.submit_async(reqs[:7]) + \
                client.submit_async(reqs[7:])
            client.flush()
            results += [f.result() for f in futs]
        results += [(s,) for s in client.filter_scores(
            ["is row 1 about billing?"], model="proxy-8b")]
    meters = client.snapshot()
    meters.pop("ai_seconds")                      # wall time on engines
    meters.get("pipeline", {}).pop("queue_wait_s", None)
    return results, meters, sched.stats_snapshot(), tracer.to_dict()


def _fields(res):
    if isinstance(res, tuple):
        return res
    d = dataclasses.asdict(res)
    d.pop("latency_s")
    return d


@pytest.mark.parametrize("pipelined", [False, True])
def test_client_stack_matches_jax_over_simulator(pipelined):
    jout = _run(JAX, jsim.SimulatedBackend(seed=5), pipelined)
    tout = _run(TORCH, tsim.SimulatedBackend(seed=5), pipelined)
    assert len(tout[0]) == len(jout[0]) == 31
    assert [_fields(t) for t in tout[0]] == [_fields(j) for j in jout[0]]
    assert [t.latency_s for t in tout[0][:-1]] == \
        [j.latency_s for j in jout[0][:-1]]
    assert tout[1:3] == jout[1:3]
    assert jobs.to_json(tout[3]) == jobs.to_json(jout[3])
    if pipelined:
        stats = tout[1]["pipeline"]
        assert stats["dedup_hits"] > 0 and stats["cache_hits"] > 0


def _fp32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


def test_client_stack_matches_jax_over_engines(monkeypatch):
    monkeypatch.setattr(jcfgs, "get_smoke_config",
                        _fp32(jcfgs.get_smoke_config))
    monkeypatch.setattr(tcfgs, "get_smoke_config",
                        _fp32(tcfgs.get_smoke_config))
    kw = dict(smoke=True, max_batch=4, max_seq=64, seed=3)
    jeng = JaxInferenceEngine("proxy-8b", **kw)
    teng = TorchInferenceEngine("proxy-8b", device="cpu", **kw)
    teng.params = bridge.params_from_jax(
        teng.cfg, jax.tree.map(np.asarray, jeng.params))
    ids = {}
    for name, mod in (("jax", jtok), ("torch", ttok)):
        real = mod.decode
        ids[name] = []

        def record(seq, real=real, sink=ids[name]):
            sink.append(tuple(int(t) for t in seq))
            return real(seq)
        monkeypatch.setattr(mod, "decode", record)
    jout = _run(JAX, jeng, pipelined=True)
    tout = _run(TORCH, teng, pipelined=True)
    assert ids["torch"] == ids["jax"] and len(ids["jax"]) == 2
    assert tout[1:3] == jout[1:3]
    assert len(tout[0]) == len(jout[0]) == 31
    for t, j in zip(tout[0], jout[0]):
        t, j = _fields(t), _fields(j)
        if isinstance(t, tuple):                  # filter_scores' value
            assert abs(t[0] - j[0]) <= VALUE_TOL
            continue
        for key in ("score", "embedding"):
            a, b = t.pop(key), j.pop(key)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=0, atol=VALUE_TOL)
        assert t == j
