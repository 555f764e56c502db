"""The continuous batcher's spans (``repro_torch.obs.engine``) on the CPU.

A smoke engine serves SCORE and COMPLETE requests, more than its slots (so
rows are admitted mid-stream), with the recorder on: under an enabled
``Observability`` and under a CPU profiler.  Each ``serve`` call leaves one
wave tree in the engine ring; its step spans count the batcher's steps and
tokens, their ``rows_at`` are the rows the step took in, their phases nest
in order, and ``step.readback`` appears exactly where the host read logits
or tokens.  The results are bitwise those of a run with the recorder off;
with the gate off nothing is built; ``roofline_report`` records nothing.
"""
import copy
import itertools
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.inference.backend import COMPLETE, SCORE, Request  # noqa
from repro_torch.inference.engine import TorchInferenceEngine  # noqa: E402
from repro_torch.obs import Observability, engine_ring, walk_spans  # noqa
from repro_torch.obs import trace as trace_mod  # noqa: E402

PHASES = ("step.upload", "step.gather", "step.forward", "step.logits",
          "step.scatter", "step.readback")
_ids = itertools.count()


def _requests():
    reqs = [Request(f"is item {i} in stock? " + "x" * (23 * i), "proxy-8b",
                    SCORE, request_id=i + 1) for i in range(4)]
    reqs += [Request(f"describe item {i} " + "w" * (9 * i), "proxy-8b",
                     COMPLETE, max_tokens=mt, request_id=10 + i)
             for i, mt in enumerate([5, 2, 4])]
    return reqs


def _engine():
    return TorchInferenceEngine("proxy-8b", device="cpu", max_batch=3,
                                max_seq=128, seed=5, backend="continuous",
                                engine_id=f"trace-test#{next(_ids)}")


def _fields(results):
    return [(r.request_id, r.kind, r.score, r.text, r.tokens_in,
             r.tokens_out, r.credits) for r in results]


def _taps(eng):
    """What the batcher took in at each prefill step, read from outside
    (as the benchmark's wrapper does), and whether each step read logits."""
    b = eng._batcher
    seen = []
    orig = b._prefill_step

    def step(active, results, t0):
        at = []
        for s in active:
            if s is not None and s.state == "prefill":
                n = min(b.prefill_chunk, len(s.enc) - s.filled)
                at.append([s.filled, n, int(s.filled + n == len(s.enc))])
        seen.append(at)
        return orig(active, results, t0)

    b._prefill_step = step
    return seen


def _serve_recorded(eng, reqs, mode):
    if mode == "obs":
        eng.obs = Observability()
        return eng.submit_batch(copy.deepcopy(reqs))
    from torch.profiler import ProfilerActivity, profile
    out = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if mode == "profiler":
            out = eng.submit_batch(copy.deepcopy(reqs))
        else:
            # the profiler's own state is per thread; serving workers are
            # other threads than the one that started it
            th = threading.Thread(target=lambda: out.extend(
                eng.submit_batch(copy.deepcopy(reqs))))
            th.start()
            th.join()
    if mode == "profiler":
        names = {e.name() for e in prof.profiler.kineto_results.events()}
        assert {"engine.wave", "engine.step", *PHASES} <= names
    return out


@pytest.mark.parametrize("mode", ["obs", "profiler", "profiler_on_a_worker"])
def test_wave_tree_counts_the_batchers_steps(mode):
    reqs = _requests()
    plain = _engine()
    want = _fields(plain.submit_batch(copy.deepcopy(reqs)))
    eng = _engine()
    eng.submit_batch(copy.deepcopy(reqs[:1]))          # wave 1, gate off
    ring = engine_ring()
    before = set(ring.ids())
    taps = _taps(eng)
    st0 = eng.backend_stats()
    got = _fields(_serve_recorded(eng, reqs, mode))
    st1 = eng.backend_stats()
    assert got == want                                 # bitwise, recorder on
    new = [k for k in ring.ids() if k not in before]
    assert new == [f"{eng.engine_id}/2"]
    tree = ring.get(new[0])
    attrs = tree["attrs"]
    assert tree["kind"] == "engine.wave" and attrs["wave"] == 2
    assert attrs["engine_id"] == eng.engine_id
    assert attrs["requests"] == len(reqs)
    assert attrs["request_ids"] == [r.request_id for r in reqs]
    assert attrs["kinds"] == {SCORE: 4, COMPLETE: 3}
    assert tree["t0"] >= attrs["prev_wave_end"] is not None
    assert "unrecorded_from" not in attrs
    steps = tree["children"]
    assert all(s["kind"] == "engine.step" for s in steps)
    pre = [s for s in steps if s["attrs"]["kind"] == "prefill"]
    dec = [s for s in steps if s["attrs"]["kind"] == "decode"]
    assert len(pre) == st1["prefill_steps"] - st0["prefill_steps"] > 0
    assert len(dec) == st1["decode_steps"] - st0["decode_steps"] > 0
    assert sum(s["attrs"]["tokens"] for s in pre) == \
        st1["prefill_tokens"] - st0["prefill_tokens"]
    assert sum(s["attrs"]["tokens"] for s in dec) == \
        st1["decode_tokens"] - st0["decode_tokens"]
    assert st1["admitted"] - st0["admitted"] == len(reqs) > eng.max_batch
    assert [s["attrs"]["rows_at"] for s in pre] == taps
    for s in pre:
        assert s["attrs"]["tokens"] == sum(n for _, n, _ in
                                           s["attrs"]["rows_at"])
    for s in steps:
        a = s["attrs"]
        assert 1 <= a["rows"] <= eng.max_batch and a["nb"] >= 1
        names = [c["kind"] for c in s["children"]]
        read = a["kind"] == "decode" or any(
            last for *_, last in a["rows_at"])
        assert names == list(PHASES if read else PHASES[:-1])
        t = s["t0"]
        for c in s["children"]:                        # in order, nested
            assert t <= c["t0"] <= c["t1"] <= s["t1"]
            assert "device_ms" not in c["attrs"]       # the CPU
            t = c["t1"]
    for a, b in zip(steps, steps[1:]):
        assert a["t1"] <= b["t0"]
    assert tree["t0"] <= steps[0]["t0"] and steps[-1]["t1"] <= tree["t1"]
    assert {n["kind"] for n in walk_spans(tree)} <= set(
        trace_mod.SPAN_KINDS)


def test_gate_off_builds_nothing(monkeypatch):
    eng = _engine()
    eng.obs = Observability(enabled=False)
    ring = engine_ring()
    before = ring.ids()
    made = []
    real_span = trace_mod.Span

    class Counted(real_span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a[0])
            super().__init__(*a)

    monkeypatch.setattr(trace_mod, "Span", Counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: made.append(name))
    out = eng.submit_batch(_requests())
    assert len(out) == 7 and made == [] and ring.ids() == before
    eng.backend_roofline()
    assert made == [] and ring.ids() == before


def test_roofline_report_adds_nothing_to_the_ring():
    eng = _engine()
    eng.obs = Observability()
    eng.submit_batch(_requests())
    ids = engine_ring().ids()
    tree = engine_ring().get(ids[-1])
    assert set(eng.backend_roofline()) == {"prefill", "decode"}
    assert engine_ring().ids() == ids
    assert engine_ring().get(ids[-1]) is tree


def test_gate_closing_mid_wave_cuts_the_wave():
    eng = _engine()
    obs = eng.obs = Observability()
    b = eng._batcher
    orig = b._decode_step
    n = []

    def step(*a):
        n.append(1)
        if len(n) == 2:
            obs.enabled = False
        return orig(*a)

    b._decode_step = step
    st0 = eng.backend_stats()
    eng.submit_batch(_requests())
    st1 = eng.backend_stats()
    tree = engine_ring().get(f"{eng.engine_id}/1")
    cut = tree["attrs"]["unrecorded_from"]
    steps = tree["children"]
    assert all(s["t1"] <= cut for s in steps)
    assert len(steps) < (st1["prefill_steps"] + st1["decode_steps"]
                         - st0["prefill_steps"] - st0["decode_steps"])
    assert sum(s["attrs"]["kind"] == "decode" for s in steps) == 1


def test_serving_engine_hands_its_obs_to_its_engines():
    from repro_torch.core import Catalog, ServingEngine
    from repro_torch.inference.scheduler import Scheduler
    eng = _engine()
    sched = Scheduler()
    sched.register(eng)
    se = ServingEngine(Catalog({}), sched, device="cpu")
    try:
        assert eng.obs is se.obs and se.obs.enabled
    finally:
        se.close()


def test_engine_spans_covered_length_is_the_interval_overlap():
    """``tools/engine_spans.py``'s bisection over a busy union gives the
    covered length of any interval as ``aisqlbench.timeline.overlap``'s
    scan does."""
    import importlib.util
    import random
    from pathlib import Path

    from aisqlbench import timeline
    path = Path(__file__).resolve().parents[1] / "tools" / "engine_spans.py"
    spec = importlib.util.spec_from_file_location("engine_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rng = random.Random(3)
    merged = timeline.union(
        (a, a + rng.uniform(0, 500))
        for a in (rng.uniform(0, 1e6) for _ in range(500)))
    upto = tool.covered_upto(merged)
    for _ in range(500):
        a = rng.uniform(-1e3, 1.1e6)
        b = a + rng.uniform(0, 5e4)
        assert upto(b) - upto(a) == pytest.approx(
            timeline.overlap(a, b, merged), abs=1e-6)
    assert tool.covered_upto([])(5.0) == 0.0
