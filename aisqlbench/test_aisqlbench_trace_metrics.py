"""The readers of the program's batcher spans on synthetic wave trees and a
synthetic traced run, against hand counts: ``kv_copy_ms_per_step``,
``forward_ms_per_step``, ``forward_idle_share`` and ``device_ops_per_step``
(``.batch``).  Each reads None where the engine ring covers the traced
window only in part, and ``forward_idle_share`` never exceeds
``idle_share`` on the same data.  ``forward_idle_share`` finds each forward
span's overlap with the busy time by bisection, and reads on seeded
synthetic traces exactly what the scan over every busy interval a span
read, fast at a million events."""
import copy
import importlib.util
import time
import types

import numpy as np

import pytest

pytest.importorskip("torch")

import repro_torch.obs as obs  # noqa: E402
from aisqlbench import devtrace, spans, spec, timeline  # noqa: E402

M = spec.HERE / "metrics"
NEW = ["kv_copy_ms_per_step.batch", "forward_ms_per_step.batch",
       "forward_idle_share.batch", "device_ops_per_step.batch"]
OFF = 1e12          # perf_counter seconds x 1e9 + OFF = the profiler's ns
A, B = 100.0, 101.0


def reader(name):
    s = importlib.util.spec_from_file_location(name, M / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def node(span_kind, t0, t1, children=(), **attrs):
    return {"name": span_kind, "kind": span_kind, "t0": t0, "t1": t1,
            "attrs": attrs, "events": [], "children": list(children)}


def step(t0, t1, fwd, ms=None, kind="prefill"):
    """A step whose forward phase spans ``fwd``; ``ms`` = device ms of
    (gather, forward, scatter)."""
    ms = ms or (0.1, 0.1, 0.1)
    f0, f1 = fwd
    return node("engine.step", t0, t1, [
        node("step.upload", t0, t0 + 0.001),
        node("step.gather", t0 + 0.001, f0, device_ms=ms[0]),
        node("step.forward", f0, f1, device_ms=ms[1]),
        node("step.logits", f1, f1 + 0.001),
        node("step.scatter", f1 + 0.001, f1 + 0.002, device_ms=ms[2]),
    ], kind=kind, rows=2, tokens=40, nb=4, rows_at=[[0, 32, 0], [0, 8, 1]])


def wave(n, t0, t1, steps, prev, **attrs):
    return node("engine.wave", t0, t1, steps, engine_id="e#0", wave=n,
                requests=16, prev_wave_end=prev, **attrs)


STEPS = [
    step(99.95, 100.05, (99.97, 100.02)),                    # across a
    step(100.10, 100.30, (100.15, 100.25), (1.0, 50.0, 2.0)),
    step(100.40, 100.60, (100.45, 100.55), (1.5, 60.0, 2.5)),
    step(100.90, 101.10, (100.95, 101.05)),                  # across b
]
# (start, end) in seconds; device events as the profiler gives them
BUSY = [(100.00, 100.01), (100.16, 100.20), (100.22, 100.24),
        (100.46, 100.55), (100.60, 100.65), (100.70, 100.71),
        (100.96, 100.97)]


def ns(t):
    return t * 1e9 + OFF


def run(events=True):
    ev = [("k", ns(a), ns(b)) for a, b in BUSY] if events else None
    return types.SimpleNamespace(
        events=ev, window_ns=(ns(A), ns(B)) if events else None,
        clock_window=(A, B))


@pytest.fixture
def ring(monkeypatch):
    r = obs.TraceRing(64)
    monkeypatch.setattr(obs, "engine_ring", lambda: r)
    return r


def fill(ring, *waves):
    for w in waves:
        ring.put(f"{w['attrs']['engine_id']}/{w['attrs']['wave']}", w)


def one_wave():
    return [wave(1, 98.0, 99.5, [], None),
            wave(2, 99.9, 101.5, copy.deepcopy(STEPS), 99.5)]


def test_readers_match_hand_counts(ring):
    fill(ring, *one_wave())
    r = run()
    # window steps: the 2nd and 3rd
    assert reader(NEW[0])(r) == pytest.approx(((1 + 2) + (1.5 + 2.5)) / 2)
    assert reader(NEW[1])(r) == pytest.approx(55.0)
    # idle inside the forward spans, clipped to the window: 0.01 + 0.04 +
    # 0.01 + 0.04 s of the 1 s window
    assert reader(NEW[2])(r) == pytest.approx(10.0)
    # events starting in [100.10, 100.40): 2; in [100.40, 100.90): 3
    assert reader(NEW[3])(r) == pytest.approx(2.5)


def test_forward_idle_share_is_within_idle_share(ring):
    fill(ring, *one_wave())
    r = run()
    idle = reader("idle_share.batch")(r)
    assert idle == pytest.approx(100 * (1 - 0.23))
    assert reader(NEW[2])(r) <= idle


def test_a_chain_of_waves_covers_the_window(ring):
    s = copy.deepcopy(STEPS)
    fill(ring, wave(1, 98.0, 99.5, [], None),
         wave(2, 99.9, 100.35, s[:2], 99.5),
         wave(3, 100.38, 101.5, s[2:], 100.35))
    r = run()
    assert len(spans.covering_waves(r)) == 2
    assert reader(NEW[0])(r) == pytest.approx(3.5)
    assert reader(NEW[1])(r) == pytest.approx(55.0)
    assert reader(NEW[2])(r) == pytest.approx(10.0)
    # the 2nd step is its wave's last: only the 3rd is counted
    assert reader(NEW[3])(r) == pytest.approx(3.0)


def _evicted():
    s = copy.deepcopy(STEPS)
    return [wave(3, 100.38, 101.5, s[2:], 100.35)]


def _cut():
    w = one_wave()
    w[1]["attrs"]["unrecorded_from"] = 100.7
    w[1]["children"] = w[1]["children"][:3]
    return w


def _ends_early():
    w = one_wave()
    w[1]["t1"] = 100.8
    w[1]["children"] = w[1]["children"][:3]
    return w


def _gap():
    s = copy.deepcopy(STEPS)
    return [wave(2, 99.9, 100.35, s[:2], 99.5),
            wave(4, 100.38, 101.5, s[2:], 100.35)]


def _other_engine():
    w = one_wave()
    late = wave(7, 50.0, 60.0, [], 40.0)
    late["attrs"]["engine_id"] = "f#0"
    return w + [late]


@pytest.mark.parametrize("partial", [_evicted, _cut, _ends_early, _gap,
                                     _other_engine, lambda: []],
                         ids=["evicted", "cut", "ends_early", "gap",
                              "other_engine", "empty"])
@pytest.mark.parametrize("name", NEW)
def test_partial_cover_reads_none(ring, partial, name):
    fill(ring, *partial())
    assert reader(name)(run()) is None


@pytest.mark.parametrize("name", NEW)
def test_no_ring_or_no_device_reads_none(ring, monkeypatch, name):
    for w in one_wave():
        for s in w["children"]:
            for p in s["children"]:
                p["attrs"].pop("device_ms", None)
        fill(ring, w)
    assert reader(name)(run(events=False)) is None      # the CPU
    monkeypatch.delattr(obs, "engine_ring")             # the parent
    assert reader(name)(run()) is None


# ---------------------------------------------------------------------------
# forward_idle_share at scale
# ---------------------------------------------------------------------------


def scan_forward_idle(run):
    """The reader's formula as it was: for every forward span, a scan over
    every busy interval (``timeline.overlap``)."""
    lo, hi = run.window_ns
    off = spans.offset_ns(run)
    fwd = timeline.union(
        (max(p["t0"] * 1e9 + off, lo), min(p["t1"] * 1e9 + off, hi))
        for w in spans.covering_waves(run) for s in w["children"]
        for p in s["children"] if p["kind"] == "step.forward"
        and p["t1"] * 1e9 + off > lo and p["t0"] * 1e9 + off < hi)
    busy = timeline.union((a, b) for _, a, b in run.events)
    idle = sum(b - a - timeline.overlap(a, b, busy) for a, b in fwd)
    return 100.0 * idle / (hi - lo)


def synthetic(ring, seed, n_events, n_steps):
    """A wave of ``n_steps`` back-to-back steps over the window, the first
    and last across its edges, and ``n_events`` device events one after
    another with gaps, some overlapping, all from ``seed``."""
    rng = np.random.default_rng(seed)
    dt = (B - A + 0.02) / n_steps
    steps = []
    for i in range(n_steps):
        t0 = A - 0.01 + i * dt
        f0, f1 = sorted(t0 + dt * rng.uniform(0.05, 0.95, 2))
        steps.append(step(t0, t0 + dt, (f0, f1)))
    fill(ring, wave(1, 98.0, 99.5, [], None),
         wave(2, A - 0.02, B + 0.05, steps, 99.5))
    gap = rng.exponential(0.4, n_events)
    dur = rng.exponential(0.6, n_events)
    gap[rng.uniform(size=n_events) < 0.1] *= -0.5         # overlaps
    start = ns(A) + np.cumsum(gap + dur) * (B - A) * 1e9 / (
        (gap + dur).sum())
    ev = [("k", a, a + d) for a, d in zip(
        start.tolist(), (dur * (B - A) * 1e9 / (gap + dur).sum()).tolist())]
    return types.SimpleNamespace(events=devtrace.clip(
        [(n, a, b - a) for n, a, b in ev], ns(A), ns(B)),
        window_ns=(ns(A), ns(B)), clock_window=(A, B))


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 11])
def test_overlaps_are_the_scans_sums(seed):
    rng = np.random.default_rng(seed)
    ivs = [(float(a), float(a + d)) for a, d in zip(
        rng.uniform(0, 1000, 3000).round(1), rng.exponential(0.5, 3000))]
    merged = timeline.union(ivs)
    edges = [x for iv in merged[::50] for x in iv]
    spans_ = [(-5.0, -1.0), (1001.0, 1100.0), (-1.0, 2000.0)] + [
        tuple(sorted(p)) for p in zip(
            rng.uniform(-10, 1010, 300).tolist() + edges[::2],
            rng.uniform(-10, 1010, 300).tolist() + edges[1::2])]
    assert timeline.overlaps(spans_, merged) == [
        timeline.overlap(a, b, merged) for a, b in spans_]


@pytest.mark.parametrize("seed", [5, 6, 7, 2**31 + 13])
def test_forward_idle_share_is_the_scans_value(ring, seed):
    r = synthetic(ring, seed, 20_000, 120)
    got = reader("forward_idle_share.batch")(r)
    assert 0.0 < got < 100.0
    assert got == scan_forward_idle(r)


def test_forward_idle_share_reads_a_million_events_fast(ring):
    r = synthetic(ring, 2**31 + 17, 1_000_000, 1_000)
    t = time.perf_counter()
    got = reader("forward_idle_share.batch")(r)
    took = time.perf_counter() - t
    assert 0.0 < got < 100.0
    assert took < 5.0, took
