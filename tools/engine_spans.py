#!/usr/bin/env python3
"""The continuous batcher's own spans on the card, in one benchmark cell.

    python3 tools/engine_spans.py [--workload qwen3-32b.filter-batch] \
        [--seed 7] [--out FILE]

Builds the cell's program once (``aisqlbench.harness.Setup``) and serves
the cell's traffic three times, each after its own warm-up:

1. **traced**, as ``aisqlbench/run.py --trace 1`` does (a CUDA-only
   profiler over the window's first ``harness.TRACE_S`` seconds, a
   synchronise after each prefill step): the span readers and
   ``idle_share.batch``; the window's prefill steps as the spans and as the
   harness's wrapper count them; and the phase split, each phase's host ms,
   ``device_ms`` and card idle ms a step;
2. with the serving process's ``Observability`` enabled and **no
   profiler**: the same split without the profiler's own cost;
3. under a **CPU and CUDA profiler**, three of the cell's queries' rows
   served from this thread (the profiler records CPU ranges only on its
   own): each span's ``record_function`` range on the profiler's clock
   against the span's own times mapped through the benchmark's offset
   (``devtrace.HostClock``), median and max |difference| over every step
   and phase.

Prints the numbers as JSON after each part, and writes them to ``--out``
if given.
Needs a CUDA card and the cell's memory; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PHASES = ("step.upload", "step.gather", "step.forward", "step.logits",
          "step.scatter", "step.readback")


def new_waves(ring, before):
    return [ring.get(k) for k in ring.ids() if k not in before]


def steps_of(waves, lo=None, hi=None):
    out = [s for w in waves for s in w["children"]
           if s["kind"] == "engine.step" and s["attrs"]["kind"] == "prefill"
           and (lo is None or lo <= s["t0"]) and (hi is None or s["t1"] <= hi)]
    return sorted(out, key=lambda s: s["t0"])


def covered_upto(merged):
    """t -> the length of (-inf, t] that ``merged`` (sorted, disjoint
    intervals: a ``timeline.union``) covers, by bisection over running
    sums: a traced window holds ~10^5-10^6 busy intervals and a few
    thousand spans, too many for a scan of the intervals a span."""
    starts = [x for x, _ in merged]
    cum = [0.0]
    for x, y in merged:
        cum.append(cum[-1] + (y - x))

    def upto(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        x, y = merged[i - 1]
        return cum[i - 1] + min(t, y) - x
    return upto


def phase_split(steps, off=None, busy=None):
    """Per phase, the mean a step of host ms, device ms and (given the
    device's busy union in profiler ns) card idle ms, with the whole step."""
    rows = {}
    busy_upto = None if busy is None else covered_upto(busy)

    def add(name, t0, t1, dev):
        r = rows.setdefault(name, {"n": 0, "host_ms": 0.0, "device_ms": 0.0,
                                   "idle_ms": 0.0})
        r["n"] += 1
        r["host_ms"] += (t1 - t0) * 1e3
        r["device_ms"] += dev or 0.0
        if busy is not None:
            a, b = t0 * 1e9 + off, t1 * 1e9 + off
            r["idle_ms"] += (b - a - (busy_upto(b) - busy_upto(a))) / 1e6

    for s in steps:
        add("engine.step", s["t0"], s["t1"], None)
        for p in s["children"]:
            add(p["kind"], p["t0"], p["t1"], p["attrs"].get("device_ms"))
    n = len(steps)
    return {k: {"steps_with": v["n"],
                **{m: v[m] / n for m in ("host_ms", "device_ms", "idle_ms")
                   if busy is not None or m != "idle_ms"}}
            for k, v in rows.items()}


def clock_check(prof, waves, off, gcs=()):
    """|profiler range - span mapped through the offset|, ms, per name,
    and the largest differences with the garbage collections (perf_counter
    start, end, generation) that ran between their two readings."""
    from torch.autograd import DeviceType
    names = {"engine.step", *PHASES}
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in names:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = {}
    for w in waves:
        for s in w["children"]:
            for sp in [s] + s["children"]:
                spans.setdefault(sp["kind"], []).append((sp["t0"], sp["t1"]))
    out, d_all, edges = {}, [], []
    for name in sorted(names):
        r = sorted(ranges.get(name, []))
        sp = sorted(spans.get(name, []))
        if len(r) != len(sp) or not r:
            out[name] = {"ranges": len(r), "spans": len(sp)}
            continue
        d = []
        for (a, b), (t0, t1) in zip(r, sp):
            for edge, ns, t in (("start", a, t0), ("end", b, t1)):
                delta = (ns - (t * 1e9 + off)) / 1e6
                d.append(abs(delta))
                edges.append((abs(delta), name, edge, delta, t,
                              (ns - off) / 1e9))
        d_all += d
        out[name] = {"n": len(sp), "median_ms": statistics.median(d),
                     "max_ms": max(d)}
    if d_all:
        q = statistics.quantiles(d_all, n=100)
        out["all"] = {"n_edges": len(d_all),
                      "median_ms": statistics.median(d_all),
                      "p99_ms": q[98], "max_ms": max(d_all),
                      "over_0.1ms": sum(x > 0.1 for x in d_all)}
    out["largest"] = [
        {"name": n, "edge": e, "delta_ms": dl,
         "gc": [g for g in gcs if g[1] >= min(t, u) and g[0] <= max(t, u)]}
        for _, n, e, dl, t, u in sorted(edges, reverse=True)[:8]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="qwen3-32b.filter-batch")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("engine_spans: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from aisqlbench import harness, spec
    bench = spec.Bench()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "torch": torch.__version__,
           "workload": args.workload, "seed": args.seed}
    with profile(activities=[ProfilerActivity.CUDA]):
        # the recorder's gate, and the profiler's per-thread state
        out["gate_under_cuda_only_profile"] = {
            "process": torch.autograd.profiler._is_profiler_enabled,
            "this_thread": torch.autograd._profiler_enabled()}
    st = harness.Setup(bench, args.workload, device="cuda", smoke=False,
                       trace=True)
    tr = traced(st, bench, args, out)
    save(out, args.out)
    untraced(st, args, out)
    save(out, args.out)
    out["clock_check"] = clocks(st, tr)
    st.free()
    save(out, args.out)
    return 0


def traced(st, bench, args, out):
    """1. As the harness's --trace 1; returns the run's traffic."""
    import repro_torch.obs as obs
    from aisqlbench import devtrace, harness, timeline
    ring = obs.engine_ring()
    before = set(ring.ids())
    tr, recs, f, setup_s, prof = st.serve(args.seed, harness.TRACE_S,
                                          T_START, profile=True)
    lo, hi = f["clock"].ns(f["t0"]), f["clock"].ns(f["traced"])
    ev = devtrace.clip(devtrace.device_events(prof), lo, hi)
    del prof
    run = harness.Run(args.workload, st.conf, st.model, st.mix, f["t0"],
                      f["t1"], harness.TRACE_S, recs, st.taps.dispatches,
                      st.taps.steps, setup_s)
    run.events, run.window_ns = ev, (lo, hi)
    run.clock_window = a, b = (f["t0"], f["traced"])
    metrics = {m["name"]: bench.reader(m["name"])(run)
               for m in bench.metrics_of(args.workload, "per_layer")}
    ws = steps_of(new_waves(ring, before), a, b)
    taps = [s for s in st.taps.steps if a <= s[1] and s[2] <= b]
    inside = [s for s in ws if any(t[1] <= s["t0"] and s["t1"] <= t[2]
                                   for t in taps)]
    busy = timeline.union((x, y) for _, x, y in ev)
    out["traced"] = {
        "metrics": metrics, "window_s": (hi - lo) / 1e9,
        "span_steps": len(ws),
        "span_tokens": sum(s["attrs"]["tokens"] for s in ws),
        "harness_steps": len(taps),
        "harness_tokens": sum(s[3] for s in taps),
        "span_tokens_of_harness_steps": sum(s["attrs"]["tokens"]
                                            for s in inside),
        "mean_tokens_a_step": (sum(s["attrs"]["tokens"] for s in ws)
                               / max(len(ws), 1)),
        "split": phase_split(ws, lo - a * 1e9, busy)}
    return tr


def untraced(st, args, out):
    """2. The serving process's Observability on, no profiler."""
    import repro_torch.obs as obs
    from aisqlbench import harness
    ring = obs.engine_ring()
    real = obs.Observability
    obs.Observability = lambda enabled=True, **k: real(enabled=True, **k)
    st.taps.trace = False
    before = set(ring.ids())
    try:
        _, recs, f, _, _ = st.serve(args.seed + 1, harness.TRACE_S, T_START,
                                    profile=False)
    finally:
        obs.Observability = real
    ws = steps_of(new_waves(ring, before), f["t0"], f["t1"])
    out["obs_no_profiler"] = {
        "steps": len(ws),
        "query_s": [r["end"] - r["start"] for r in recs if r["ok"]],
        "split": phase_split(ws)}


def clocks(st, tr):
    """3. The clock check under a CPU and CUDA profiler, over three of the
    cell's queries' rows served from this thread (the profiler records CPU
    ranges only on the thread that started it): at least 100 steps."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.obs as obs
    from aisqlbench import devtrace
    from repro_torch.inference.backend import SCORE, Request
    ring = obs.engine_ring()
    queries = [q for pool in tr.pools.values() for q in pool][:3]
    before = set(ring.ids())
    gcs, t_gc = [], []

    def on_gc(phase, info):
        if phase == "start":
            t_gc[:] = [time.perf_counter()]
        elif t_gc:
            gcs.append((t_gc[0], time.perf_counter(), info["generation"]))

    gc.callbacks.append(on_gc)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            clock = devtrace.HostClock()
            for q in queries:
                st.eng.submit_batch([
                    Request(tr.prompt_of(body), st.eng.arch, SCORE,
                            request_id=i)
                    for i, body in zip(q.ids, q.bodies)])
            torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
    waves = new_waves(ring, before)
    out = clock_check(prof, waves, clock.offset_ns, gcs)
    out["steps"] = len(steps_of(waves))
    out["gc_runs"] = len(gcs)
    return out


def save(out, path) -> None:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    sys.exit(main())
