"""The program's own spans of its continuous batcher, as the per-layer
readers take them: the wave trees of ``repro_torch.obs.engine_ring()``
(``engine.wave`` > ``engine.step`` > ``step.*`` phases, times on
``perf_counter``, each phase's CUDA stream time as ``device_ms``).

A reader gives a number only where the ring covers the traced window
(``run.clock_window``) whole, for every engine in it: a run of consecutive
waves from one whose previous wave ended (``prev_wave_end``) at or before
the window's start to one that lasted, still recorded, past its end.  An
evicted wave, a wave that ran with the recorder off, or a program without
the ring reads ``None``: never a partial number.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def waves() -> Optional[List[Dict]]:
    """The ring's wave trees, or None where the program has no ring."""
    try:
        from repro_torch.obs import engine_ring
    except ImportError:
        return None
    ring = engine_ring()
    trees = [ring.get(k) for k in ring.ids()]
    return [t for t in trees if t is not None]


def _covering(chain: List[Dict], a: float, b: float) -> Optional[List[Dict]]:
    """The waves of one engine (in wave order) that cover [a, b], or None."""
    start = None
    for i, w in enumerate(chain):
        prev = w["attrs"].get("prev_wave_end")
        if prev is None or prev <= a:
            start = i
    if start is None:
        return None
    out = []
    for i in range(start, len(chain)):
        w = chain[i]
        if out and w["attrs"]["wave"] != out[-1]["attrs"]["wave"] + 1:
            return None
        out.append(w)
        cut = w["attrs"].get("unrecorded_from")
        if cut is not None:
            return out if cut >= b else None
        if w["t1"] >= b:
            return out
    return None


def covering_waves(run) -> Optional[List[Dict]]:
    """The waves that cover the traced window, of every engine in the
    ring, or None."""
    if run.clock_window is None:
        return None
    trees = waves()
    if not trees:
        return None
    a, b = run.clock_window
    by: Dict[str, List[Dict]] = {}
    for t in trees:
        by.setdefault(t["attrs"]["engine_id"], []).append(t)
    out: List[Dict] = []
    for chain in by.values():
        got = _covering(sorted(chain, key=lambda t: t["attrs"]["wave"]), a, b)
        if got is None:
            return None
        out += got
    return out


def window_steps(run, kind: str = "prefill") -> Optional[List[Dict]]:
    """The ``kind`` steps lying wholly inside the traced window, in time
    order, or None where the ring does not cover it or none does."""
    ws = covering_waves(run)
    if ws is None:
        return None
    a, b = run.clock_window
    steps = sorted((s for w in ws for s in w["children"]
                    if s["kind"] == "engine.step"
                    and s["attrs"].get("kind") == kind
                    and a <= s["t0"] and s["t1"] <= b),
                   key=lambda s: s["t0"])
    return steps or None


def phase(step: Dict, name: str) -> Optional[Dict]:
    for c in step["children"]:
        if c["kind"] == name:
            return c
    return None


def mean_device_ms(run, names) -> Optional[float]:
    """The mean over the window's prefill steps of the summed ``device_ms``
    of their ``names`` phases; None where any lacks it (the CPU)."""
    steps = window_steps(run)
    if steps is None:
        return None
    total = 0.0
    for s in steps:
        for n in names:
            p = phase(s, n)
            if p is None or "device_ms" not in p["attrs"]:
                return None
            total += p["attrs"]["device_ms"]
    return total / len(steps)


def offset_ns(run) -> float:
    """perf_counter seconds to the profiler's ns: the benchmark's own
    offset (``devtrace.HostClock``), recovered from the window's ends."""
    return run.window_ns[0] - run.clock_window[0] * 1e9
