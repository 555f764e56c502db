"""Metric arithmetic on timelines: unions of intervals, the drain rule, a
percentile, and the model's useful operations.  Plain Python over numbers
the harness recorded; no device and no program."""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def overlap(a: float, b: float, merged: Sequence[Interval]) -> float:
    """Length of [a, b] covered by ``merged`` (a ``union``)."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged)


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-quantile as the ceil(q n)-th smallest value."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def rows_per_s(queries: Sequence[Dict], t0: float) -> float:
    """Closed loop: every row of the queries the window submitted, over
    the time from the window's start to the end of the last of them (the
    drain included, so no query is cut at the edge)."""
    done = [q for q in queries if q["ok"]]
    end = max(q["end"] for q in queries)
    return sum(q["rows"] for q in done) / (end - t0)


# -- the model's useful operations ------------------------------------------

def matmul_params(m: Dict) -> int:
    """Weights a token multiplies through in one layer: the attention
    projections and the SwiGLU feed-forward."""
    d, hd = m["d_model"], m["head_dim"]
    return (2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd
            + 3 * d * m["d_ff"])


def step_flops(m: Dict, start: int, count: int, logits: int) -> float:
    """Useful operations of one row in one step: ``count`` tokens taken in
    at positions ``start`` .. ``start + count - 1``, 2 x the active weights
    each, attention over the valid keys (position + 1 of them, 4 hd a key
    and head: q.k and p.v), and the output head at ``logits`` positions
    (a prompt's last token)."""
    layers = m["num_layers"]
    keys = count * start + count * (count + 1) / 2
    return (2.0 * matmul_params(m) * count * layers
            + 4.0 * m["num_heads"] * m["head_dim"] * keys * layers
            + 2.0 * m["d_model"] * m["vocab_size"] * logits)


def window_flops(steps: Sequence[tuple], lo: float, hi: float) -> float:
    """The operations of the steps (kind, t0, t1, tokens, ops) that fall in
    [lo, hi], a step across an edge counted for its share inside."""
    total = 0.0
    for _, a, b, _, ops in steps:
        inside = max(0.0, min(b, hi) - max(a, lo))
        total += ops * (inside / (b - a) if b > a else float(lo <= a <= hi))
    return total

