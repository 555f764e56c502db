"""Process-wide metrics registry: counters, gauges, exponential-bucket
histograms, Prometheus text exposition.

Every family must be declared in :data:`METRIC_FAMILIES` — the registry
rejects unknown names, and ``test_docs`` checks the docs table against
the same catalog, so code, docs and the wire format cannot drift apart.

Histograms use exponential buckets (start 100µs, factor √2, 48 bounds)
and retain **no raw samples**: quantiles come from cumulative bucket
counts with a bounded relative error of at most √2−1 ≈ 41% at a bucket
edge (≈ ±19% returning the bucket midpoint, as we do).  That replaces
the bounded last-N sample windows the serving report used to keep,
whose tail silently vanished on long runs.
"""
from __future__ import annotations

import re
import threading
from bisect import bisect_left

# ---------------------------------------------------------------------------
# Family catalog: name -> (type, help text, label names)

METRIC_FAMILIES = {
    "aisql_queries_total": (
        "counter", "queries by tenant and lifecycle status "
        "(submitted/completed/failed/rejected)", ("tenant", "status")),
    "aisql_credits_total": (
        "counter", "credits billed to each tenant's meter", ("tenant",)),
    "aisql_dispatched_calls_total": (
        "counter", "backend calls attributed to each tenant", ("tenant",)),
    "aisql_queue_wait_seconds": (
        "histogram", "admission-queue wait per query", ("tenant",)),
    "aisql_query_latency_seconds": (
        "histogram", "end-to-end query wall time", ("tenant",)),
    "aisql_ai_calls_total": (
        "counter", "inference results by model and request kind",
        ("model", "kind")),
    "aisql_ai_tokens_total": (
        "counter", "tokens by model and direction (in/out)",
        ("model", "direction")),
    "aisql_backend_credits_total": (
        "counter", "credits charged by backends, by model", ("model",)),
    "aisql_dispatch_latency_seconds": (
        "histogram", "one batch attempt on one replica", ("model",)),
    "aisql_pipeline_events_total": (
        "counter", "request-pipeline events (dispatch/cache_hit/"
        "inflight_hit/retry/failure/coalesced)", ("event",)),
    "aisql_pipeline_batch_size": (
        "histogram", "requests per dispatched pipeline batch", ()),
    "aisql_scheduler_events_total": (
        "counter", "scheduler telemetry (submits/dispatches/retries/"
        "timeouts/redispatches/splits)", ("event",)),
    "aisql_operator_seconds": (
        "histogram", "AI-operator evaluation time per batch", ("operator",)),
    "aisql_storage_events_total": (
        "counter", "chunk spills and reloads", ("event",)),
    "aisql_storage_bytes": (
        "gauge", "bytes resident in memory vs spilled", ("state",)),
}

BUCKET_START = 1e-4
BUCKET_FACTOR = 2.0 ** 0.5
BUCKET_COUNT = 48
BUCKET_BOUNDS = tuple(BUCKET_START * BUCKET_FACTOR ** i
                      for i in range(BUCKET_COUNT))
# relative quantile error returning bucket midpoints (documented bound)
QUANTILE_REL_ERROR = (BUCKET_FACTOR - 1.0) / (BUCKET_FACTOR + 1.0)


def locked_snapshot(lock, fn):
    """Run ``fn`` under ``lock`` and return its result.

    The one sanctioned way to read counters a dispatcher mutates —
    `Scheduler.stats_snapshot()` and `PipelineStats` reads both route
    through here so no snapshot ever sees a torn update.
    """
    with lock:
        return fn()


class _Child:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        self.counts = [0] * (BUCKET_COUNT + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        self.counts[bisect_left(BUCKET_BOUNDS, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q):
        """Quantile estimate from bucket midpoints; 0.0 when empty.
        Monotone in q (cumulative counts), so p95 >= p50 always holds."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and cum > 0 and c > 0 or cum >= self.count:
                lower = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                upper = (BUCKET_BOUNDS[i] if i < BUCKET_COUNT
                         else BUCKET_BOUNDS[-1] * BUCKET_FACTOR)
                return (lower + upper) / 2.0
        return BUCKET_BOUNDS[-1] * BUCKET_FACTOR

    def merge(self, other):
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self


class Family:
    def __init__(self, registry, name, mtype, help_text, label_names):
        self.registry = registry
        self.name = name
        self.type = mtype
        self.help = help_text
        self.label_names = tuple(label_names)
        self._children = {}

    def labels(self, *values, **kv):
        if kv:
            values = tuple(kv.get(n, "") for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                "family %r takes labels %r, got %r"
                % (self.name, self.label_names, values))
        with self.registry._lock:
            child = self._children.get(values)
            if child is None:
                child = (_HistChild() if self.type == "histogram"
                         else _Child())
                self._children[values] = child
            return child

    # counter / gauge convenience on the family itself (label-less or
    # label-forwarding)
    def inc(self, amount=1.0, **labels):
        child = self.labels(**labels)
        with self.registry._lock:
            child.value += amount

    def set(self, value, **labels):
        child = self.labels(**labels)
        with self.registry._lock:
            child.value = value

    def observe(self, value, **labels):
        child = self.labels(**labels)
        with self.registry._lock:
            child.observe(value)

    def merged(self):
        """All children merged into one (histograms only)."""
        out = _HistChild()
        with self.registry._lock:
            for child in self._children.values():
                out.merge(child)
        return out


class MetricsRegistry:
    """Registry of labeled metric families plus scrape-time collectors.

    Collectors are callables returning ``(family_name, labels_dict,
    value)`` samples; components that already keep their own locked
    counters (pipeline, scheduler, spill manager, backends) register a
    collector so the registry exposes the *same* numbers their report
    objects read — the two can never disagree.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}
        self._collectors = []

    def _family(self, name, mtype):
        spec = METRIC_FAMILIES.get(name)
        if spec is None:
            raise ValueError("unknown metric family %r — declare it in "
                             "repro_torch.obs.metrics.METRIC_FAMILIES" % (name,))
        if spec[0] != mtype:
            raise ValueError("family %r is a %s, not a %s"
                             % (name, spec[0], mtype))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(self, name, spec[0], spec[1], spec[2])
                self._families[name] = fam
            return fam

    def counter(self, name):
        return self._family(name, "counter")

    def gauge(self, name):
        return self._family(name, "gauge")

    def histogram(self, name):
        return self._family(name, "histogram")

    def register_collector(self, fn):
        with self._lock:
            self._collectors.append(fn)

    # -- snapshot / exposition --------------------------------------------

    def _collector_samples(self):
        samples = []
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            for name, labels, value in fn():
                if name not in METRIC_FAMILIES:
                    raise ValueError("collector produced unknown family %r"
                                     % (name,))
                samples.append((name, labels, value))
        return samples

    def snapshot(self):
        """Plain-dict snapshot of every family (JSON-serializable)."""
        out = {}
        with self._lock:
            fams = list(self._families.items())
        for name, fam in fams:
            series = []
            with self._lock:
                children = list(fam._children.items())
            for values, child in children:
                labels = dict(zip(fam.label_names, values))
                if fam.type == "histogram":
                    series.append({"labels": labels, "sum": child.sum,
                                   "count": child.count,
                                   "buckets": list(child.counts)})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[name] = {"type": fam.type, "help": fam.help,
                         "labels": list(fam.label_names), "series": series}
        for name, labels, value in self._collector_samples():
            spec = METRIC_FAMILIES[name]
            entry = out.setdefault(
                name, {"type": spec[0], "help": spec[1],
                       "labels": list(spec[2]), "series": []})
            entry["series"].append({"labels": dict(labels), "value": value})
        return out

    def render_prometheus(self):
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        snap = self.snapshot()
        for name in sorted(snap):
            fam = snap[name]
            lines.append("# HELP %s %s" % (name, fam["help"]))
            lines.append("# TYPE %s %s" % (name, fam["type"]))
            for s in fam["series"]:
                lbl = _fmt_labels(s["labels"])
                if fam["type"] == "histogram":
                    cum = 0
                    for i, c in enumerate(s["buckets"]):
                        cum += c
                        le = ("+Inf" if i >= BUCKET_COUNT
                              else _fmt_num(BUCKET_BOUNDS[i]))
                        bl = dict(s["labels"])
                        bl["le"] = le
                        lines.append("%s_bucket%s %d"
                                     % (name, _fmt_labels(bl), cum))
                    lines.append("%s_sum%s %s"
                                 % (name, lbl, _fmt_num(s["sum"])))
                    lines.append("%s_count%s %d" % (name, lbl, s["count"]))
                else:
                    lines.append("%s%s %s" % (name, lbl,
                                              _fmt_num(s["value"])))
        return "\n".join(lines) + "\n"


def _fmt_labels(labels):
    if not labels:
        return ""
    parts = ["%s=\"%s\"" % (k, str(v).replace("\\", "\\\\")
                            .replace('"', '\\"').replace("\n", "\\n"))
             for k, v in sorted(labels.items())]
    return "{" + ",".join(parts) + "}"


def _fmt_num(v):
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text):
    """Minimal Prometheus text-format parser.

    Returns ``{metric_name: [(labels_dict, value), ...]}``.  Raises
    ``ValueError`` on a malformed sample line — CI's bench-smoke job
    uses this to assert ``/v1/metrics`` stays parseable.
    """
    out = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError("malformed metric line: %r" % (raw,))
        name, labelpart, value = m.group(1), m.group(2), m.group(3)
        labels = {}
        if labelpart:
            for lm in _LABEL_RE.finditer(labelpart):
                labels[lm.group(1)] = (lm.group(2)
                                       .replace('\\"', '"')
                                       .replace("\\n", "\n")
                                       .replace("\\\\", "\\"))
        try:
            val = float(value)
        except ValueError:
            raise ValueError("malformed metric value: %r" % (raw,))
        out.setdefault(name, []).append((labels, val))
    return out
