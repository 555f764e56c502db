"""Hierarchical span tracing with deterministic IDs and injectable clocks.

A :class:`Tracer` records one query's execution as a tree of spans
(parse -> optimize -> execute -> partition -> predicate -> dispatch).
Span IDs are a per-tracer counter and the clock is injectable, so the
serialized tree is byte-identical across runs of a seeded workload
(``TickClock``) while still carrying real wall-clock timings in
production (``time.perf_counter``).

The tracer is activated per query on the executing thread via the
``activate`` context manager; deep call sites (pipeline, scheduler,
spill manager) fetch it with ``active_tracer()`` — which returns the
shared no-op tracer when tracing is off, so the disabled path costs a
thread-local read and an attribute check.

Below ``dispatch.replica`` the engines keep trees of their own: each
continuous-batcher wave (``engine.wave`` > ``engine.step`` > ``step.*``
phases) is recorded by a :class:`Tracer` of its own on
``time.perf_counter`` and put into the process-wide engine ring
(``obs/engine.py``, ``engine_ring()``), not into the query's tree.  They
record only while the process's ``Observability`` is enabled or a torch
profiler runs (the gate), and carry each phase's CUDA stream time as
``device_ms``.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager

# ---------------------------------------------------------------------------
# Taxonomy — the single source of truth the docs (and test_docs) check
# against.  Adding an instrumentation site means adding its kind here.

SPAN_KINDS = {
    "query": "root span for one SQL statement; wall time of the whole call",
    "parse": "SQL text to AST",
    "optimize": "logical plan to physical plan (cost races, memo, rewrites)",
    "execute": "physical plan execution incl. pipeline flush",
    "pilot": "cold-predicate pilot sampling pass",
    "partition": "one partition-pull morsel (streaming executor)",
    "predicate": "one AI predicate evaluated over a row batch",
    "cascade": "proxy/oracle cascade run for one predicate batch",
    "pipeline.dispatch": "one coalesced batch leaving the request pipeline",
    "dispatch.replica": "one batch attempt on one backend replica",
    "engine.wave": "one continuous-batcher serve() call: the root of a "
                   "tree in the engine ring",
    "engine.step": "one prefill or decode step of the continuous batcher",
    "step.upload": "host step arrays, device state and their uploads",
    "step.gather": "the paged KV pool gathered into the dense cache",
    "step.forward": "the model's layers over the step's tokens",
    "step.logits": "the row pick and the output head (and argmax in "
                   "decode)",
    "step.scatter": "the step's new keys and values scattered to the pool",
    "step.readback": "logits or sampled tokens copied to the host",
    "layer.attn": "an MLA layer's attention over the latent cache, inside "
                  "step.forward",
    "layer.ffn": "an MLA layer's feed-forward (dense or experts), inside "
                 "step.forward",
}

EVENT_KINDS = {
    "optimize.memo_hit": "plan memo returned a cached physical plan",
    "optimize.cost_race": "cost race between candidate rewrites",
    "optimize.rewrite": "a rewrite decision recorded by the optimizer",
    "pipeline.dedup_hit": "request matched cache or an in-flight duplicate",
    "pipeline.coalesce": "submissions coalesced into one dispatch batch",
    "pipeline.retry": "pipeline-level retry after a dispatch failure",
    "scheduler.retry": "scheduler retried a batch on another replica",
    "cascade.proxy": "cascade scored a batch with the proxy model",
    "cascade.escalate": "cascade escalated rows to the oracle model",
    "partition.early_stop": "LIMIT satisfied; remaining partitions skipped",
    "partition.reorder": "adaptive predicate reorder between partitions",
    "storage.spill": "a column chunk was spilled to disk",
    "storage.reload": "a spilled chunk was reloaded into memory",
}


class TickClock:
    """Deterministic clock: call n returns ``n * step`` seconds.

    Injected into a tracer so span timings (and therefore the serialized
    span tree) are byte-stable across runs of the same seeded workload.
    """

    def __init__(self, step: float = 0.001):
        self.step = step
        self._n = 0

    def __call__(self) -> float:
        t = self._n * self.step
        self._n += 1
        return t


class Span:
    __slots__ = ("name", "kind", "span_id", "parent_id", "t0", "t1",
                 "attrs", "events", "children")

    def __init__(self, name, kind, span_id, parent_id, t0):
        self.name = name
        self.kind = kind
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1 = t0
        self.attrs = {}
        self.events = []
        self.children = []

    def set(self, **attrs):
        """Attach attributes (rows in/out, tokens, credits, model, ...)."""
        self.attrs.update(attrs)
        return self

    def to_dict(self):
        return {
            "name": self.name,
            "kind": self.kind,
            "id": self.span_id,
            "parent": self.parent_id,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": self.attrs,
            "events": self.events,
            "children": [c.to_dict() for c in self.children],
        }


class _NoopSpan:
    __slots__ = ()

    def set(self, **attrs):
        return self


_NOOP_SPAN = _NoopSpan()


class _NoopCtx:
    """Reusable context manager yielding the shared no-op span."""
    __slots__ = ()

    def __enter__(self):
        return _NOOP_SPAN

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


class _NoopTracer:
    """Shared disabled tracer: every operation is a constant-time no-op."""
    enabled = False

    def span(self, name, kind="span", **attrs):
        return _NOOP_CTX

    def event(self, name, **attrs):
        pass

    def now(self):
        return 0.0

    def to_dict(self):
        return None


NOOP = _NoopTracer()


class Tracer:
    """Per-query span recorder.

    Single-threaded by construction: one tracer belongs to the one
    thread executing its query (serving workers run whole sessions), so
    no locking is needed on the span stack.
    """
    enabled = True

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else time.perf_counter
        self._next = 0
        self._stack = []
        self.roots = []

    def now(self) -> float:
        return self.clock()

    def _new_span(self, name, kind):
        self._next += 1
        parent = self._stack[-1] if self._stack else None
        sp = Span(name, kind, self._next,
                  parent.span_id if parent is not None else 0,
                  self.now())
        if parent is not None:
            parent.children.append(sp)
        else:
            self.roots.append(sp)
        return sp

    @contextmanager
    def span(self, name, kind="span", **attrs):
        sp = self._new_span(name, kind)
        if attrs:
            sp.attrs.update(attrs)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.t1 = self.now()

    def event(self, name, **attrs):
        """Point-in-time event attached to the innermost open span."""
        if not self._stack:
            return
        ev = {"name": name, "t": self.now()}
        if attrs:
            ev["attrs"] = attrs
        self._stack[-1].events.append(ev)

    # -- export ------------------------------------------------------------

    def root(self):
        return self.roots[0] if self.roots else None

    def to_dict(self):
        r = self.root()
        return r.to_dict() if r is not None else None


def to_json(tree) -> str:
    """Canonical JSON for a span tree dict — the byte-stable form the
    determinism tests compare."""
    return json.dumps(tree, sort_keys=True, separators=(",", ":"))


def to_chrome(tree, pid=1, tid=1):
    """Span tree dict -> Chrome-trace (chrome://tracing / Perfetto) JSON
    object with complete ("X") events and instant ("i") events."""
    out = []

    def walk(node):
        args = dict(node.get("attrs") or {})
        out.append({
            "name": node["name"], "cat": node["kind"], "ph": "X",
            "ts": node["t0"] * 1e6,
            "dur": max(0.0, (node["t1"] - node["t0"])) * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
        for ev in node.get("events") or []:
            out.append({
                "name": ev["name"], "cat": "event", "ph": "i", "s": "t",
                "ts": ev["t"] * 1e6, "pid": pid, "tid": tid,
                "args": dict(ev.get("attrs") or {}),
            })
        for c in node.get("children") or []:
            walk(c)

    if tree is not None:
        walk(tree)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def critical_path(tree):
    """The chain of longest-duration child spans from the root down.

    Returns a one-line summary of where wall time went, e.g.
    ``query > execute > partition[2] > predicate(f0) 1.234s (87% of query)``.
    """
    if not tree:
        return ""
    total = max(tree["t1"] - tree["t0"], 0.0)
    path = [tree]
    node = tree
    while node.get("children"):
        node = max(node["children"], key=lambda c: c["t1"] - c["t0"])
        path.append(node)
    leaf_dur = max(node["t1"] - node["t0"], 0.0)
    pct = 100.0 * leaf_dur / total if total > 0 else 0.0
    chain = " > ".join(p["name"] for p in path)
    return "critical path: %s  %.4fs (%.0f%% of query)" % (chain, leaf_dur, pct)


def walk_spans(tree):
    """Yield every span dict in a tree, depth-first."""
    if not tree:
        return
    stack = [tree]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.get("children") or [])


# ---------------------------------------------------------------------------
# Thread-local activation

_tls = threading.local()


def active_tracer():
    """The tracer bound to this thread, or the shared no-op tracer."""
    return getattr(_tls, "tracer", None) or NOOP


@contextmanager
def activate(tracer):
    """Bind ``tracer`` to the current thread for the duration."""
    prev = getattr(_tls, "tracer", None)
    _tls.tracer = tracer
    try:
        yield tracer
    finally:
        _tls.tracer = prev


class TraceRing:
    """Bounded ring of recent span trees keyed by query id (serving's
    ``/v1/trace/<query_id>`` backing store)."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._items = {}
        self._order = []

    def put(self, query_id, tree):
        with self._lock:
            if query_id in self._items:
                self._order.remove(query_id)
            self._items[query_id] = tree
            self._order.append(query_id)
            while len(self._order) > self.capacity:
                evict = self._order.pop(0)
                del self._items[evict]

    def get(self, query_id):
        with self._lock:
            return self._items.get(query_id)

    def ids(self):
        with self._lock:
            return list(self._order)

    def __len__(self):
        with self._lock:
            return len(self._order)
