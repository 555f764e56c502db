"""Unified observability: span tracing + metrics registry.

One :class:`Observability` object bundles what a serving process needs:

- a tracer factory (deterministic IDs, injectable clock) producing one
  span tree per query, stored on ``QueryReport.trace`` and in a bounded
  :class:`TraceRing` served at ``/v1/trace/<query_id>``;
- a :class:`MetricsRegistry` of labeled counter/gauge/histogram
  families, exposed at ``/v1/metrics`` in Prometheus text format.

``enabled`` gates *tracing* only — metrics are always recorded once an
Observability object is attached, because they are cheap (a dict lookup
and a locked increment) while span trees allocate per call site.

The engines' continuous batchers record one span tree per wave (steps and
their phases, with CUDA stream times) into a second, process-wide ring,
:func:`engine_ring`, keyed ``"<engine_id>/<wave n>"`` (``obs/engine.py``).
Their gate: the ``Observability`` that ``ServingEngine`` hands its engines
is enabled, or a torch profiler runs; otherwise a step records nothing.
"""
from .metrics import (BUCKET_BOUNDS, BUCKET_COUNT, BUCKET_FACTOR,
                      BUCKET_START, METRIC_FAMILIES, QUANTILE_REL_ERROR,
                      MetricsRegistry, locked_snapshot,
                      parse_prometheus_text)
from .trace import (EVENT_KINDS, NOOP, SPAN_KINDS, Span, TickClock, TraceRing,
                    Tracer, activate, active_tracer, critical_path, to_chrome,
                    to_json, walk_spans)
from .engine import engine_ring

__all__ = [
    "Observability", "Tracer", "Span", "TickClock", "TraceRing", "NOOP",
    "activate", "active_tracer", "critical_path", "to_chrome", "to_json",
    "walk_spans", "SPAN_KINDS", "EVENT_KINDS", "MetricsRegistry",
    "METRIC_FAMILIES", "locked_snapshot", "parse_prometheus_text",
    "QUANTILE_REL_ERROR", "BUCKET_BOUNDS", "BUCKET_COUNT", "BUCKET_FACTOR",
    "BUCKET_START", "engine_ring",
]


class Observability:
    """Tracing + metrics for one engine or serving process.

    ``clock`` is a *factory* of clock callables — pass ``TickClock`` to
    give every query tracer a fresh deterministic clock (byte-stable
    span trees under ``tools/replay.py``); the default is wall time.
    """

    def __init__(self, enabled=True, clock=None, ring_size=64,
                 registry=None):
        self.enabled = enabled
        self.clock = clock
        self.registry = registry if registry is not None else MetricsRegistry()
        self.ring = TraceRing(ring_size)

    def tracer(self):
        """A fresh per-query tracer, or the shared no-op when disabled."""
        if not self.enabled:
            return NOOP
        return Tracer(clock=self.clock() if self.clock is not None else None)
