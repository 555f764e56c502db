"""Concurrent multi-tenant query serving — the production front of the
engine (paper §2's "heavy traffic" premise made concrete).

`AisqlEngine.sql()` is a blocking single-query call; this module turns a
catalog + scheduler into a **serving runtime** that keeps N queries in
flight at once while sharing the expensive state across all of them:

  * one `RequestPipeline` (thread-safe, single-dispatcher) shared by
    every session, so coalescing, dedup and the TTL'd LRU result cache
    work **across** concurrent queries and tenants — the repeated
    predicates of a production workload are answered once and served
    from cache everywhere else (`PipelineStats.cross_query_hits`);
  * one `StatsStore`, so every session plans with the statistics every
    other session has already learned;
  * one `Scheduler` + backend pool, with the pipeline's bounded
    retry-with-backoff riding the scheduler's replica retries — an
    injected transient fault re-dispatches, it never drops a request or
    bills it twice.

Admission is **per-tenant fair share**: each tenant has a `TenantPolicy`
with a credit budget (hard spend ceiling, checked at admission) and a
token bucket (``queries_per_s`` + ``burst``) that rate-limits how fast
its queries may start.  Billing is exact: the shared pipeline routes
each dispatched result to the owning session's meter (registered per
owner at dispatch time), so the sum of per-tenant credit meters always
equals the pipeline's dispatch spend — dedup/cache hits cost the hitting
tenant nothing, exactly the §4 accounting the paper surfaces.

Lifecycle: ``submit(tenant, sql)`` returns a `QueryTicket` immediately;
a pool of worker threads admits and executes tickets on per-tenant
`QuerySession`s (checked out per query, so one tenant may have several
queries in flight, each on its own executor).  ``drain()`` waits for all
submitted work; ``report()`` distils per-tenant spend, queue waits and
latency percentiles plus the shared pipeline/scheduler fault and cache
telemetry into a `ServingReport`.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cost import Catalog
from repro_torch.core.engine import AisqlEngine, QueryReport
from repro_torch.core.executor import ExecConfig
from repro_torch.core.optimizer import OptimizerConfig
from repro_torch.core.stats import PredObservation, StatsStore, \
    predicate_fingerprint
from repro_torch.inference.api import CortexClient
from repro_torch.inference.pipeline import PipelineConfig, RequestPipeline
from repro_torch.inference.scheduler import Scheduler
from repro_torch.obs import Observability
from repro_torch.obs.metrics import MetricsRegistry, _HistChild
from repro_torch.tables.table import Table


class AdmissionError(RuntimeError):
    """A query was refused at admission (tenant exhausted its credit
    budget); raised by ``QueryTicket.result()``."""


# ---------------------------------------------------------------------------
# tenants: policy, token bucket, meter
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantPolicy:
    """Fair-share admission knobs for one tenant.

    ``credit_budget``: hard ceiling on the tenant's dispatched AI-credit
    spend; a query arriving after the meter reaches it is rejected with
    `AdmissionError` (None = unlimited).  ``queries_per_s`` / ``burst``
    parameterize a token bucket: each admitted query consumes one token,
    tokens refill at ``queries_per_s`` up to ``burst`` — a tenant may
    burst, then settles to its fair rate while other tenants' queries
    interleave.
    """
    credit_budget: Optional[float] = None
    queries_per_s: float = math.inf
    burst: int = 8


class TokenBucket:
    """Thread-safe token bucket; ``acquire`` blocks until a token is
    available and returns the seconds waited."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.capacity = max(int(burst), 1)
        self._tokens = float(self.capacity)
        self._updated = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self) -> Tuple[bool, float]:
        """Non-blocking: ``(True, 0.0)`` and one token consumed, or
        ``(False, seconds_until_next_token)``."""
        with self._lock:
            now = time.monotonic()
            if self.rate != math.inf:
                self._tokens = min(
                    self.capacity,
                    self._tokens + (now - self._updated) * self.rate)
            self._updated = now
            if self.rate == math.inf or self._tokens >= 1.0:
                if self.rate != math.inf:
                    self._tokens -= 1.0
                return True, 0.0
            return False, (1.0 - self._tokens) / max(self.rate, 1e-9)

    def peek(self) -> Tuple[bool, float]:
        """Like ``try_acquire`` but non-consuming: would a token be
        available right now, and if not, how long until one refills?
        (The HTTP front door sheds load with this — a 429 with
        Retry-After — without stealing the token an admitted query
        will consume.)"""
        with self._lock:
            now = time.monotonic()
            tokens = self._tokens
            if self.rate != math.inf:
                tokens = min(self.capacity,
                             tokens + (now - self._updated) * self.rate)
            if self.rate == math.inf or tokens >= 1.0:
                return True, 0.0
            return False, (1.0 - tokens) / max(self.rate, 1e-9)

    def acquire(self) -> float:
        t0 = time.perf_counter()
        while True:
            ok, shortfall = self.try_acquire()
            if ok:
                return time.perf_counter() - t0
            time.sleep(min(shortfall, 0.05))


class TenantMeter:
    """Per-tenant serving accounting, held as a *view* over the metrics
    registry: credits, call counts and query outcomes are registry
    counter children, queue-wait/latency are exponential-bucket
    histogram children — so ``ServingReport``, ``/v1/metrics`` and the
    tenant meter can never disagree, and percentiles cover the whole
    run instead of a bounded last-N sample window whose tail silently
    vanished on long runs (the old ``MAX_SAMPLES`` deques)."""

    def __init__(self, name: str, policy: TenantPolicy,
                 registry: Optional[MetricsRegistry] = None):
        self.name = name
        self.policy = policy
        self.bucket = TokenBucket(policy.queries_per_s, policy.burst)
        self.lock = threading.Lock()
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self._queries = reg.counter("aisql_queries_total")
        self._credits = reg.counter("aisql_credits_total").labels(
            tenant=name)
        self._calls = reg.counter(
            "aisql_dispatched_calls_total").labels(tenant=name)
        self.queue_hist = reg.histogram(
            "aisql_queue_wait_seconds").labels(tenant=name)
        self.latency_hist = reg.histogram(
            "aisql_query_latency_seconds").labels(tenant=name)
        self._status = {
            s: self._queries.labels(tenant=name, status=s)
            for s in ("submitted", "completed", "failed", "rejected")}

    def mark(self, status: str, n: int = 1) -> None:
        """Count a query lifecycle transition
        (submitted/completed/failed/rejected)."""
        with self.lock:
            self._status[status].value += n

    def record(self, queue_wait_s: float, latency_s: float) -> None:
        with self.lock:
            self._status["completed"].value += 1
            self.queue_hist.observe(queue_wait_s)
            self.latency_hist.observe(latency_s)

    def bill(self, results) -> None:
        """Dispatch-time hook: exact spend attribution (conservation:
        summing this over tenants gives the pipeline's dispatch spend)."""
        with self.lock:
            self._calls.value += len(results)
            for r in results:
                self._credits.value += r.credits

    # registry-backed reads (the report and admission control use these)
    @property
    def credits(self) -> float:
        return self._credits.value

    @property
    def dispatched_calls(self) -> int:
        return int(self._calls.value)

    @property
    def submitted(self) -> int:
        return int(self._status["submitted"].value)

    @property
    def completed(self) -> int:
        return int(self._status["completed"].value)

    @property
    def failed(self) -> int:
        return int(self._status["failed"].value)

    @property
    def rejected(self) -> int:
        return int(self._status["rejected"].value)

    @property
    def over_budget(self) -> bool:
        b = self.policy.credit_budget
        return b is not None and self.credits >= b


# ---------------------------------------------------------------------------
# cross-tenant statistics sharing
# ---------------------------------------------------------------------------


class TenantStatsStore(StatsStore):
    """Per-tenant statistics with cross-tenant *prior* sharing.

    The ``"priors"`` stat-sharing mode gives each tenant its own store
    (its ground truth: every observation its queries produce) while all
    writes are additionally folded into one shared pool.  Reads prefer
    the tenant's own evidence; when the tenant is cold for a fingerprint
    the pool answers instead — as a **capped copy** (at most
    ``prior_rows`` evidence rows, every counter scaled down
    proportionally) flagged ``shared_prior``, which the cost model
    surfaces as the ``"transferred"`` estimate tier and keeps blended
    rather than trusted raw.  Isolation properties:

      * another tenant's history can never outweigh this tenant's own
        fresh observations (the cap bounds borrowed confidence);
      * billing and per-tenant telemetry are untouched — sharing moves
        selectivity/cost *priors*, never credits or results.
    """

    def __init__(self, shared: StatsStore, *, prior_rows: int = 48):
        # set before super().__init__: the version property reads it
        self.shared = shared
        self._version = 0
        super().__init__()
        self.prior_rows = max(int(prior_rows), 1)

    # -- version: own writes and *other tenants'* pool writes must both
    # invalidate this tenant's transferred-prior cache
    @property
    def version(self) -> int:                       # type: ignore[override]
        return self._version + self.shared.version

    @version.setter
    def version(self, value: int) -> None:
        self._version = value - self.shared.version

    # -- writes: own ground truth AND the shared pool -------------------
    def observe_predicate(self, key, **kw):
        self.shared.observe_predicate(key, **kw)
        return super().observe_predicate(key, **kw)

    def note_query(self, keys) -> None:
        self.shared.note_query(keys)
        super().note_query(keys)

    def observe_cascade(self, key, **kw):
        self.shared.observe_cascade(key, **kw)
        return super().observe_cascade(key, **kw)

    def observe_index(self, key, **kw):
        self.shared.observe_index(key, **kw)
        return super().observe_index(key, **kw)

    def observe_pipeline(self, **kw):
        self.shared.observe_pipeline(**kw)
        return super().observe_pipeline(**kw)

    def register_prompt(self, key: str, text: str) -> None:
        self.shared.register_prompt(key, text)
        super().register_prompt(key, text)

    # -- reads: own evidence first, capped pool prior second ------------
    def _shared_view(self, key: str) -> Optional[PredObservation]:
        src = self.shared.get(key)
        if src is None:
            return None
        view = PredObservation.from_dict(src.to_dict())
        if view.evaluated > self.prior_rows:
            f = self.prior_rows / view.evaluated
            for fld in dataclasses.fields(view):
                v = getattr(view, fld.name)
                scaled = v * f
                setattr(view, fld.name,
                        int(round(scaled)) if isinstance(v, int)
                        else scaled)
        # dynamic attribute, NOT a dataclass field: merge()/to_dict()
        # must never treat provenance as an additive counter
        view.shared_prior = True
        return view

    def get(self, key: str) -> Optional[PredObservation]:
        own = super().get(key)
        if own is not None and own.evaluated > 0:
            return own
        return self._shared_view(key) or own

    def for_pred(self, pred) -> Optional[PredObservation]:
        return self.get(predicate_fingerprint(pred))

    def confident(self, key: str, *, min_rows: int = 32) -> bool:
        if super().confident(key, min_rows=min_rows):
            return True
        view = self._shared_view(key)
        return view is not None and view.evaluated >= min_rows

    def items(self):
        merged: Dict[str, Optional[PredObservation]] = {
            k: self._shared_view(k) for k, _ in self.shared.items()}
        for k, o in super().items():
            if o.evaluated > 0:
                merged[k] = o
        return iter([(k, o) for k, o in merged.items() if o is not None])

    def prompt_text(self, key: str) -> Optional[str]:
        return (super().prompt_text(key)
                or self.shared.prompt_text(key))

    def prompt_texts(self) -> Dict[str, str]:
        out = self.shared.prompt_texts()
        out.update(super().prompt_texts())
        return out


# ---------------------------------------------------------------------------
# tickets and sessions
# ---------------------------------------------------------------------------


class QueryTicket:
    """Handle for one submitted query; resolves to a `Table` (or raises
    the query's error) on ``result()``.  Tickets submitted with
    ``stream=True`` additionally expose ``batches()``: an iterator of
    partition-incremental `Table` batches, available while the query is
    still executing (the HTTP front-end turns these into NDJSON lines).
    """

    def __init__(self, tenant: str, sql: str, *, stream: bool = False,
                 query_id: str = ""):
        self.tenant = tenant
        self.sql = sql
        self.stream = stream
        self.query_id = query_id    # serving-assigned ("q000001", ...)
        self.submitted_at = time.perf_counter()
        self.queue_wait_s = 0.0     # submit -> execution start
        self.wall_s = 0.0           # execution only
        self.report: Optional[QueryReport] = None
        self._done = threading.Event()
        self._table: Optional[Table] = None
        self._error: Optional[Exception] = None
        # None-terminated batch stream; only populated for stream=True
        self._batchq: Optional["queue.Queue[Optional[Table]]"] = (
            queue.Queue() if stream else None)

    def done(self) -> bool:
        return self._done.is_set()

    def exception(self) -> Optional[Exception]:
        return self._error

    def result(self, timeout: Optional[float] = None) -> Table:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query not finished after {timeout}s: {self.sql[:60]!r}")
        if self._error is not None:
            raise self._error
        assert self._table is not None
        return self._table

    def batches(self, timeout: Optional[float] = None):
        """Yield result batches as the executor produces them; raises the
        query's error (if any) after the stream ends.  Only valid for
        tickets submitted with ``stream=True``."""
        if self._batchq is None:
            raise ValueError("ticket was not submitted with stream=True")
        while True:
            try:
                batch = self._batchq.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no batch after {timeout}s: {self.sql[:60]!r}")
            if batch is None:
                break
            yield batch
        if self._error is not None:
            raise self._error

    def _finish(self) -> None:
        """Mark terminal (worker-side): wake ``result()`` waiters and
        terminate the batch stream exactly once."""
        self._done.set()
        if self._batchq is not None:
            self._batchq.put(None)


class QuerySession:
    """One tenant's execution context: a private `AisqlEngine` (its own
    executor/optimizer state) over a `CortexClient` that shares the
    serving runtime's pipeline, scheduler and stats store.  Sessions are
    single-threaded by construction — the serving engine checks one out
    per in-flight query and returns it afterwards."""

    def __init__(self, owner: str, tenant: str, meter: TenantMeter,
                 catalog: Catalog, scheduler: Scheduler,
                 pipeline: RequestPipeline, stats: StatsStore,
                 cfg: "ServingConfig", semindex=None, obs=None):
        self.owner = owner
        self.tenant = tenant
        # tenant billing chains onto the client meter in one registered
        # hook: the pipeline calls exactly one hook per dispatched
        # result, so spend lands on both the client (QueryReport) and
        # the tenant (ServingReport) exactly once
        self.client = CortexClient(
            scheduler, default_model=cfg.default_model,
            proxy_model=cfg.proxy_model, pipeline=pipeline, owner=owner,
            on_dispatch_extra=meter.bill)
        # ``semindex`` is the serving engine's *shared* manager: one
        # embedding store and one set of ANN indexes across every
        # session and tenant (an index built for tenant A's query
        # answers tenant B's for free; the manager is lock-protected)
        self.engine = AisqlEngine(
            catalog, self.client, optimizer=cfg.optimizer,
            executor=cfg.executor, stats=stats, semindex=semindex,
            obs=obs)

    def run(self, sql: str,
            on_batch=None) -> Tuple[Table, Optional[QueryReport]]:
        out = self.engine.sql(sql, on_batch=on_batch)
        return out, self.engine.last_report


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantReport:
    """One tenant's slice of a `ServingReport`.

    Percentiles come from the registry's exponential-bucket histograms
    (no raw samples kept): each is a bucket midpoint, with relative
    error at most ``repro_torch.obs.metrics.QUANTILE_REL_ERROR`` (≈17% for
    the √2 buckets) — in exchange the estimate covers **every** query
    of the run, not a bounded last-N window."""
    tenant: str
    queries: int                    # submitted
    completed: int
    failed: int
    rejected: int                   # refused at admission (budget)
    credits_spent: float            # dispatch-billed AI credits
    credit_budget: Optional[float]
    dispatched_calls: int           # LLM requests billed to this tenant
    queue_wait_p50_s: float
    queue_wait_p95_s: float
    latency_p50_s: float
    latency_p95_s: float


@dataclasses.dataclass
class ServingReport:
    """Everything the serving runtime observed: per-tenant accounting
    plus the shared pipeline/scheduler/backend telemetry."""
    tenants: Dict[str, TenantReport]
    queries: int                    # total submitted
    total_credits: float            # sum of tenant meters (== dispatch spend)
    backend_credits: Optional[float]  # backends' own meter (conservation)
    submitted_requests: int         # requests entering the shared pipeline
    dispatched_requests: int        # requests actually sent to engines
    dedup_hits: int                 # in-flight + cache hits
    cache_hits: int                 # memoized-result hits
    cross_query_hits: int           # hits served across sessions/tenants
    cache_expired: int              # TTL evictions
    cancelled_requests: int         # withdrawn pre-dispatch (never billed)
    retries: int                    # pipeline batch re-dispatches
    scheduler_retries: int          # scheduler-level replica retries
    scheduler_timeouts: int         # of those, engine timeouts
    failed_requests: int            # requests that exhausted all retries
    queue_wait_p50_s: float         # across all completed queries
    queue_wait_p95_s: float
    latency_p50_s: float
    latency_p95_s: float
    # aggregated spill-manager counters (chunked catalog tables + the
    # embedding store); None when nothing spillable is attached
    storage: Optional[Dict[str, int]] = None

    def render(self) -> str:
        lines = [
            f"-- serving: {self.queries} queries, "
            f"{self.total_credits:.6g} credits "
            f"({self.dispatched_requests}/{self.submitted_requests} "
            f"requests dispatched, {self.dedup_hits} dedup hits, "
            f"{self.cross_query_hits} cross-query)",
            f"-- faults: {self.retries} pipeline retries, "
            f"{self.scheduler_retries} scheduler retries "
            f"({self.scheduler_timeouts} timeouts), "
            f"{self.failed_requests} permanent failures, "
            f"{self.cancelled_requests} cancelled",
            f"-- latency: queue p50/p95 {self.queue_wait_p50_s:.3f}/"
            f"{self.queue_wait_p95_s:.3f}s, exec p50/p95 "
            f"{self.latency_p50_s:.3f}/{self.latency_p95_s:.3f}s",
        ]
        if self.storage is not None:
            s = self.storage
            lines.append(
                f"-- storage: peak {s['peak_bytes']} tracked bytes "
                f"({s['tracked_bytes']} resident), "
                f"{s['spill_events']} spills / "
                f"{s['reload_events']} reloads")
        for t in self.tenants.values():
            budget = ("∞" if t.credit_budget is None
                      else f"{t.credit_budget:.4g}")
            lines.append(
                f"--   tenant {t.tenant}: {t.completed}/{t.queries} ok "
                f"({t.rejected} rejected, {t.failed} failed), "
                f"{t.credits_spent:.6g}/{budget} credits, "
                f"{t.dispatched_calls} calls")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingConfig:
    """Policy for a `ServingEngine`."""
    workers: int = 4
    # shared-pipeline policy; the 300s TTL ages cross-query answers out
    pipeline: PipelineConfig = dataclasses.field(
        default_factory=lambda: PipelineConfig(cache_ttl_s=300.0))
    executor: Optional[ExecConfig] = None
    optimizer: Optional[OptimizerConfig] = None
    default_policy: TenantPolicy = dataclasses.field(
        default_factory=TenantPolicy)
    default_model: str = "oracle-70b"
    proxy_model: str = "proxy-8b"
    # cross-tenant statistics sharing:
    #   "full"   — one store; every session reads and writes the same
    #              observations (the historical single-store behaviour);
    #   "priors" — per-tenant ground-truth stores; every write also feeds
    #              a shared pool whose evidence other tenants read back
    #              as capped `shared_prior` copies, surfaced by the cost
    #              model as the "transferred" estimate tier;
    #   "none"   — fully private per-tenant stores, no sharing at all.
    stat_sharing: str = "full"
    # "priors" mode: max evidence rows a tenant may borrow from the pool
    # per fingerprint — another tenant's long history can never outweigh
    # this tenant's own fresh observations
    shared_prior_rows: int = 48
    # observability: tracing + metrics.  None builds a default
    # `Observability` (tracing on, wall-clock, 64-trace ring); pass
    # ``Observability(enabled=False)`` to skip span recording, or one
    # with ``clock=TickClock`` for byte-stable replay traces.
    obs: Optional[Observability] = None


class ServingEngine:
    """Multi-tenant concurrent front door: ``submit`` queries, ``drain``,
    inspect the `ServingReport`.  Usable as a context manager."""

    def __init__(self, catalog: Catalog, scheduler: Scheduler, *,
                 cfg: Optional[ServingConfig] = None,
                 stats: Optional[StatsStore] = None,
                 tenants: Optional[Dict[str, TenantPolicy]] = None,
                 semindex=None, device="cuda"):
        from repro_torch.semindex import SemanticIndexManager, SemIndexConfig
        self.catalog = catalog
        self.scheduler = scheduler
        self.cfg = cfg or ServingConfig()
        if self.cfg.stat_sharing not in ("full", "priors", "none"):
            raise ValueError(
                f"ServingConfig.stat_sharing must be 'full', 'priors' or "
                f"'none', got {self.cfg.stat_sharing!r}")
        self.stats = stats if stats is not None else StatsStore()
        # "priors"/"none": lazily-built per-tenant stores ("full" mode
        # hands every session self.stats directly)
        self._tenant_stats: Dict[str, StatsStore] = {}
        # a manager built here keeps its index on ``device`` (CUDA unless
        # the caller passes "cpu"; no fallback), as `AisqlEngine` does
        if semindex is True:
            semindex = SemanticIndexManager(device=device)
        elif isinstance(semindex, SemIndexConfig):
            semindex = SemanticIndexManager(semindex, device=device)
        # one manager for the whole serving engine: embedding store and
        # ANN indexes are cross-tenant shared state, like the pipeline
        self.semindex = semindex or None
        self.pipeline = RequestPipeline(scheduler, self.cfg.pipeline)
        # observability: one registry + trace ring for the process; the
        # scheduler and pipeline record their per-dispatch families into
        # the same registry the tenant meters live in
        self.obs = self.cfg.obs if self.cfg.obs is not None \
            else Observability()
        self.scheduler.registry = self.obs.registry
        self.pipeline.registry = self.obs.registry
        # the engines record their batchers' spans while tracing is on
        for m in scheduler.hosted_models():
            for e in scheduler.replicas(m):
                if hasattr(e, "obs"):
                    e.obs = self.obs
        self._register_collectors()
        self._lock = threading.Lock()
        self._qids = itertools.count(1)
        self.tenants: Dict[str, TenantMeter] = {
            name: TenantMeter(name, pol, registry=self.obs.registry)
            for name, pol in (tenants or {}).items()}
        self._idle_sessions: Dict[str, List[QuerySession]] = {}
        self._session_ids = itertools.count(1)
        self.sessions_created = 0
        # counter, not a ticket list: retaining tickets would pin every
        # completed query's result table for the engine's lifetime
        self._submitted = 0
        self._queue: "queue.Queue[Optional[QueryTicket]]" = queue.Queue()
        self._closed = False
        self._shutdown_done = threading.Event()
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"aisql-serve-{i}")
            for i in range(max(self.cfg.workers, 1))]
        for w in self._workers:
            w.start()

    def _register_collectors(self) -> None:
        """Expose the pipeline/scheduler/storage counters as scrape-time
        registry samples.  Collectors read the same locked snapshots the
        `ServingReport` reads, so ``/v1/metrics`` and ``report()`` can
        never disagree about these numbers."""
        def pipeline_events():
            # scalar counters only — batch_size_hist is covered by the
            # aisql_pipeline_batch_size histogram the pipeline records
            snap = self.pipeline.stats_snapshot()
            return [("aisql_pipeline_events_total", {"event": k}, float(v))
                    for k, v in snap.items()
                    if isinstance(v, (int, float))]

        def scheduler_events():
            snap = self.scheduler.stats_snapshot()
            return [("aisql_scheduler_events_total", {"event": k}, float(v))
                    for k, v in snap.items()]

        def storage():
            stats = self.storage_stats()
            if stats is None:
                return []
            return [
                ("aisql_storage_events_total", {"event": "spill"},
                 float(stats["spill_events"])),
                ("aisql_storage_events_total", {"event": "reload"},
                 float(stats["reload_events"])),
                ("aisql_storage_bytes", {"state": "resident"},
                 float(stats["tracked_bytes"])),
                ("aisql_storage_bytes", {"state": "peak"},
                 float(stats["peak_bytes"])),
                ("aisql_storage_bytes", {"state": "spilled"},
                 float(stats["spilled_bytes"])),
            ]

        reg = self.obs.registry
        reg.register_collector(pipeline_events)
        reg.register_collector(scheduler_events)
        reg.register_collector(storage)

    @classmethod
    def simulated(cls, catalog: Catalog, *, seed: int = 0,
                  fault_rate: float = 0.0, timeout_rate: float = 0.0,
                  fault_burst_every: int = 0, fault_burst_len: int = 0,
                  replicas: int = 1, **kw) -> "ServingEngine":
        """Convenience: a serving engine over the calibrated simulator
        (optionally with injected transient faults/timeouts; burst
        parameters cluster those faults in attempt-time)."""
        from repro_torch.inference.simulator import SimulatedBackend
        sched = Scheduler()
        for rep in range(max(replicas, 1)):
            sched.register(SimulatedBackend(
                seed=seed, fault_rate=fault_rate, timeout_rate=timeout_rate,
                fault_seed=seed + 101 * rep,
                fault_burst_every=fault_burst_every,
                fault_burst_len=fault_burst_len))
        return cls(catalog, sched, **kw)

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- tenants and sessions -----------------------------------------
    def tenant(self, name: str) -> TenantMeter:
        with self._lock:
            meter = self.tenants.get(name)
            if meter is None:
                meter = TenantMeter(
                    name, dataclasses.replace(self.cfg.default_policy),
                    registry=self.obs.registry)
                self.tenants[name] = meter
            return meter

    def tenant_stats(self, tenant: str) -> StatsStore:
        """The statistics store ``tenant``'s sessions plan with: the one
        shared store ("full"), a `TenantStatsStore` over the shared pool
        ("priors"), or a fully private store ("none")."""
        if self.cfg.stat_sharing == "full":
            return self.stats
        with self._lock:
            store = self._tenant_stats.get(tenant)
            if store is None:
                if self.cfg.stat_sharing == "priors":
                    store = TenantStatsStore(
                        self.stats, prior_rows=self.cfg.shared_prior_rows)
                else:
                    store = StatsStore()
                self._tenant_stats[tenant] = store
            return store

    def _checkout(self, tenant: str) -> QuerySession:
        meter = self.tenant(tenant)
        stats = self.tenant_stats(tenant)
        with self._lock:
            pool = self._idle_sessions.setdefault(tenant, [])
            if pool:
                return pool.pop()
            owner = f"{tenant}#{next(self._session_ids)}"
            self.sessions_created += 1
        return QuerySession(owner, tenant, meter, self.catalog,
                            self.scheduler, self.pipeline, stats,
                            self.cfg, semindex=self.semindex,
                            obs=self.obs)

    def _checkin(self, tenant: str, session: QuerySession) -> None:
        with self._lock:
            self._idle_sessions.setdefault(tenant, []).append(session)

    # -- submission / draining ----------------------------------------
    def submit(self, tenant: str, sql: str, *,
               stream: bool = False) -> QueryTicket:
        """Enqueue one query for ``tenant``; returns immediately.  With
        ``stream=True`` the ticket's ``batches()`` iterator yields result
        batches while the query executes."""
        ticket = QueryTicket(tenant, sql, stream=stream)
        meter = self.tenant(tenant)
        # closed-check and enqueue are one atomic step: a racing close()
        # (which flips _closed under the same lock) can therefore never
        # drain *between* our check and our put, which would strand the
        # ticket unserved and hang its result() forever
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            self._submitted += 1
            ticket.query_id = f"q{next(self._qids):06d}"
            self._queue.put(ticket)
        meter.mark("submitted")
        return ticket

    def run_all(self, workload: List[Tuple[str, str]]) -> List[QueryTicket]:
        """Submit a ``[(tenant, sql), ...]`` workload and drain it."""
        tickets = [self.submit(tenant, sql) for tenant, sql in workload]
        self.drain()
        return tickets

    def drain(self) -> None:
        """Block until every submitted ticket has finished."""
        self._queue.join()

    def close(self) -> None:
        """Drain, then stop the worker threads.  Idempotent and safe
        under concurrency: the first caller performs the shutdown, every
        later (or concurrent) caller blocks until it completes; tickets
        in flight at the moment of the call all finish normally."""
        with self._lock:
            first = not self._closed
            self._closed = True
        if not first:
            self._shutdown_done.wait()
            return
        try:
            self.drain()
            for _ in self._workers:
                self._queue.put(None)
            for w in self._workers:
                if w is not threading.current_thread():
                    w.join(timeout=30.0)
        finally:
            self._shutdown_done.set()

    # -- the worker loop ----------------------------------------------
    def _worker(self) -> None:
        while True:
            ticket = self._queue.get()
            if ticket is None:
                self._queue.task_done()
                return
            requeued = False
            try:
                requeued = self._serve(ticket)
            finally:
                if not requeued:
                    ticket._finish()
                self._queue.task_done()

    def _serve(self, ticket: QueryTicket) -> bool:
        """Admit + execute one ticket.  Returns True when the ticket was
        re-enqueued (rate-limited, token not yet available) — a worker
        must never sleep on one tenant's bucket while other tenants'
        queries are runnable (head-of-line blocking)."""
        meter = self.tenant(ticket.tenant)
        try:
            if meter.over_budget:
                meter.mark("rejected")
                raise AdmissionError(
                    f"tenant {ticket.tenant!r} exhausted its credit "
                    f"budget ({meter.credits:.6g} >= "
                    f"{meter.policy.credit_budget:.6g})")
            admitted, shortfall = meter.bucket.try_acquire()
            if not admitted:            # fair-share rate limiting
                if meter.bucket.rate <= 0.0:
                    # a zero-rate (paused) tenant's bucket never refills:
                    # requeueing would spin forever and hang drain()
                    meter.mark("rejected")
                    raise AdmissionError(
                        f"tenant {ticket.tenant!r} is paused "
                        f"(queries_per_s=0) and its burst is exhausted")
                # brief bounded pause (spin guard when only this
                # tenant's work remains), then back of the queue
                time.sleep(min(shortfall, 0.02))
                self._queue.put(ticket)
                return True
            ticket.queue_wait_s = time.perf_counter() - ticket.submitted_at
            session = self._checkout(ticket.tenant)
            try:
                t0 = time.perf_counter()
                on_batch = (ticket._batchq.put
                            if ticket._batchq is not None else None)
                table, report = session.run(ticket.sql, on_batch=on_batch)
                ticket.wall_s = time.perf_counter() - t0
                ticket.report = report
                ticket._table = table
                if report is not None and report.trace is not None:
                    self.obs.ring.put(ticket.query_id, report.trace)
            finally:
                self._checkin(ticket.tenant, session)
            meter.record(ticket.queue_wait_s, ticket.wall_s)
        except AdmissionError as e:
            ticket._error = e
        except Exception as e:          # the query's own failure
            ticket._error = e
            meter.mark("failed")
        return False

    # -- reporting -----------------------------------------------------
    def storage_stats(self) -> Optional[Dict[str, int]]:
        """Aggregate spill-manager counters across every chunk-backed
        catalog table and the embedding store (managers deduplicated:
        tables sharing one manager are counted once)."""
        managers = {}
        for t in self.catalog.tables.values():
            mgr = getattr(t, "spill", None)
            if mgr is not None:
                managers[id(mgr)] = mgr
        if self.semindex is not None:
            mgr = getattr(self.semindex.store, "spill", None)
            if mgr is not None:
                managers[id(mgr)] = mgr
        if not managers:
            return None
        agg: Dict[str, int] = {}
        for mgr in managers.values():
            for k, v in mgr.stats().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def backend_credits(self) -> Optional[float]:
        """Sum of the backends' own credit meters (independent source
        for the conservation check); None if no backend exposes one."""
        total, seen, found = 0.0, set(), False
        for reps in self.scheduler._replicas.values():
            for e in reps:
                if id(e) not in seen and hasattr(e, "total_credits"):
                    total += e.total_credits
                    seen.add(id(e))
                    found = True
        return total if found else None

    def report(self) -> ServingReport:
        """Distil the run so far.  Exact cross-field invariants (e.g.
        ``total_credits == backend_credits``, submitted == dispatched +
        dedup + cancelled + failed) hold for a report taken after
        ``drain()``; a report taken mid-flight is a best-effort sample
        (the pipeline counters themselves are snapshotted atomically)."""
        with self._lock:
            meters = list(self.tenants.values())
            n_tickets = self._submitted
        tenant_reports: Dict[str, TenantReport] = {}
        total_credits = 0.0
        all_waits = _HistChild()
        all_lats = _HistChild()
        for m in meters:
            with m.lock:
                waits, lats = m.queue_hist, m.latency_hist
                tenant_reports[m.name] = TenantReport(
                    tenant=m.name, queries=m.submitted,
                    completed=m.completed, failed=m.failed,
                    rejected=m.rejected, credits_spent=m.credits,
                    credit_budget=m.policy.credit_budget,
                    dispatched_calls=m.dispatched_calls,
                    queue_wait_p50_s=waits.quantile(0.50),
                    queue_wait_p95_s=waits.quantile(0.95),
                    latency_p50_s=lats.quantile(0.50),
                    latency_p95_s=lats.quantile(0.95))
                total_credits += m.credits
                all_waits.merge(waits)
                all_lats.merge(lats)
        ps = self.pipeline.stats_snapshot()   # atomic under pipeline lock
        ss = self.scheduler.stats_snapshot()  # atomic under scheduler lock
        return ServingReport(
            tenants=tenant_reports, queries=n_tickets,
            total_credits=total_credits,
            backend_credits=self.backend_credits(),
            submitted_requests=ps["submitted"],
            dispatched_requests=ps["dispatched"],
            dedup_hits=ps["dedup_hits"], cache_hits=ps["cache_hits"],
            cross_query_hits=ps["cross_query_hits"],
            cache_expired=ps["cache_expired"],
            cancelled_requests=ps["cancelled"],
            retries=ps["retries"],
            scheduler_retries=ss["retries"],
            scheduler_timeouts=ss["timeouts"],
            failed_requests=ps["failures"],
            queue_wait_p50_s=all_waits.quantile(0.50),
            queue_wait_p95_s=all_waits.quantile(0.95),
            latency_p50_s=all_lats.quantile(0.50),
            latency_p95_s=all_lats.quantile(0.95),
            storage=self.storage_stats())
