"""Cortex Platform API Service (paper §2): the front-end the SQL engine
talks to.  Applies business logic (request ids, budget guards, credit
metering), forwards to the RequestPipeline / Scheduler, and exposes typed
convenience calls used by the AISQL operators.

Two execution modes share one code path:

  * **eager** (``pipeline=None``): ``submit_async`` dispatches each batch
    immediately and returns already-resolved futures — the seed engine's
    per-call-site behaviour, bit-identical telemetry included;
  * **pipelined** (``pipeline=`` a `RequestPipeline` or `PipelineConfig`):
    ``submit_async`` enqueues into coalescing per-model queues and returns
    pending futures; work is dispatched on flush (size threshold or the
    first ``result()`` barrier), with identical requests deduplicated.

The sync convenience methods (``complete`` / ``filter_scores`` /
``classify``) are thin wrappers: submit async, then await — so legacy
callers (cascades, aggregators, notebooks) transparently ride the
pipeline's batching and memoization.

Credit metering happens **on dispatch**, not on submission: a request
served from the dedup cache costs zero AI credits, which is exactly the
saving the paper's §4 cost analysis wants surfaced.
"""
from __future__ import annotations

import itertools
import threading
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED, SCORE,
                                     Request, Result)
from repro_torch.inference.pipeline import (PipelineConfig, RequestPipeline,
                                      ResultFuture)
from repro_torch.inference.scheduler import Scheduler


class CortexClient:
    """What a virtual warehouse holds: a handle to the Cortex API service.

    ``owner`` marks this client as one session of a **shared** pipeline
    (the serving runtime): its requests are tagged with the owner so the
    pipeline bills this client's meter — registered via
    ``register_meter`` — only for the dispatches this session caused,
    and ``flush()`` becomes an owner-scoped barrier that leaves other
    sessions' queued work coalescing.  Without an owner the client
    behaves exactly as before and assumes the pipeline is **private**:
    failed-query cleanup (``cancel_queued``) withdraws every owner-less
    queued item, and metering claims the pipeline-wide dispatch hook —
    so sharing one pipeline between several *owner-less* clients is
    unsupported; give each client an owner instead.
    """

    def __init__(self, scheduler: Scheduler, *, default_model: str = "oracle-70b",
                 proxy_model: str = "proxy-8b",
                 embed_model: str = "arctic-embed-m",
                 pipeline: Union[None, bool, PipelineConfig,
                                 RequestPipeline] = None,
                 owner: Optional[str] = None,
                 on_dispatch_extra: Optional[
                     Callable[[Sequence[Result]], None]] = None):
        self.scheduler = scheduler
        self.default_model = default_model
        self.proxy_model = proxy_model
        self.embed_model = embed_model
        self.owner = owner
        self._ids = itertools.count(1)
        # meters (paper §4 cost-analysis instrumentation); the lock keeps
        # them consistent when a *different* session's barrier dispatches
        # (and therefore bills) this session's coalesced requests
        self._meter_lock = threading.Lock()
        self.ai_calls = 0
        self.ai_credits = 0.0
        self.ai_seconds = 0.0
        self.calls_by_model: Dict[str, int] = {}
        if pipeline is True:
            pipeline = PipelineConfig()
        if isinstance(pipeline, PipelineConfig):
            pipeline = RequestPipeline(scheduler, pipeline,
                                       on_dispatch=self._meter)
        elif isinstance(pipeline, RequestPipeline):
            if owner is not None:
                # shared pipeline: bill through the per-owner registry,
                # never clobber the pipeline-wide hook.  One registration
                # chains the client meter with the caller's extra hook
                # (the serving engine's tenant billing).
                extra = on_dispatch_extra

                def _owner_meter(results, _extra=extra):
                    self._meter(results)
                    if _extra is not None:
                        _extra(results)

                pipeline.register_meter(owner, _owner_meter)
            else:
                pipeline.on_dispatch = self._meter
        self.pipeline: Optional[RequestPipeline] = pipeline or None

    # ------------------------------------------------------------------
    def _meter(self, results: Sequence[Result]) -> None:
        with self._meter_lock:
            self.ai_calls += len(results)
            for res in results:
                self.ai_credits += res.credits
                self.ai_seconds += res.latency_s
                self.calls_by_model[res.model] = \
                    self.calls_by_model.get(res.model, 0) + 1

    def submit_async(self, requests: List[Request]) -> List[ResultFuture]:
        """Queue requests; returns one future per request (input order)."""
        for r in requests:
            r.request_id = next(self._ids)
        if self.pipeline is not None:
            return self.pipeline.submit_many(requests, owner=self.owner)
        results = self.scheduler.submit(requests)
        self._meter(results)
        return [ResultFuture.resolved(res) for res in results]

    def flush(self) -> None:
        """Barrier: force-dispatch everything this client queued (with an
        owner, only its own items; otherwise the whole pipeline)."""
        if self.pipeline is not None:
            if self.owner is not None:
                self.pipeline.flush(owner=self.owner)
            else:
                self.pipeline.flush()

    def cancel_queued(self) -> int:
        """Withdraw every still-queued request this client exclusively
        owns (failed-query cleanup; never-billed by construction)."""
        if self.pipeline is None:
            return 0
        return self.pipeline.cancel_owner(self.owner)

    def _submit(self, requests: List[Request]) -> List[Result]:
        return [f.result() for f in self.submit_async(requests)]

    # ------------------------------------------------------------------
    def complete(self, prompts: Sequence[str], *, model: Optional[str] = None,
                 max_tokens: int = 48,
                 metadata: Optional[Sequence[Dict[str, Any]]] = None
                 ) -> List[str]:
        model = model or self.default_model
        md = metadata or [{} for _ in prompts]
        res = self._submit([
            Request(p, model, COMPLETE, max_tokens=max_tokens, metadata=m)
            for p, m in zip(prompts, md)])
        return [r.text for r in res]

    def filter_scores(self, prompts: Sequence[str], *,
                      model: Optional[str] = None,
                      metadata: Optional[Sequence[Dict[str, Any]]] = None
                      ) -> np.ndarray:
        """Confidence s_i = P(predicate true) per row (§5.2)."""
        model = model or self.default_model
        md = metadata or [{} for _ in prompts]
        res = self._submit([
            Request(p, model, SCORE, metadata=m) for p, m in zip(prompts, md)])
        return np.asarray([r.score for r in res], np.float64)

    def embed(self, texts: Sequence[str], *, model: Optional[str] = None,
              metadata: Optional[Sequence[Dict[str, Any]]] = None
              ) -> np.ndarray:
        """Unit-vector embeddings, one row per text (EMBED kind; priced
        per input token on the embedding tier).  Identical texts dedup
        through the pipeline like every other kind."""
        model = model or self.embed_model
        md = metadata or [{} for _ in texts]
        res = self._submit([
            Request(t, model, EMBED, metadata=m) for t, m in zip(texts, md)])
        return np.asarray([r.embedding for r in res], np.float32)

    def classify(self, prompts: Sequence[str], labels: Tuple[str, ...], *,
                 model: Optional[str] = None, multi_label: bool = False,
                 metadata: Optional[Sequence[Dict[str, Any]]] = None
                 ) -> List[Tuple[str, ...]]:
        model = model or self.default_model
        md = metadata or [{} for _ in prompts]
        res = self._submit([
            Request(p, model, CLASSIFY, labels=tuple(labels),
                    multi_label=multi_label, metadata=m)
            for p, m in zip(prompts, md)])
        return [tuple(r.labels or ((r.label,) if r.label else ())) for r in res]

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._meter_lock:
            out = {"ai_calls": self.ai_calls, "ai_credits": self.ai_credits,
                   "ai_seconds": self.ai_seconds,
                   "calls_by_model": dict(self.calls_by_model)}
        # a shared pipeline's stats mix every session's traffic — a
        # per-query delta of them would be misleading, so only a private
        # pipeline surfaces them here (QueryReport.pipeline); read via
        # the locked snapshot so a concurrent dispatch never tears it
        if self.pipeline is not None and self.owner is None:
            out["pipeline"] = self.pipeline.stats_snapshot()
        return out

    def meter_delta(self, before: Dict[str, Any]) -> Dict[str, Any]:
        out = {
            "ai_calls": self.ai_calls - before["ai_calls"],
            "ai_credits": self.ai_credits - before["ai_credits"],
            "ai_seconds": self.ai_seconds - before["ai_seconds"],
        }
        if self.pipeline is not None and "pipeline" in before:
            out["pipeline"] = self.pipeline.stats_delta(before["pipeline"])
        return out


def _make_pipeline(pipelined: bool,
                   pipeline: Union[None, PipelineConfig, RequestPipeline]
                   ) -> Union[None, PipelineConfig, RequestPipeline]:
    if pipeline is not None:
        return pipeline
    return PipelineConfig() if pipelined else None


def make_simulated_client(*, seed: int = 0, default_model: str = "oracle-70b",
                          proxy_model: str = "proxy-8b",
                          pipelined: bool = False,
                          pipeline: Union[None, PipelineConfig,
                                          RequestPipeline] = None
                          ) -> CortexClient:
    """Convenience: a CortexClient over the calibrated simulator."""
    from repro_torch.inference.simulator import SimulatedBackend
    sched = Scheduler()
    sched.register(SimulatedBackend(seed=seed))
    return CortexClient(sched, default_model=default_model,
                        proxy_model=proxy_model,
                        pipeline=_make_pipeline(pipelined, pipeline))


def make_engine_client(archs: Sequence[str] = ("proxy-8b", "oracle-70b"), *,
                       seed: int = 0, replicas: int = 1,
                       default_model: Optional[str] = None,
                       pipelined: bool = False,
                       pipeline: Union[None, PipelineConfig,
                                       RequestPipeline] = None,
                       backend: str = "auto",
                       device: str = "cuda") -> CortexClient:
    """Convenience: a CortexClient over real PyTorch engines (smoke-size)
    on ``device``; like the engines, it raises without CUDA unless the
    caller passes ``device="cpu"``.  ``backend`` pins the engines' decode
    backend ("auto" picks continuous batching wherever the architecture
    supports the paged KV cache).  The default hosts the cascade pair,
    proxy-8b and oracle-70b, as the JAX package's does."""
    from repro_torch.inference.engine import TorchInferenceEngine
    sched = Scheduler()
    for arch in archs:
        for rep in range(replicas):
            sched.register(TorchInferenceEngine(
                arch, engine_id=f"{arch}#{rep}", seed=seed + rep,
                backend=backend, device=device))
    return CortexClient(sched, default_model=default_model or archs[-1],
                        proxy_model=archs[0],
                        pipeline=_make_pipeline(pipelined, pipeline))
