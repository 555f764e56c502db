"""Vectorised plan executor with runtime adaptation (paper §5.1–5.3).

Executes optimized plans against the columnar substrate + the Cortex client.

Runtime behaviour mirrored from the paper:

  * **adaptive predicate reordering** — Filters evaluate in row chunks;
    per-predicate cost and selectivity statistics are collected and the
    evaluation order is re-ranked between chunks (cheap/selective first);
  * **model cascades** — AI_FILTER predicates route through a streaming
    SUPG-IT cascade (proxy scores + learned thresholds + oracle escalation)
    when enabled;
  * **semantic-join rewrite execution** — SemanticJoinClassify runs one
    multi-label AI_CLASSIFY per left row (chunked over the label set)
    instead of |L|·|R| AI_FILTER calls.

  * **partitioned streaming execution** — with ``ExecConfig.partitioned``
    the driver loop switches from tree-recursive materialization to a
    partition-pull model: the source splits into morsels of
    ``partition_rows``, each morsel flows through the whole filter chain
    (eager, pipelined and cascade paths alike) as an independently
    submitted batch that the scheduler spreads across engine replicas,
    and a `StreamingLimit` consumer drains partitions until a LIMIT's
    ``n`` surviving rows are collected — then cancels unsubmitted
    partitions, so LIMIT-bounded queries stop buying inference they do
    not need.  ``partition_lookahead`` optionally prefetches the next
    partitions' first AI predicate into the pipeline for cross-partition
    coalescing (bounded speculation; still-queued prefetches are
    cancelled on early termination and never billed);

  * **semantic ORDER BY / top-k** — `Sort` keys may be AI_SCORE
    expressions (scored via the SCORE request kind, recorded in the
    `StatsStore` like every predicate); a fused `TopK` prefilters with
    cheap proxy scores and escalates only the top candidates to the
    ordering model;

  * **pilot sampling + mid-query re-optimization** — before a Filter with
    cold AI predicates runs in full, each such predicate is evaluated on a
    small evenly-spaced row sample; observed selectivity / cost-per-row
    land in the shared `StatsStore` and the remaining evaluation order is
    re-ranked with real numbers (the paper's "cost and selectivity are
    unknown during query compilation" closed as a feedback loop).  The
    pilot's per-row results are carried into the full pass — pilot rows
    are never re-submitted or re-billed — and predicates the store is
    already confident about skip the pilot entirely (warm start).
    Learned cascade delegation rates can also *bypass* a cascade whose
    proxy has proven useless (delegation ≈ 1).

Semantic-operator runtime: every AI call site assembles its requests
through one typed builder, `SemanticOp`, and awaits `SemanticHandle`
futures instead of blocking per-site client calls.  With a pipelined
client (``client.pipeline`` set) independent micro-batches — label chunks
of a semantic join, hybrid-join passes, multiple projection items — are
submitted *before* any is awaited, so the RequestPipeline coalesces them
into right-sized engine batches; filters switch from chunk-major to
predicate-major evaluation (all surviving rows of one predicate in one
coalesced pass) trading mid-stream reordering for batching.  With an
eager client the exact seed behaviour (and telemetry) is preserved.

Ground-truth plumbing: hidden columns (leaf name starting with ``_``) are
never returned by ``SELECT *`` but travel with rows and are forwarded as
request metadata (``_truth`` → truth, ``_difficulty`` → difficulty,
``_labels`` → truth_labels, ``_recall_penalty`` → recall_penalty) so the
calibrated simulator can ground quality metrics.  The real engines
ignore metadata entirely.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core import plan as P
from repro_torch.core.aggregate import AggConfig, HierarchicalAggregator
from repro_torch.core.cascade import CascadeConfig, SupgItCascade
from repro_torch.core.cost import Catalog, CostModel
from repro_torch.core.stats import (StatsStore, index_join_fingerprint,
                                    predicate_fingerprint,
                                    predicate_prompt_text)
from repro_torch.inference.api import CortexClient
from repro_torch.inference.backend import CLASSIFY, COMPLETE, SCORE, Request
from repro_torch.inference.pipeline import ResultFuture
from repro_torch.obs.trace import active_tracer
from repro_torch.tables.chunked import ChunkedTable
from repro_torch.tables.table import Table, _hash_join_indices


def _is_hidden(col: str) -> bool:
    return col.rsplit(".", 1)[-1].startswith("_")


def _strip_format_slots(template: str) -> str:
    """The prompt template as free text: ``{0}``-style slots removed."""
    import re
    return re.sub(r"\{\d+\}", " ", template).strip()


def _side_desc(e: E.Expr) -> str:
    """Compact description of an AI_SIMILARITY / AI_EMBED argument."""
    if isinstance(e, E.Column):
        return e.name
    if isinstance(e, E.Literal):
        return repr(str(e.value)[:24])
    return type(e).__name__


def _unit_rows(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


_MD_MAP = {"_truth": "truth", "_difficulty": "difficulty",
           "_labels": "truth_labels", "_recall_penalty": "recall_penalty",
           "_fp_bias": "fp_bias", "_fn_bias": "fn_bias",
           "_drop_prob": "drop_prob", "_add_frac": "add_frac"}


def row_metadata(table: Table, rows: np.ndarray,
                 label_args: Sequence[np.ndarray] = (),
                 arg_cols: Sequence[str] = ()) -> List[Dict[str, Any]]:
    """Simulator grounding: hidden columns -> per-row request metadata.

    ``label_args``: rendered per-row values of prompt args; when the row
    carries a ``_labels`` truth set, pairwise truth is derived as "any arg
    value is one of the true labels" (used by cross-join AI_FILTER so that
    baseline and rewrite share identical ground truth).

    ``arg_cols``: unqualified column names the predicate references.
    A hidden column ``_truth__<col>`` carries *column-scoped* ground
    truth: it becomes the request's ``truth`` only for predicates that
    reference ``<col>``, so two AI predicates over different columns of
    one table can have independent (skewed) selectivities.  Scoped truth
    wins over a table-wide ``_truth``.
    """
    hidden: Dict[str, np.ndarray] = {}
    arg_set = {c.rsplit(".", 1)[-1] for c in arg_cols}
    scoped_truth: List[np.ndarray] = []
    for c in table.column_names:
        leaf = c.rsplit(".", 1)[-1]
        if leaf.startswith("_truth__"):
            if leaf[len("_truth__"):] in arg_set:
                scoped_truth.append(table.gather(c, rows))
        elif leaf in _MD_MAP:
            # last matching column wins (pre-existing contract for joined
            # tables that carry several hidden columns of the same leaf)
            hidden[_MD_MAP[leaf]] = table.gather(c, rows)
    if scoped_truth:
        # scoped truth wins over table-wide _truth; a predicate that
        # references several scoped-truth columns is true iff all are
        # (deterministic regardless of column order)
        agg = scoped_truth[0].astype(bool)
        for t in scoped_truth[1:]:
            agg = agg & t.astype(bool)
        hidden["truth"] = agg
    n = len(rows)
    out: List[Dict[str, Any]] = []
    for i in range(n):
        md = {k: v[i] for k, v in hidden.items()}
        if "truth_labels" in md and "truth" not in md and label_args:
            lbls = md["truth_labels"]
            lbls = set(lbls) if isinstance(lbls, (tuple, list, set)) else {lbls}
            md["truth"] = any(str(a[i]) in lbls for a in label_args)
        out.append(md)
    return out


# ---------------------------------------------------------------------------
# SemanticOp: the one request-builder behind every AI call site
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SemanticOp:
    """Typed request assembly for one semantic-operator micro-batch.

    Replaces the five per-site copies of prompt/metadata/model plumbing
    (plain AI_FILTER, cascade AI_FILTER, SemanticJoinClassify, projection
    AI_CLASSIFY / AI_COMPLETE, AI_AGG text phases).  ``submit`` hands the
    typed batch to the client and returns an awaitable `SemanticHandle`.
    """
    kind: str                              # SCORE | CLASSIFY | COMPLETE
    prompts: List[str]
    metadata: List[Dict[str, Any]]
    model: str
    labels: Tuple[str, ...] = ()
    multi_label: bool = False
    max_tokens: int = 32

    # -- factories ------------------------------------------------------
    @classmethod
    def scores(cls, prompts: Sequence[str],
               metadata: Sequence[Dict[str, Any]], model: str) -> "SemanticOp":
        return cls(SCORE, list(prompts), list(metadata), model)

    @classmethod
    def from_filter(cls, pred: E.AIFilter, table: Table, rows: np.ndarray,
                    model: str) -> "SemanticOp":
        prompts = pred.prompt.render(table, rows)
        args = [E.eval_expr(a, table, rows) for a in pred.prompt.args]
        md = row_metadata(table, rows, args, arg_cols=sorted(pred.refs()))
        return cls(SCORE, list(prompts), md, model)

    @classmethod
    def classify(cls, prompts: Sequence[str],
                 metadata: Sequence[Dict[str, Any]],
                 labels: Sequence[str], model: str,
                 multi_label: bool) -> "SemanticOp":
        labels = tuple(labels)
        md = [{**m, "candidate_labels": labels} for m in metadata]
        return cls(CLASSIFY, list(prompts), md, model, labels=labels,
                   multi_label=multi_label)

    @classmethod
    def complete(cls, prompts: Sequence[str],
                 metadata: Sequence[Dict[str, Any]], model: str,
                 max_tokens: int) -> "SemanticOp":
        return cls(COMPLETE, list(prompts), list(metadata), model,
                   max_tokens=max_tokens)

    # -- submission -----------------------------------------------------
    def requests(self) -> List[Request]:
        return [Request(p, self.model, self.kind, max_tokens=self.max_tokens,
                        labels=self.labels or None,
                        multi_label=self.multi_label, metadata=m)
                for p, m in zip(self.prompts, self.metadata)]

    def submit(self, client: CortexClient) -> "SemanticHandle":
        return SemanticHandle(self.kind, client.submit_async(self.requests()))


class SemanticHandle:
    """Typed view over a batch of result futures (awaits on first access)."""

    def __init__(self, kind: str, futures: List[ResultFuture]):
        self.kind = kind
        self.futures = futures

    def results(self):
        return [f.result() for f in self.futures]

    def scores(self) -> np.ndarray:
        return np.asarray([r.score for r in self.results()], np.float64)

    def chosen_labels(self) -> List[Tuple[str, ...]]:
        return [tuple(r.labels or ((r.label,) if r.label else ()))
                for r in self.results()]

    def texts(self) -> List[str]:
        return [r.text for r in self.results()]


@dataclasses.dataclass
class ExecConfig:
    use_cascade: bool = False
    cascade: CascadeConfig = dataclasses.field(default_factory=CascadeConfig)
    adaptive_reorder: bool = True
    chunk_rows: int = 256            # runtime-adaptation granularity
    # -- pilot sampling (adaptive re-optimization) ----------------------
    # rows per cold AI predicate scored up-front to learn selectivity /
    # cost before committing to an evaluation order; 0 disables the pilot
    pilot_rows: int = 48
    # tables smaller than this skip the pilot (it cannot pay for itself)
    min_rows_for_pilot: int = 192
    # -- learned cascade bypass -----------------------------------------
    # skip the SUPG-IT cascade (straight to the oracle) once the store has
    # seen >= cascade_bypass_min_rows cascaded rows for a predicate with a
    # delegation rate at or above this threshold: a proxy that escalates
    # nearly everything only adds its own calls on top of the oracle's
    cascade_bypass_delegation: float = 0.9
    cascade_bypass_min_rows: int = 64
    # treat a cold predicate with a kNN-transferred prior (cost model v2)
    # as warm for pilot purposes: skip its pilot sample and rank it with
    # the transferred selectivity / cost instead of paying sample calls
    pilot_trust_transfer: bool = True
    agg: AggConfig = dataclasses.field(default_factory=AggConfig)
    proxy_model: Optional[str] = None    # default: client.proxy_model
    classify_multi_label: bool = True    # semantic-join rewrite labels
    # Hybrid join strategy (paper §8 future work): run the multi-label
    # classification k times and union the selections.  Conservative
    # selection drops true labels independently per pass, so recall
    # improves ~1-(1-R1)^k at k× the (still O(L)) call cost.
    classify_passes: int = 1
    # None: predicate-major batched filter evaluation iff the client has a
    # RequestPipeline; True/False force it on/off.
    pipeline_filters: Optional[bool] = None
    # -- partitioned streaming execution (the third execution mode) -----
    # opt-in: split every filter scan into morsels of partition_rows and
    # pull them through the predicate chain one partition at a time; a
    # LIMIT above the chain terminates the pull as soon as n surviving
    # rows exist (unsubmitted partitions are cancelled, not billed)
    partitioned: bool = False
    partition_rows: int = 256
    # partitions whose *first* AI predicate is submitted into the
    # pipeline ahead of need (1 = just-in-time, no speculation).  Higher
    # values coalesce across partitions at the cost of up to
    # lookahead - 1 speculative partitions on early termination;
    # still-queued prefetches are cancelled and never billed.
    partition_lookahead: int = 1
    # -- semantic ORDER BY / top-k --------------------------------------
    # fused TopK: score everything with the proxy model, escalate only
    # ceil(topk_candidate_factor * k) candidates to the ordering model
    topk_prefilter: bool = True
    # -- semantic index (requires an attached SemanticIndexManager) -----
    # ORDER BY AI_SCORE top-k: replace proxy-score-all with index-
    # candidates-then-oracle (the index ranks rows by similarity to the
    # score prompt; only the escalated candidates reach the oracle).
    # Opt-in: unlike the AI_SIMILARITY pruning (exact by construction),
    # result rows are only guaranteed up to the index's recall bound —
    # see docs/semantic-index.md.
    topk_index_score: bool = False


class StreamingLimit:
    """LIMIT-aware consumer of the partition-pull loop.

    Collects surviving (global) row indices partition by partition;
    ``satisfied`` flips once ``n`` rows exist, signalling the driver to
    stop submitting partitions.  With ``n=None`` it degrades to a plain
    accumulator (the no-LIMIT partitioned filter path).
    """

    def __init__(self, n: Optional[int] = None):
        self.n = n
        self._parts: List[np.ndarray] = []
        self._count = 0

    def add(self, rows: np.ndarray) -> np.ndarray:
        """Accept ``rows`` up to the remaining limit; returns the
        accepted slice (what a streaming sink may forward downstream —
        rows past the limit are dropped here, so ``take()`` and the sum
        of accepted slices always agree)."""
        rows = np.asarray(rows, dtype=np.int64)
        if self.n is not None:
            rows = rows[:max(self.n - self._count, 0)]
        if len(rows):
            self._parts.append(rows)
            self._count += len(rows)
        return rows

    @property
    def count(self) -> int:
        return self._count

    @property
    def satisfied(self) -> bool:
        return self.n is not None and self._count >= self.n

    def take(self) -> np.ndarray:
        out = (np.concatenate(self._parts) if self._parts
               else np.empty(0, dtype=np.int64))
        return out[:self.n] if self.n is not None else out


@dataclasses.dataclass
class PredicateStats:
    evaluated: int = 0
    passed: int = 0
    seconds: float = 0.0
    credits: float = 0.0

    @property
    def selectivity(self) -> float:
        return self.passed / self.evaluated if self.evaluated else 0.5

    @property
    def cost_per_row(self) -> float:
        # runtime rank uses observed credits (primary) + wall time tiebreak
        if not self.evaluated:
            return 0.0
        return (self.credits + 1e-6 * self.seconds) / self.evaluated

    @property
    def rank(self) -> float:
        return self.cost_per_row / max(1.0 - self.selectivity, 1e-9)


class Executor:
    def __init__(self, catalog: Catalog, client: CortexClient, *,
                 cfg: Optional[ExecConfig] = None,
                 cost: Optional[CostModel] = None,
                 stats: Optional[StatsStore] = None,
                 semindex=None):
        self.catalog = catalog
        self.client = client
        self.cfg = cfg or ExecConfig()
        self.cost = cost or CostModel(catalog)
        # optional SemanticIndexManager: embedding store + ANN indexes
        # (shared across engines/sessions when serving)
        self.semindex = semindex
        # the learned-statistics feedback loop: every evaluation writes
        # observations here; the (shared) cost model reads them back
        self.stats = stats if stats is not None else StatsStore()
        if self.cost.stats is None:
            self.cost.stats = self.stats
        # telemetry of the last execute()
        self.pred_stats: Dict[str, PredicateStats] = {}
        self.cascades: Dict[str, SupgItCascade] = {}
        self.agg_telemetry = None
        self.reorder_events: List[str] = []
        self.reoptimizations: List[str] = []
        self.pilot_telemetry: Optional[Dict[str, Any]] = None
        self.partition_telemetry: Optional[Dict[str, Any]] = None
        self.index_telemetry: Optional[Dict[str, Any]] = None
        self._fp_by_key: Dict[str, str] = {}
        self._prefetch_spend: Dict[str, float] = {}
        # per-query embedding memo (model, text) -> vector: a literal
        # query side embeds once per query on *every* client and
        # execution mode (chunked/partitioned evaluation would otherwise
        # re-embed it per batch on an eager client)
        self._embed_memo: Dict[Tuple[str, str], np.ndarray] = {}
        # incremental-result hook: when set, `_partition_pull` forwards
        # each partition's accepted row indices here as they survive
        self._stream_sink: Optional[Callable[[np.ndarray], None]] = None
        # an `Observability` for the metrics registry (set by the owning
        # engine); span tracing rides the thread-local active tracer
        self.obs = None

    @property
    def pipelined(self) -> bool:
        if self.cfg.pipeline_filters is not None:
            return self.cfg.pipeline_filters
        return self.client.pipeline is not None

    @property
    def mode(self) -> str:
        """The execution mode this config+client combination selects."""
        if self.cfg.partitioned:
            return "partitioned"
        return "pipelined" if self.pipelined else "eager"

    # ------------------------------------------------------------------
    def _reset_query_state(self) -> None:
        self.pred_stats = {}
        self.cascades = {}
        self.reorder_events = []
        self.reoptimizations = []
        self.pilot_telemetry = None
        self.partition_telemetry = None
        self.index_telemetry = None
        self._fp_by_key: Dict[str, str] = {}
        self._embed_memo = {}

    def execute(self, node: P.PlanNode) -> Table:
        self._reset_query_state()
        out = self._exec(node)
        self._fold_cascade_stats()
        self.stats.note_query(set(self._fp_by_key.values()))
        return out

    def execute_stream(self, node: P.PlanNode,
                       emit: Callable[[Table], None]) -> Table:
        """Execute ``node``, invoking ``emit(batch)`` with incremental
        result `Table` batches as partitions complete, and return the
        full result (row-identical to ``execute``).  Streaming engages
        on the same shapes the partitioned LIMIT path handles —
        ``[Limit] [Project] Filter* -> source`` in partitioned mode;
        any other plan falls back to one terminal ``emit`` of the
        materialized result."""
        self._reset_query_state()
        out = self._exec_stream(node, emit)
        self._fold_cascade_stats()
        self.stats.note_query(set(self._fp_by_key.values()))
        return out

    def _exec_stream(self, node: P.PlanNode,
                     emit: Callable[[Table], None]) -> Table:
        limit: Optional[int] = None
        child = node
        if isinstance(node, P.Limit):
            limit, child = node.n, node.child
        spine = (self._streamable_spine(child)
                 if self.cfg.partitioned else None)
        if spine is None:
            out = self._exec(node)
            if out.num_rows:
                emit(out)
            return out
        project, preds, inner = spine
        source = self._exec(inner)
        if preds:
            preds, known = self._maybe_pilot(source, list(preds))
        else:
            known = {}
        batches: List[Table] = []

        def sink(accepted: np.ndarray) -> None:
            batch = source.take(accepted)
            if project is not None:
                batch = self._exec_project(
                    P.Project(_Materialized(batch), project.items))
            batches.append(batch)
            emit(batch)

        self._stream_sink = sink
        try:
            self._partition_pull(source, preds, known, limit=limit)
        finally:
            self._stream_sink = None
        if batches:
            out = batches[0]
            for b in batches[1:]:
                out = out.concat_rows(b)
        else:
            # zero surviving rows: an empty projection of the source
            # keeps the output schema identical to the buffered path
            out = source.take(np.empty(0, dtype=np.int64))
            if project is not None:
                out = self._exec_project(
                    P.Project(_Materialized(out), project.items))
        return out.head(limit) if limit is not None else out

    def _fold_cascade_stats(self) -> None:
        """Record per-predicate cascade routing volume into the store so
        future queries can re-decide the proxy-vs-direct choice."""
        for key, cascade in self.cascades.items():
            fp = self._fp_by_key.get(key)
            if fp is not None and cascade.stats.rows:
                self.stats.observe_cascade(
                    fp, rows=cascade.stats.rows,
                    oracle_calls=cascade.stats.oracle_calls)

    def _exec(self, node: P.PlanNode) -> Table:
        if isinstance(node, _Materialized):
            return node.table
        if isinstance(node, P.Scan):
            return self.catalog.table(node.table).prefixed(node.alias)
        if isinstance(node, P.Filter):
            return self._exec_filter(node)
        if isinstance(node, P.Join):
            return self._exec_join(node)
        if isinstance(node, P.SemanticJoinClassify):
            return self._exec_semantic_join(node)
        if isinstance(node, P.SemanticJoinIndex):
            return self._exec_semantic_join_index(node)
        if isinstance(node, P.Aggregate):
            return self._exec_aggregate(node)
        if isinstance(node, P.Project):
            return self._exec_project(node)
        if isinstance(node, P.Sort):
            return self._exec_sort(node)
        if isinstance(node, P.TopK):
            return self._exec_topk(node)
        if isinstance(node, P.Limit):
            return self._exec_limit(node)
        raise TypeError(node)

    # ------------------------------------------------------------------
    # Filter: chunked evaluation + adaptive reordering + cascades
    # ------------------------------------------------------------------

    def _pred_key(self, pred: E.Expr) -> str:
        if isinstance(pred, E.AIFilter):
            return f"AI_FILTER({pred.prompt.template[:40]!r})"
        if isinstance(pred, E.AIScore):
            # the model is part of the key: proxy-prefilter and oracle
            # scores of one prompt are separate telemetry rows
            model = pred.model or self.client.default_model
            return f"AI_SCORE({pred.prompt.template[:40]!r}, {model})"
        if isinstance(pred, E.AIClassify):
            return f"AI_CLASSIFY({pred.text.template[:40]!r})"
        if isinstance(pred, E.AISimilarity):
            model = pred.model or self.client.embed_model
            return (f"AI_SIMILARITY({_side_desc(pred.left)}, "
                    f"{_side_desc(pred.right)}, {model})")
        if isinstance(pred, E.AIEmbed):
            model = pred.model or self.client.embed_model
            return f"AI_EMBED({_side_desc(pred.arg)}, {model})"
        return f"{type(pred).__name__}:{abs(hash(pred)) % 10 ** 8}"

    def _stats_for(self, pred: E.Expr) -> PredicateStats:
        key = self._pred_key(pred)
        if key not in self._fp_by_key:
            fp = predicate_fingerprint(pred)
            self._fp_by_key[key] = fp
            text = predicate_prompt_text(pred)
            if text:
                # prompt registry feeds the kNN prior transfer: future
                # cold predicates find this one as an embedding neighbour
                self.stats.register_prompt(fp, text)
        return self.pred_stats.setdefault(key, PredicateStats())

    def _filter_model(self, pred: E.AIFilter) -> str:
        return pred.model or (
            self.cost.multimodal_model if pred.multimodal
            else self.client.default_model)

    def _exec_filter(self, node: P.Filter) -> Table:
        table = self._exec(node.child)
        mask = self.eval_predicates(table, list(node.predicates))
        return table.filter_mask(mask)

    def eval_predicates(self, table: Table, preds: List[E.Expr]
                        ) -> np.ndarray:
        n = table.num_rows
        if not preds:
            return np.ones(n, dtype=bool)
        preds, known = self._maybe_pilot(table, list(preds))
        if self.cfg.partitioned:
            sel = self._partition_pull(table, preds, known, limit=None)
            mask = np.zeros(n, dtype=bool)
            mask[sel] = True
            return mask
        if self.pipelined:
            return self._eval_predicates_batched(table, preds, known)
        return self._eval_predicates_chunked(table, preds, known)

    # ------------------------------------------------------------------
    # pilot sampling: learn cost/selectivity, then re-optimize mid-query
    # ------------------------------------------------------------------

    def _maybe_pilot(self, table: Table, preds: List[E.Expr]
                     ) -> Tuple[List[E.Expr], Dict[str, Dict[int, bool]]]:
        """Score cold AI predicates on a small row sample, fold the
        observations into the `StatsStore`, and re-rank the conjunct
        order with real numbers before the full evaluation commits.

        Returns the (possibly re-ordered) predicate list plus the
        pilot's per-row results (pred key -> {row: passed}), which the
        full pass consumes via `_timed_pred` instead of re-evaluating —
        so each pilot row is paid for exactly once, on eager and
        pipelined clients alike.  Skipped when the table is small, the
        pilot is disabled, there is nothing to re-order, or every AI
        predicate is already confidently known (warm start: the store
        answers from past queries).
        """
        cfg = self.cfg
        n = table.num_rows
        ai_preds = [p for p in preds if isinstance(p, E.AIFilter)]
        if (not cfg.adaptive_reorder or cfg.pilot_rows <= 0
                or n < cfg.min_rows_for_pilot or len(preds) < 2
                or not ai_preds):
            return preds, {}
        min_rows = self.cost.defaults.stats_min_rows
        cold = [p for p in ai_preds
                if not self.stats.confident(
                    predicate_fingerprint(p), min_rows=min_rows)]
        transferred: List[E.Expr] = []
        if cfg.pilot_trust_transfer and cold:
            # cost model v2: a cold predicate whose kNN-transferred prior
            # is live already has a usable selectivity/cost estimate —
            # rank with that instead of buying pilot sample calls
            transferred = [p for p in cold
                           if self.cost.estimate_source(p) == "transferred"]
            if transferred:
                skip = {id(p) for p in transferred}
                cold = [p for p in cold if id(p) not in skip]
        t0 = time.perf_counter()
        sampled: Dict[str, Dict[str, float]] = {}
        known: Dict[str, Dict[int, bool]] = {}
        n_sampled = 0
        if cold:
            with active_tracer().span("pilot", kind="pilot",
                                      predicates=len(cold)) as psp:
                k = min(cfg.pilot_rows, n)
                idx = np.unique(np.linspace(0, n - 1, k).astype(np.int64))
                n_sampled = int(len(idx))
                # submit every pilot batch before awaiting any, so the
                # pipeline coalesces across predicates
                c0 = self.client.ai_credits
                handles = [(p, SemanticOp.from_filter(
                    p, table, idx,
                    self._filter_model(p)).submit(self.client))
                    for p in cold]
                per_pred = []
                for pred, handle in handles:
                    results = handle.results()
                    passes = [r.score >= 0.5 for r in results]
                    # raw result credits apportion the dispatch-metered
                    # spend across predicates; dedup-served results cost
                    # nothing at dispatch, so the apportioned total
                    # matches real spend
                    per_pred.append((pred, passes,
                                     float(sum(r.credits
                                               for r in results)),
                                     float(sum(r.latency_s
                                               for r in results))))
                spent = self.client.ai_credits - c0
                raw_total = sum(raw for _, _, raw, _ in per_pred)
                scale = spent / raw_total if raw_total > 0 else 0.0
                psp.set(rows_in=n_sampled, credits=spent)
                for pred, passes, raw, seconds in per_pred:
                    passed = int(sum(passes))
                    credits = raw * scale
                    key = self._pred_key(pred)
                    known[key] = dict(zip(idx.tolist(), passes))
                    st = self._stats_for(pred)
                    st.evaluated += len(idx)
                    st.passed += passed
                    st.credits += credits
                    st.seconds += seconds
                    obs = self.stats.observe_predicate(
                        self._fp_by_key[key],
                        evaluated=len(idx), passed=passed,
                        credits=credits, seconds=seconds)
                    lo, hi = obs.selectivity_ci()
                    sampled[key] = {
                        "rows": int(len(idx)),
                        "selectivity": obs.selectivity,
                        "selectivity_ci": (round(lo, 4), round(hi, 4)),
                        "cost_per_row": obs.cost_per_row}
        # re-rank with the stats-informed cost model: observed numbers
        # for piloted/warm AI predicates, static estimates elsewhere
        ranked = sorted(preds, key=self.cost.predicate_rank)
        reordered = ranked != preds
        if reordered:
            event = ("pilot reorder: "
                     + " -> ".join(self._pred_key(p) for p in ranked))
            self.reorder_events.append(event)
            self.reoptimizations.append(event)
        entry = {
            "sampled_rows": n_sampled,
            "cold_predicates": len(cold),
            "warm_predicates": len(ai_preds) - len(cold) - len(transferred),
            "transferred_predicates": len(transferred),
            "reordered": reordered,
            "seconds": time.perf_counter() - t0,
            "predicates": sampled,
        }
        if self.pilot_telemetry is None:
            self.pilot_telemetry = entry
        else:                      # several Filter nodes piloted: merge
            agg = self.pilot_telemetry
            for k in ("sampled_rows", "cold_predicates", "warm_predicates",
                      "transferred_predicates", "seconds"):
                agg[k] += entry[k]
            agg["reordered"] = agg["reordered"] or reordered
            agg["predicates"].update(sampled)
        return ranked, known

    def _timed_pred(self, pred: E.Expr, table: Table, rows: np.ndarray,
                    known: Optional[Dict[str, Dict[int, bool]]] = None
                    ) -> np.ndarray:
        """Evaluate one predicate over rows, folding cost into its stats
        (per-query telemetry) and into the persistent `StatsStore` (the
        cross-query learned-statistics feedback loop).

        ``known`` carries per-row results the pilot phase already paid
        for (pred key -> {row index: passed}); those rows are answered
        from it — never re-submitted, never re-counted — so pilot rows
        are billed and recorded exactly once even on an eager client.
        """
        st = self._stats_for(pred)
        rows = np.asarray(rows)
        km = (known or {}).get(self._pred_key(pred))
        if km:
            in_known = np.isin(rows, np.fromiter(km, dtype=np.int64))
        else:
            in_known = np.zeros(len(rows), dtype=bool)
        out = np.zeros(len(rows), dtype=bool)
        if km:
            out[in_known] = [km[int(r)] for r in rows[in_known]]
        unk = rows[~in_known]
        if len(unk):
            with active_tracer().span(self._pred_key(pred),
                                      kind="predicate",
                                      rows_in=int(len(unk))) as sp:
                t0 = time.perf_counter()
                c0 = self.client.ai_credits
                res = np.asarray(self._eval_pred(pred, table, unk),
                                 dtype=bool)
                seconds = time.perf_counter() - t0
                credits = self.client.ai_credits - c0
                sp.set(rows_out=int(res.sum()), credits=credits)
            st.seconds += seconds
            st.credits += credits
            st.evaluated += len(unk)
            st.passed += int(res.sum())
            if pred.is_ai():
                if self.obs is not None:
                    self.obs.registry.histogram(
                        "aisql_operator_seconds").observe(
                            seconds, operator=type(pred).__name__)
                self.stats.observe_predicate(
                    self._fp_by_key[self._pred_key(pred)],
                    evaluated=len(unk), passed=int(res.sum()),
                    credits=credits, seconds=seconds)
            out[~in_known] = res
        return out

    def _eval_predicates_chunked(self, table: Table, preds: List[E.Expr],
                                 known: Optional[Dict[str, Dict[int, bool]]]
                                 = None) -> np.ndarray:
        """Chunk-major evaluation with adaptive mid-stream reordering."""
        n = table.num_rows
        mask = np.ones(n, dtype=bool)
        order = list(preds)            # compile-time order from the optimizer
        chunk = self.cfg.chunk_rows if self.cfg.adaptive_reorder else n
        chunk = max(chunk, 1)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            alive = np.arange(lo, hi)
            for pred in order:
                if len(alive) == 0:
                    break
                res = self._timed_pred(pred, table, alive, known)
                alive = alive[res]
            sel = np.zeros(hi - lo, dtype=bool)
            sel[alive - lo] = True
            mask[lo:hi] = sel
            # --- adaptive reordering between chunks (§5.1 runtime) ---
            if self.cfg.adaptive_reorder and hi < n:
                ranked = sorted(order, key=lambda p: self._stats_for(p).rank)
                if ranked != order:
                    self.reorder_events.append(
                        f"rows[{hi}]: reorder -> "
                        + ", ".join(self._pred_key(p) for p in ranked))
                    order = ranked
        return mask

    def _eval_predicates_batched(self, table: Table, preds: List[E.Expr],
                                 known: Optional[Dict[str, Dict[int, bool]]]
                                 = None) -> np.ndarray:
        """Predicate-major evaluation for the pipelined runtime: each
        predicate scans all surviving rows in one coalesced pass (the
        pipeline right-sizes the engine batches), trading mid-stream
        reordering for batching.  Row results are per-row deterministic,
        so the output mask matches chunk-major evaluation exactly for
        exact (non-cascade) predicates."""
        n = table.num_rows
        order = list(preds)
        alive = np.arange(n)
        for pred in order:
            if len(alive) == 0:
                break
            res = self._timed_pred(pred, table, alive, known)
            alive = alive[res]
        mask = np.zeros(n, dtype=bool)
        mask[alive] = True
        if self.cfg.adaptive_reorder:
            ranked = sorted(order, key=lambda p: self._stats_for(p).rank)
            if ranked != order:           # observational: next query's hint
                self.reorder_events.append(
                    "batched: observed rank -> "
                    + ", ".join(self._pred_key(p) for p in ranked))
        return mask

    # ------------------------------------------------------------------
    # partition-pull streaming execution (the partitioned mode driver)
    # ------------------------------------------------------------------

    def _partition_spans(self, table: Table
                         ) -> List[Tuple[int, int, Optional[int]]]:
        """Partition boundaries ``(lo, hi, segment_id)`` for the pull
        loop.  On a chunk-backed table, partitions are aligned to never
        straddle a chunk — each span maps to exactly one segment whose
        morsel view feeds the predicate chain zero-copy; on a monolithic
        table ``segment_id`` is None and spans are plain
        ``partition_rows`` strides."""
        n = table.num_rows
        psize = max(self.cfg.partition_rows, 1)
        if isinstance(table, ChunkedTable):
            spans: List[Tuple[int, int, Optional[int]]] = []
            for sid, (slo, shi) in enumerate(table.segment_bounds()):
                for lo in range(slo, shi, psize):
                    spans.append((lo, min(lo + psize, shi), sid))
            return spans or [(0, 0, None)]
        return [(lo, min(lo + psize, n), None)
                for lo in range(0, n, psize)] or [(0, 0, None)]

    def _span_morsel(self, table: Table, sid: Optional[int]
                     ) -> Tuple[Table, int]:
        """The (morsel table, global row offset) a span evaluates on."""
        if sid is None:
            return table, 0
        return table.morsel(sid), table.segment_bounds()[sid][0]

    @staticmethod
    def _localize_known(known: Optional[Dict[str, Dict[int, bool]]],
                        moff: int, mend: int
                        ) -> Optional[Dict[str, Dict[int, bool]]]:
        """Rebase pilot-known row results (global indices) onto a
        morsel's local indices for rows inside ``[moff, mend)``."""
        if not known or moff == 0:
            return known
        return {key: {g - moff: v for g, v in km.items()
                      if moff <= g < mend}
                for key, km in known.items()}

    def _partition_pull(self, table: Table, preds: List[E.Expr],
                        known: Optional[Dict[str, Dict[int, bool]]],
                        limit: Optional[int]) -> np.ndarray:
        """The partition-pull loop: morsels of ``partition_rows`` flow
        through the whole predicate chain one partition at a time (each
        an independently submitted batch the scheduler spreads across
        replicas), feeding a `StreamingLimit` consumer.  With a limit the
        loop stops — and cancels still-queued prefetches — as soon as
        ``n`` surviving rows exist.  On a `ChunkedTable` each partition
        evaluates against its chunk's morsel view, so the table is never
        materialized; surviving-row bookkeeping stays in global indices
        throughout.  Returns the selected global row indices in table
        order."""
        psize = max(self.cfg.partition_rows, 1)
        spans = self._partition_spans(table)
        consumer = StreamingLimit(limit)
        order = list(preds)
        prefetched: Dict[int, Tuple[str, np.ndarray, SemanticHandle]] = {}
        # credits metered while *submitting* prefetches (a size-threshold
        # flush can dispatch mid-submit); folded into the predicate's
        # accounting at consume time so no spend is ever orphaned
        self._prefetch_spend: Dict[str, float] = {}
        tel = {"partitions_total": len(spans), "partitions_executed": 0,
               "partitions_cancelled": 0, "partition_rows": psize,
               "rows_scanned": 0, "rows_emitted": 0,
               "early_terminated": False, "cancelled_requests": 0}
        tr = active_tracer()
        try:
            for i, (lo, hi, sid) in enumerate(spans):
                part = np.arange(lo, hi, dtype=np.int64)
                tel["rows_scanned"] += int(len(part))
                with tr.span(f"partition[{i}]", kind="partition",
                             index=i, rows_in=int(len(part))) as msp:
                    self._prefetch_first_pred(table, order, known, spans,
                                              i, prefetched)
                    mtable, moff = self._span_morsel(table, sid)
                    kloc = known if sid is None else self._localize_known(
                        known, moff, table.segment_bounds()[sid][1])
                    alive = part
                    for pred in order:
                        if not len(alive):
                            break
                        pf = prefetched.get(lo)
                        if pf is not None and pf[0] == self._pred_key(pred):
                            _, rows, handle = prefetched.pop(lo)
                            res = self._consume_prefetched(pred, rows,
                                                           handle, alive)
                        else:
                            res = self._timed_pred(pred, mtable,
                                                   alive - moff, kloc)
                        alive = alive[res]
                    msp.set(rows_out=int(len(alive)))
                # a prefetch this partition never reached (rows died
                # first, or a reorder changed the chain): withdraw it
                leftover = prefetched.pop(lo, None)
                if leftover is not None:
                    tel["cancelled_requests"] += \
                        self._cancel_handles([leftover])
                tel["partitions_executed"] += 1
                accepted = consumer.add(alive)
                if self._stream_sink is not None and len(accepted):
                    self._stream_sink(accepted)
                # adaptive reordering between partitions (§5.1 runtime)
                if self.cfg.adaptive_reorder and order \
                        and i + 1 < len(spans):
                    ranked = sorted(order,
                                    key=lambda p: self._stats_for(p).rank)
                    if ranked != order:
                        self.reorder_events.append(
                            f"partition[{i}]: reorder -> "
                            + ", ".join(self._pred_key(p) for p in ranked))
                        tr.event("partition.reorder", index=i)
                        order = ranked
                if consumer.satisfied:
                    remaining = len(spans) - (i + 1)
                    if remaining or prefetched:
                        tel["early_terminated"] = True
                        tr.event("partition.early_stop",
                                 cancelled=remaining)
                    tel["partitions_cancelled"] = remaining
                    break
        except Exception:
            # a mid-query failure (e.g. a predicate batch that exhausted
            # its retries) must withdraw still-queued speculative
            # prefetches: abandoned in the pipeline they would be
            # dispatched — and billed — at some later barrier
            self._cancel_handles(prefetched.values())
            prefetched.clear()
            raise
        tel["cancelled_requests"] += self._cancel_handles(
            prefetched.values())
        prefetched.clear()
        # spend of dispatched-but-never-consumed prefetches still belongs
        # to the predicate (real credits, zero extra evaluated rows)
        for key, spend in self._prefetch_spend.items():
            if spend > 0.0:
                st = self.pred_stats.setdefault(key, PredicateStats())
                st.credits += spend
                fp = self._fp_by_key.get(key)
                if fp is not None:
                    self.stats.observe_predicate(fp, evaluated=0, passed=0,
                                                 credits=spend)
        self._prefetch_spend = {}
        out = consumer.take()
        tel["rows_emitted"] = int(len(out))
        self._note_partitions(tel)
        return out

    def _prefetch_first_pred(self, table: Table, order: List[E.Expr],
                             known, spans: List[Tuple], i: int,
                             prefetched: Dict[int, Tuple]) -> None:
        """Speculatively queue the first AI predicate of the next
        ``partition_lookahead`` partitions into the pipeline so their
        rows coalesce into one engine batch (split across replicas by
        the scheduler).  On a chunked table each lookahead span renders
        from its own morsel view (prompts are identical to a full-table
        render, so cache/dedup keys agree across stores); bookkeeping
        stays global.  Bounded speculation: on early termination the
        still-queued requests are cancelled, never dispatched or
        billed."""
        lookahead = self.cfg.partition_lookahead
        if (lookahead <= 1 or self.client.pipeline is None or not order
                or self.cfg.use_cascade):
            return
        pred = order[0]
        if not isinstance(pred, E.AIFilter):
            return
        key = self._pred_key(pred)
        if (known or {}).get(key):
            return      # pilot already paid for rows; avoid recounting
        c0 = self.client.ai_credits
        for j in range(i, min(i + lookahead, len(spans))):
            lo, hi, sid = spans[j]
            if lo in prefetched:
                continue
            rows = np.arange(lo, hi, dtype=np.int64)
            mtable, moff = self._span_morsel(table, sid)
            op = SemanticOp.from_filter(pred, mtable, rows - moff,
                                        self._filter_model(pred))
            prefetched[lo] = (key, rows, op.submit(self.client))
        spent = self.client.ai_credits - c0
        if spent > 0.0:       # a size-threshold flush dispatched mid-submit
            self._prefetch_spend[key] = \
                self._prefetch_spend.get(key, 0.0) + spent

    def _consume_prefetched(self, pred: E.Expr, rows: np.ndarray,
                            handle: SemanticHandle, alive: np.ndarray
                            ) -> np.ndarray:
        """Await a prefetched partition batch and fold its spend into the
        same per-query telemetry and `StatsStore` rows as `_timed_pred`
        (every prefetched row is billed and recorded exactly once)."""
        st = self._stats_for(pred)
        with active_tracer().span(self._pred_key(pred), kind="predicate",
                                  rows_in=int(len(rows)),
                                  prefetched=True) as sp:
            t0 = time.perf_counter()
            c0 = self.client.ai_credits
            passes = handle.scores() >= 0.5
            seconds = time.perf_counter() - t0
            credits = self.client.ai_credits - c0
            sp.set(rows_out=int(passes.sum()), credits=credits)
        # credits already metered while this (or a sibling) prefetch was
        # being submitted belong to the same predicate: claim them here
        # so learned cost-per-row reflects the real spend
        credits += self._prefetch_spend.pop(self._pred_key(pred), 0.0)
        st.evaluated += len(rows)
        st.passed += int(passes.sum())
        st.credits += credits
        st.seconds += seconds
        self.stats.observe_predicate(
            self._fp_by_key[self._pred_key(pred)], evaluated=len(rows),
            passed=int(passes.sum()), credits=credits, seconds=seconds)
        by_row = dict(zip(rows.tolist(), passes.tolist()))
        return np.asarray([by_row[int(r)] for r in alive], dtype=bool)

    def _cancel_handles(self, entries) -> int:
        """Cancel the still-queued futures of prefetched partition
        batches; dispatched (already billed/resolved) work is left
        alone.  Returns the number of requests withdrawn."""
        pipe = self.client.pipeline
        if pipe is None:
            return 0
        total = 0
        for _, _, handle in entries:
            pending = [f for f in handle.futures
                       if not f.done() and not f.cancelled()]
            if pending:
                # owner= moves the billing tag off this session when a
                # dedup-shared item survives for another session's sake
                total += pipe.cancel(pending, owner=self.client.owner)
        return total

    def _note_partitions(self, tel: Dict[str, Any]) -> None:
        if self.partition_telemetry is None:
            self.partition_telemetry = tel
            return
        agg = self.partition_telemetry
        for k in ("partitions_total", "partitions_executed",
                  "partitions_cancelled", "rows_scanned", "rows_emitted",
                  "cancelled_requests"):
            agg[k] += tel[k]
        agg["early_terminated"] = (agg["early_terminated"]
                                   or tel["early_terminated"])

    def _exec_limit(self, node: P.Limit) -> Table:
        """LIMIT.  In partitioned mode a streamable spine underneath —
        ``[Project] -> Filter* -> source`` — is pulled partition by
        partition with early termination: the filter chain (and any AI
        projection) runs only until ``n`` surviving rows exist instead
        of materializing everything and truncating."""
        if self.cfg.partitioned:
            spine = self._streamable_spine(node.child)
            if spine is not None:
                project, preds, inner = spine
                source = self._exec(inner)
                if preds:
                    preds, known = self._maybe_pilot(source, list(preds))
                else:
                    known = {}
                sel = self._partition_pull(source, preds, known,
                                           limit=node.n)
                out = source.take(sel)
                if project is not None:
                    out = self._exec_project(
                        P.Project(_Materialized(out), project.items))
                return out.head(node.n)
        return self._exec(node.child).head(node.n)

    def _streamable_spine(self, child: P.PlanNode):
        """Peel ``[Project] -> Filter* -> source`` under a Limit.
        Returns ``(project|None, predicates, source)`` when streaming
        can save work (a filter chain to early-terminate or a projection
        to bound), else None.  Predicates are in evaluation order
        (innermost filter first)."""
        project: Optional[P.Project] = None
        inner = child
        if isinstance(inner, P.Project):
            project, inner = inner, inner.child
        preds: List[E.Expr] = []
        while isinstance(inner, P.Filter):
            preds = list(inner.predicates) + preds
            inner = inner.child
        if project is None and not preds:
            return None
        return project, preds, inner

    # ------------------------------------------------------------------
    # ORDER BY: Sort and fused TopK (semantic ordering)
    # ------------------------------------------------------------------

    def _exec_sort(self, node: P.Sort) -> Table:
        table = self._exec(node.child)
        rows = np.arange(table.num_rows, dtype=np.int64)
        return table.take(self._order_rows(table, rows, node.keys))

    def _exec_topk(self, node: P.TopK) -> Table:
        """Fused ORDER BY + LIMIT — three early-exit paths by key kind:

        * AI_SIMILARITY primary: embeddings from the semantic index's
          store (only cold texts cost EMBED requests) ranked by the
          similarity kernel — exact, so index-on == index-off rows;
        * AI_SCORE primary with ``topk_index_score``: the index ranks
          rows against the score prompt's embedding and only the
          escalated candidates reach the ordering model (opt-in:
          bounded by the index's recall, see docs/semantic-index.md);
        * AI_SCORE primary otherwise: the proxy model scores every row
          and the best ``topk_candidate_factor * k`` escalate.
        """
        table = self._exec(node.child)
        n = node.n
        rows = np.arange(table.num_rows, dtype=np.int64)
        primary = node.keys[0] if node.keys else None
        if primary is not None and table.num_rows > n:
            if isinstance(primary.expr, E.AISimilarity):
                out = self._topk_similarity(node, table, rows)
                if out is not None:
                    return out
            if isinstance(primary.expr, E.AIScore):
                if self.semindex is not None and self.cfg.topk_index_score:
                    out = self._topk_index_score(node, table, rows)
                    if out is not None:
                        return out
                if self.cfg.topk_prefilter:
                    out = self._topk_proxy_prefilter(node, table, rows)
                    if out is not None:
                        return out
        return table.take(self._order_rows(table, rows, node.keys)[:n])

    def _topk_proxy_prefilter(self, node: P.TopK, table: Table,
                              rows: np.ndarray) -> Optional[Table]:
        """Proxy-score-all, escalate the best candidates to the oracle."""
        primary = node.keys[0]
        n = node.n
        proxy = self.cfg.proxy_model or self.client.proxy_model
        oracle = primary.expr.model or self.client.default_model
        k_cand = int(self.cost.topk_candidates(float(table.num_rows), n))
        if proxy == oracle or k_cand >= table.num_rows:
            return None
        pscores = self._ai_scores(primary.expr, table, rows, proxy)
        perm = sorted(range(len(rows)), key=lambda i: pscores[i],
                      reverse=primary.desc)
        cand = np.sort(rows[np.asarray(perm[:k_cand], dtype=np.int64)])
        self.reoptimizations.append(
            f"topk-prefilter: {proxy} scored {len(rows)} rows, "
            f"escalated {len(cand)} candidates to {oracle} (k={n})")
        return table.take(self._order_rows(table, cand, node.keys)[:n])

    def _topk_similarity(self, node: P.TopK, table: Table,
                         rows: np.ndarray) -> Optional[Table]:
        """Semantic top-k over an AI_SIMILARITY primary key.

        The similarity values come from embeddings (store-cached when a
        manager is attached) and the full ordering is computed from them
        locally — numerically identical to the unpruned Sort+Limit, so
        this path never changes result rows; it only removes repeat
        EMBED spend and, for the single-key case, ranks through the
        similarity kernel instead of a host sort."""
        primary = node.keys[0]
        e = primary.expr
        n = node.n
        sims, lv, rv = self._similarity_with_vectors(e, table, rows)
        lit_left = not e.left.refs()
        lit_right = not e.right.refs()
        col_side = e.right if lit_left else e.left
        col_refs = col_side.refs()
        if (self.semindex is not None and len(node.keys) == 1
                and lit_left != lit_right and len(col_refs) == 1
                and self._is_base_snapshot(node.child, table,
                                           next(iter(col_refs)))):
            # managed index ranking: the column side's snapshot gets (or
            # reuses) an `IvfFlatIndex`; the literal side is the query
            # vector.  Search honors SemIndexConfig.exact_topk / nprobe:
            # the default flat scan is exact (ties toward the lower row
            # index, matching the stable host sort), IVF probing trades
            # that for the configured recall.  ASC negates the query:
            # the top-k of -q·c is the bottom-k of q·c.
            mgr = self.semindex
            model = e.model or self.client.embed_model
            col_key = self._index_column_key(node.child,
                                             next(iter(col_refs)))
            corpus_texts = self._render_side(col_side, table, rows)
            mgr.ensure_index(self.client, col_key, corpus_texts,
                             metadata=row_metadata(table, rows),
                             model=model)
            qv = (lv if lit_left else rv)[:1].astype(np.float32)
            if not primary.desc:
                qv = -qv
            _, idx = mgr.search(col_key, qv, min(n, len(rows)))
            order = np.asarray(idx[0])
            order = order[order >= 0]
            self._index_note(index_topk=1)
            self.reoptimizations.append(
                f"topk-similarity: index ranked {len(rows)} rows "
                f"through the similarity kernel, top {len(order)} kept")
            return table.take(rows[order[:n]])
        precomputed = {id(e): sims}
        return table.take(self._order_rows(table, rows, node.keys,
                                           precomputed)[:n])

    def _topk_index_score(self, node: P.TopK, table: Table,
                          rows: np.ndarray) -> Optional[Table]:
        """Index-candidates-then-oracle for ``ORDER BY AI_SCORE`` top-k:
        rank rows by embedding similarity to the score prompt, escalate
        only ``topk_candidate_factor * k`` candidates to the ordering
        model — no proxy scan at all.  Opt-in (``topk_index_score``):
        the candidate set is only as good as the embedding space, so
        result rows are guaranteed up to that recall, not exactly."""
        primary = node.keys[0]
        pred: E.AIScore = primary.expr
        n = node.n
        k_cand = int(self.cost.topk_candidates(float(table.num_rows), n))
        if k_cand >= table.num_rows or not pred.prompt.args:
            return None
        model = self.semindex.model_for(self.client)
        # corpus: the rendered prompt arguments (the row text the score
        # judges); query: the prompt template itself, format slots
        # stripped
        arg_vals = [E.eval_expr(a, table, rows) for a in pred.prompt.args]
        texts = [" ".join(str(a[i]) for a in arg_vals)
                 for i in range(len(rows))]
        md = row_metadata(table, rows)
        c0 = self.client.ai_calls
        cv = self.semindex.embed_texts(self.client, texts, metadata=md,
                                       model=model)
        query = _strip_format_slots(pred.prompt.template)
        qv = self.semindex.embed_texts(self.client, [query], model=model)
        self._index_note(embed_texts=len(texts) + 1,
                         embed_llm_calls=self.client.ai_calls - c0)
        if not primary.desc:
            qv = -qv
        _, idx = self.semindex.topk_candidates(qv.astype(np.float32),
                                               cv.astype(np.float32),
                                               k_cand)
        order = np.asarray(idx[0])
        cand = np.sort(rows[order[order >= 0]])
        self._index_note(index_topk=1, probes=1, candidates=len(cand))
        oracle = pred.model or self.client.default_model
        self.reoptimizations.append(
            f"topk-index: semantic index ranked {len(rows)} rows, "
            f"escalated {len(cand)} candidates to {oracle} (k={n}, "
            "no proxy scan)")
        return table.take(self._order_rows(table, cand, node.keys)[:n])

    def _order_rows(self, table: Table, rows: np.ndarray,
                    keys, precomputed=None) -> np.ndarray:
        """Stable multi-key ordering of ``rows``: repeated stable sorts
        from the least-significant key up (Python's sort keeps ties in
        input order even with ``reverse=True``).  ``precomputed`` maps
        ``id(key expr) -> values over rows`` for keys a caller already
        evaluated (the TopK paths never pay for a key twice)."""
        idx = np.arange(len(rows))
        for sk in reversed(list(keys)):
            vals = (precomputed or {}).get(id(sk.expr))
            if vals is None:
                vals = self._sort_key_values(sk.expr, table, rows)
            sub = vals[idx]
            perm = sorted(range(len(sub)), key=lambda i: sub[i],
                          reverse=sk.desc)
            idx = idx[np.asarray(perm, dtype=np.int64)]
        return rows[idx]

    def _sort_key_values(self, expr: E.Expr, table: Table,
                         rows: np.ndarray) -> np.ndarray:
        if isinstance(expr, E.AIScore):
            return self._ai_scores(expr, table, rows,
                                   expr.model or self.client.default_model)
        if isinstance(expr, E.AISimilarity):
            return self._similarity_values(expr, table, rows)
        return np.asarray(E.eval_expr(expr, table, rows))

    def _ai_scores(self, pred: E.AIScore, table: Table, rows: np.ndarray,
                   model: str) -> np.ndarray:
        """Score ``rows`` with the SCORE request kind, metering into the
        per-query telemetry and the `StatsStore` under a model-resolved
        surrogate (proxy and oracle scores are distinct populations)."""
        surrogate = E.AIScore(pred.prompt, model=model)
        st = self._stats_for(surrogate)
        prompts = pred.prompt.render(table, rows)
        args = [E.eval_expr(a, table, rows) for a in pred.prompt.args]
        md = row_metadata(table, rows, args, arg_cols=sorted(pred.refs()))
        t0 = time.perf_counter()
        c0 = self.client.ai_credits
        scores = SemanticOp.scores(prompts, md,
                                   model).submit(self.client).scores()
        seconds = time.perf_counter() - t0
        credits = self.client.ai_credits - c0
        st.evaluated += len(rows)
        st.passed += int((scores >= 0.5).sum())
        st.credits += credits
        st.seconds += seconds
        self.stats.observe_predicate(
            self._fp_by_key[self._pred_key(surrogate)],
            evaluated=len(rows), passed=int((scores >= 0.5).sum()),
            credits=credits, seconds=seconds)
        return scores

    # ------------------------------------------------------------------
    # embeddings: AI_EMBED / AI_SIMILARITY evaluation
    # ------------------------------------------------------------------

    def _index_note(self, **deltas) -> None:
        """Accumulate per-query semantic-index telemetry
        (`QueryReport.semindex`)."""
        if self.index_telemetry is None:
            self.index_telemetry = {
                "index_joins": 0, "index_topk": 0, "probes": 0,
                "candidates": 0, "verify_calls": 0,
                "embed_texts": 0, "embed_llm_calls": 0}
        for k, v in deltas.items():
            self.index_telemetry[k] = self.index_telemetry.get(k, 0) + v

    def _render_side(self, e: E.Expr, table: Table,
                     rows: np.ndarray) -> List[str]:
        if isinstance(e, E.Literal):
            return [str(e.value)] * len(rows)
        return [str(v) for v in E.eval_expr(e, table, rows)]

    def _embed_side(self, e: E.Expr, table: Table, rows: np.ndarray,
                    model: str) -> np.ndarray:
        """Embed one AI_SIMILARITY / AI_EMBED side over ``rows``.

        Distinct texts embed once (crucial on an eager client, where
        there is no pipeline dedup to absorb a repeated literal); the
        `SemanticIndexManager`'s store answers warm texts without any
        EMBED request at all.  Row metadata travels with each request
        so the simulator's grounding hooks see the same evidence the
        AI_FILTER path forwards.
        """
        texts = self._render_side(e, table, rows)
        if not texts:                 # a filter eliminated every row
            return np.zeros((0, 1), np.float32)
        if e.refs():
            md = row_metadata(table, rows)
        else:
            md = [{} for _ in texts]
        first: Dict[str, int] = {}
        for i, t in enumerate(texts):
            first.setdefault(t, i)
        cold = [t for t in first if (model, t) not in self._embed_memo]
        calls0 = self.client.ai_calls
        if cold:
            cold_md = [md[first[t]] for t in cold]
            if self.semindex is not None:
                vecs = self.semindex.embed_texts(self.client, cold,
                                                 metadata=cold_md,
                                                 model=model)
            else:
                vecs = self.client.embed(cold, model=model,
                                         metadata=cold_md)
            for t, v in zip(cold, vecs):
                self._embed_memo[(model, t)] = np.asarray(v, np.float32)
        self._index_note(embed_texts=len(texts),
                         embed_llm_calls=self.client.ai_calls - calls0)
        return np.stack([self._embed_memo[(model, t)]
                         for t in texts]).astype(np.float32)

    def _similarity_with_vectors(self, pred: E.AISimilarity, table: Table,
                                 rows: np.ndarray):
        """``(sims, left_vecs, right_vecs)`` for ``rows``, metered into
        per-query telemetry and the `StatsStore` under the
        model-resolved surrogate (EMBED spend only — AI_SIMILARITY never
        touches a generative model)."""
        model = pred.model or self.client.embed_model
        surrogate = E.AISimilarity(pred.left, pred.right, model=model)
        st = self._stats_for(surrogate)
        t0 = time.perf_counter()
        c0 = self.client.ai_credits
        lv = self._embed_side(pred.left, table, rows, model)
        rv = self._embed_side(pred.right, table, rows, model)
        sims = np.sum(_unit_rows(lv) * _unit_rows(rv), axis=1)
        seconds = time.perf_counter() - t0
        credits = self.client.ai_credits - c0
        st.evaluated += len(rows)
        st.passed += int((sims >= 0.5).sum())
        st.credits += credits
        st.seconds += seconds
        self.stats.observe_predicate(
            self._fp_by_key[self._pred_key(surrogate)],
            evaluated=len(rows), passed=int((sims >= 0.5).sum()),
            credits=credits, seconds=seconds)
        return sims.astype(np.float64), lv, rv

    def _similarity_values(self, pred: E.AISimilarity, table: Table,
                           rows: np.ndarray) -> np.ndarray:
        return self._similarity_with_vectors(pred, table, rows)[0]

    def _embed_values(self, pred: E.AIEmbed, table: Table,
                      rows: np.ndarray) -> np.ndarray:
        """AI_EMBED projection: one unit vector (tuple cell) per row."""
        model = pred.model or self.client.embed_model
        surrogate = E.AIEmbed(pred.arg, model=model)
        st = self._stats_for(surrogate)
        t0 = time.perf_counter()
        c0 = self.client.ai_credits
        vecs = self._embed_side(pred.arg, table, rows, model)
        seconds = time.perf_counter() - t0
        credits = self.client.ai_credits - c0
        st.evaluated += len(rows)
        st.passed += len(rows)
        st.credits += credits
        st.seconds += seconds
        self.stats.observe_predicate(
            self._fp_by_key[self._pred_key(surrogate)],
            evaluated=len(rows), passed=len(rows),
            credits=credits, seconds=seconds)
        out = np.empty(len(rows), dtype=object)
        for i in range(len(rows)):
            out[i] = tuple(float(x) for x in vecs[i])
        return out

    def _eval_mixed(self, e: E.Expr, table: Table,
                    rows: np.ndarray) -> np.ndarray:
        """Evaluate an expression tree containing AI_SIMILARITY leaves
        (e.g. ``AI_SIMILARITY(a, b) > 0.8`` as a WHERE conjunct)."""
        if isinstance(e, E.AISimilarity):
            return self._similarity_values(e, table, rows)
        if isinstance(e, E.BinOp):
            l = self._eval_mixed(e.left, table, rows)
            r = self._eval_mixed(e.right, table, rows)
            ops = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
                   "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
                   ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
                   "+": lambda a, b: a + b, "-": lambda a, b: a - b,
                   "*": lambda a, b: a * b, "/": lambda a, b: a / b}
            return ops[e.op](l, r)
        if isinstance(e, E.Between):
            v = self._eval_mixed(e.expr, table, rows)
            lo = self._eval_mixed(e.lo, table, rows)
            hi = self._eval_mixed(e.hi, table, rows)
            return (v >= lo) & (v <= hi)
        if isinstance(e, E.Not):
            return ~np.asarray(self._eval_mixed(e.arg, table, rows), bool)
        if isinstance(e, E.BoolOp):
            parts = [np.asarray(self._eval_mixed(a, table, rows), bool)
                     for a in e.args]
            out = parts[0]
            for p in parts[1:]:
                out = (out & p) if e.op == "and" else (out | p)
            return out
        if isinstance(e, E.InList):
            v = self._eval_mixed(e.expr, table, rows)
            allowed = set(e.values)
            return np.asarray([x in allowed for x in v])
        return np.asarray(E.eval_expr(e, table, rows))

    def _eval_pred(self, pred: E.Expr, table: Table, rows: np.ndarray
                   ) -> np.ndarray:
        if isinstance(pred, E.AIFilter):
            return self._eval_ai_filter(pred, table, rows)
        if isinstance(pred, E.AIScore):
            raise NotImplementedError(
                "AI_SCORE is an ORDER BY key, not a predicate; compare "
                "with AI_FILTER instead")
        if isinstance(pred, E.AIClassify):
            raise NotImplementedError("AI_CLASSIFY as a predicate")
        if any(isinstance(c, E.AISimilarity) for c in E.ai_calls_in(pred)):
            return np.asarray(self._eval_mixed(pred, table, rows),
                              dtype=bool)
        return np.asarray(E.eval_expr(pred, table, rows), dtype=bool)

    # -- AI_FILTER with optional cascade --
    def _cascade_bypass(self, pred: E.AIFilter) -> Optional[str]:
        """Learned re-decision: skip the cascade for a predicate whose
        observed delegation rate shows the proxy escalates (nearly)
        everything — running it would only add proxy calls on top of the
        oracle calls.  Requires enough evidence in the store; when the
        store is cold for this fingerprint, a kNN-transferred delegation
        prior (cost model v2) can make the same call from the evidence
        of similar predicates.  Returns the reoptimization event string
        when the bypass applies, else None."""
        cfg = self.cfg
        obs = self.stats.get(predicate_fingerprint(pred))
        if (obs is not None
                and obs.cascade_rows >= cfg.cascade_bypass_min_rows):
            if obs.delegation_rate >= cfg.cascade_bypass_delegation:
                return (f"cascade-bypass: {self._pred_key(pred)} observed "
                        f"delegation {obs.delegation_rate:.2f} >= "
                        f"{cfg.cascade_bypass_delegation:.2f}, "
                        "routing straight to the oracle")
            return None
        tp = self.cost.transferred_prior(pred)
        if (tp is not None
                and tp.cascade_rows >= cfg.cascade_bypass_min_rows
                and tp.delegation_rate >= cfg.cascade_bypass_delegation):
            return (f"cascade-bypass: {self._pred_key(pred)} transferred "
                    f"delegation {tp.delegation_rate:.2f} >= "
                    f"{cfg.cascade_bypass_delegation:.2f} (kNN prior), "
                    "routing straight to the oracle")
        return None

    def _eval_ai_filter(self, pred: E.AIFilter, table: Table,
                        rows: np.ndarray) -> np.ndarray:
        model = self._filter_model(pred)
        op = SemanticOp.from_filter(pred, table, rows, model)
        if not self.cfg.use_cascade:
            return op.submit(self.client).scores() >= 0.5
        bypass = self._cascade_bypass(pred)
        if bypass is not None:
            if bypass not in self.reoptimizations:
                self.reoptimizations.append(bypass)
            return op.submit(self.client).scores() >= 0.5
        proxy = self.cfg.proxy_model or self.client.proxy_model
        cascade = self.cascades.setdefault(
            self._pred_key(pred), SupgItCascade(self.cfg.cascade))
        items = list(zip(op.prompts, op.metadata))

        tr = active_tracer()

        def proxy_scores(batch):
            tr.event("cascade.proxy", rows=len(batch), model=proxy)
            return SemanticOp.scores(
                [p for p, _ in batch], [m for _, m in batch],
                proxy).submit(self.client).scores()

        def oracle_labels(batch):
            tr.event("cascade.escalate", rows=len(batch), model=model)
            s = SemanticOp.scores(
                [p for p, _ in batch], [m for _, m in batch],
                model).submit(self.client).scores()
            return s >= 0.5

        with tr.span(self._pred_key(pred), kind="cascade",
                     rows_in=int(len(rows)), proxy=proxy,
                     oracle=model) as csp:
            out = cascade.run(items, proxy_scores, oracle_labels)
            csp.set(rows_out=int(np.asarray(out).sum()))
        return out

    # ------------------------------------------------------------------
    # Joins
    # ------------------------------------------------------------------

    def _combine(self, left: Table, right: Table, lidx: np.ndarray,
                 ridx: np.ndarray) -> Table:
        cols: Dict[str, Any] = {}
        types: Dict[str, str] = {}
        for k in left.column_names:
            cols[k] = left.column(k)[lidx]
            types[k] = left.types[k]
        for k in right.column_names:
            cols[k] = right.column(k)[ridx]
            types[k] = right.types[k]
        return Table(cols, types)

    def _exec_join(self, node: P.Join) -> Table:
        left = self._exec(node.left)
        right = self._exec(node.right)
        if node.equi:
            lk, rk = node.equi[0]
            lidx, ridx = _hash_join_indices(
                left.column(E.resolve_column(left, lk)),
                right.column(E.resolve_column(right, rk)))
            # extra equi conjuncts as post-filters
            joined = self._combine(left, right, lidx, ridx)
            for lk2, rk2 in node.equi[1:]:
                m = (joined.column(E.resolve_column(joined, lk2))
                     == joined.column(E.resolve_column(joined, rk2)))
                joined = joined.filter_mask(m)
        else:
            lidx, ridx = left.cross_join_indices(right)
            joined = self._combine(left, right, lidx, ridx)
        if node.residual:
            mask = self.eval_predicates(joined, list(node.residual))
            joined = joined.filter_mask(mask)
        return joined

    # ------------------------------------------------------------------
    # SemanticJoinClassify (§5.3 rewritten join)
    # ------------------------------------------------------------------

    def _exec_semantic_join(self, node: P.SemanticJoinClassify) -> Table:
        left = self._exec(node.left)
        right = self._exec(node.right)
        label_col = E.resolve_column(right, node.label_col)
        label_vals = right.column(label_col)
        # label value -> right row indices (labels may repeat)
        label_rows: Dict[str, List[int]] = {}
        uniq: List[str] = []
        for j, v in enumerate(label_vals):
            s = str(v)
            if s not in label_rows:
                uniq.append(s)
                label_rows[s] = []
            label_rows[s].append(j)
        left_rows = np.arange(left.num_rows)
        left_text = np.asarray(E.eval_expr(node.left_arg, left, left_rows),
                               dtype=object)
        chunk = max(node.max_labels_per_call, 1)
        chunks = [uniq[i:i + chunk] for i in range(0, len(uniq), chunk)]
        instruction = node.prompt.template
        md_rows = row_metadata(left, left_rows)
        model = node.model or self.client.default_model
        # submit every (pass × label-chunk) micro-batch before awaiting any:
        # the pipeline coalesces them into right-sized engine batches
        c0 = self.client.ai_credits
        s0 = self.client.ai_seconds
        handles: List[SemanticHandle] = []
        for pass_no in range(max(self.cfg.classify_passes, 1)):
            tag = "" if pass_no == 0 else (
                f" (pass {pass_no + 1}: select any additional matches)")
            for labels in chunks:
                prompts = [
                    ("Select every label that satisfies: "
                     f"{instruction}{tag}\ninput: {t}") for t in left_text]
                op = SemanticOp.classify(
                    prompts, md_rows, labels, model,
                    self.cfg.classify_multi_label)
                handles.append(op.submit(self.client))
        selected: List[set] = [set() for _ in range(left.num_rows)]
        calls = passed = 0
        for handle in handles:
            for i, labs in enumerate(handle.chosen_labels()):
                selected[i].update(labs)
                calls += 1
                passed += bool(labs)
        # dispatch-metered deltas: dedup-served repeats cost (and record)
        # nothing, matching the _timed_pred / StatsStore contract
        credits = self.client.ai_credits - c0
        seconds = self.client.ai_seconds - s0
        if calls:
            # recorded under the same surrogate AIClassify the cost model
            # prices the rewrite with, so the next query's rewrite-vs-
            # cross-join decision runs on observed per-call numbers
            fake = E.AIClassify(node.prompt, labels=(), model=node.model)
            self._stats_for(fake)          # registers key -> fingerprint
            st = self.pred_stats[self._pred_key(fake)]
            st.evaluated += calls
            st.passed += passed
            st.credits += credits
            st.seconds += seconds
            self.stats.observe_predicate(
                self._fp_by_key[self._pred_key(fake)], evaluated=calls,
                passed=passed, credits=credits, seconds=seconds)
        pairs_l: List[int] = []
        pairs_r: List[int] = []
        for i, labs in enumerate(selected):
            for lb in labs:
                for j in label_rows.get(lb, ()):
                    pairs_l.append(i)
                    pairs_r.append(j)
        return self._combine(left, right, np.asarray(pairs_l, np.int64),
                             np.asarray(pairs_r, np.int64))

    # ------------------------------------------------------------------
    # SemanticJoinIndex (index-assisted blocking + LLM verification)
    # ------------------------------------------------------------------

    def _is_base_snapshot(self, plan: P.PlanNode, table: Table,
                          qualified: str) -> bool:
        """Whether the executed snapshot is the referenced base column
        in full.  The managed per-column index is only worth (re)building
        for the full column — a filtered subset would churn the content
        signature on every distinct WHERE clause; those rank from the
        already-computed similarity values instead."""
        key = self._index_column_key(plan, qualified)
        tname = key.split(".", 1)[0]
        try:
            return self.catalog.table(tname).num_rows == table.num_rows
        except KeyError:
            return False

    def _index_column_key(self, plan: P.PlanNode, qualified: str) -> str:
        """Stable registry key for an indexed column: the base table's
        name when the alias resolves to a Scan (so two queries aliasing
        one table share the index), the qualified name otherwise."""
        alias, _, leaf = qualified.partition(".")

        def walk(n: P.PlanNode):
            if isinstance(n, P.Scan) and n.alias == alias:
                return f"{n.table}.{leaf or alias}"
            for c in n.children():
                found = walk(c)
                if found:
                    return found
            return None

        return walk(plan) or qualified

    def _exec_semantic_join_index(self, node: P.SemanticJoinIndex) -> Table:
        """Index-assisted semantic join: kNN candidate labels per left
        row (embedding kernel, near-zero credits), then one multi-label
        AI_CLASSIFY per left row over *only its candidates*.

        The verification prompt is byte-identical to the §5.3 rewrite's,
        so on backends whose per-label decisions are independent of the
        candidate-set composition (the simulator keys them that way) the
        verified pairs are exactly the full rewrite's selections
        restricted to the candidate set — result parity holds whenever
        candidate recall covers the selected labels.
        """
        if self.semindex is None:       # planned elsewhere; degrade safely
            return self._exec_semantic_join(P.SemanticJoinClassify(
                left=node.left, right=node.right, prompt=node.prompt,
                left_arg=node.left_arg, label_col=node.label_col,
                model=node.model,
                max_labels_per_call=node.max_labels_per_call))
        left = self._exec(node.left)
        right = self._exec(node.right)
        mgr = self.semindex
        label_col = E.resolve_column(right, node.label_col)
        label_vals = right.column(label_col)
        label_rows: Dict[str, List[int]] = {}
        uniq: List[str] = []
        for j, v in enumerate(label_vals):
            s = str(v)
            if s not in label_rows:
                uniq.append(s)
                label_rows[s] = []
            label_rows[s].append(j)
        if left.num_rows == 0 or not uniq:
            # an empty side joins to nothing — no blocking, no calls
            return self._combine(left, right, np.empty(0, np.int64),
                                 np.empty(0, np.int64))
        left_rows = np.arange(left.num_rows)
        left_text = [str(v) for v in
                     E.eval_expr(node.left_arg, left, left_rows)]
        md_rows = row_metadata(left, left_rows)
        embed_model = mgr.model_for(self.client)
        # --- blocking: label-side IVF index + kNN through the kernel --
        # the index is built once per column snapshot (refresh-on-drift
        # via content signature) and shared across queries and — under
        # serving — tenants; search honors SemIndexConfig.exact_topk /
        # nprobe (flat exact scan by default)
        calls0 = self.client.ai_calls
        c0 = self.client.ai_credits
        col_key = self._index_column_key(node.right, node.label_col)
        mgr.ensure_index(self.client, col_key, uniq,
                         metadata=[{"embed_anchor": u} for u in uniq],
                         model=embed_model)
        lvec = mgr.embed_texts(self.client, left_text, metadata=md_rows,
                               model=embed_model)
        embed_credits = self.client.ai_credits - c0
        k = min(node.k, len(uniq))
        vals, idx = mgr.search(col_key, lvec, k) if k else \
            (np.zeros((left.num_rows, 0)), np.zeros((left.num_rows, 0),
                                                    np.int64))
        floor = mgr.cfg.join_min_sim
        candidates: List[List[str]] = []
        for i in range(left.num_rows):
            cand = [uniq[int(j)] for v, j in zip(vals[i], idx[i])
                    if j >= 0 and (floor is None or v >= floor)]
            candidates.append(cand)
        total_cand = sum(len(c) for c in candidates)
        fp_index = index_join_fingerprint(
            node.prompt.template, node.model,
            node.left_arg.name if isinstance(node.left_arg, E.Column)
            else type(node.left_arg).__name__, node.label_col)
        self.stats.observe_index(fp_index, probes=left.num_rows,
                                 candidates=total_cand)
        self._index_note(index_joins=1, probes=left.num_rows,
                         candidates=total_cand,
                         embed_texts=left.num_rows + len(uniq),
                         embed_llm_calls=self.client.ai_calls - calls0)
        # --- verification: candidate-set classify per left row --------
        instruction = node.prompt.template
        model = node.model or self.client.default_model
        chunk = max(node.max_labels_per_call, 1)
        c1 = self.client.ai_credits
        s0 = self.client.ai_seconds
        handles: List[Tuple[int, SemanticHandle]] = []
        # same pass structure (and pass-tagged prompts) as the classify
        # rewrite, so the k-pass hybrid-join recall recovery applies to
        # the candidate sets identically
        for pass_no in range(max(self.cfg.classify_passes, 1)):
            tag = "" if pass_no == 0 else (
                f" (pass {pass_no + 1}: select any additional matches)")
            for i, cand in enumerate(candidates):
                if not cand:
                    continue        # index pruned the row to nothing
                prompt = ("Select every label that satisfies: "
                          f"{instruction}{tag}\ninput: {left_text[i]}")
                for lo in range(0, len(cand), chunk):
                    op = SemanticOp.classify(
                        [prompt], [md_rows[i]], cand[lo:lo + chunk], model,
                        self.cfg.classify_multi_label)
                    handles.append((i, op.submit(self.client)))
        selected: List[set] = [set() for _ in range(left.num_rows)]
        calls = passed = 0
        for i, handle in handles:
            for labs in handle.chosen_labels():
                selected[i].update(labs)
                calls += 1
                passed += bool(labs)
        credits = self.client.ai_credits - c1
        seconds = self.client.ai_seconds - s0
        if calls:
            fake = self.cost.index_verify_surrogate(node)
            st = self._stats_for(fake)
            st.evaluated += calls
            st.passed += passed
            st.credits += credits
            st.seconds += seconds
            self.stats.observe_predicate(
                self._fp_by_key[self._pred_key(fake)], evaluated=calls,
                passed=passed, credits=credits, seconds=seconds)
        self._index_note(verify_calls=calls)
        self.reoptimizations.append(
            f"index-join: {left.num_rows} probes -> {total_cand} "
            f"candidate pairs ({len(uniq)} labels), {calls} verification "
            f"calls, embeds {embed_credits:.3g} credits")
        pairs_l: List[int] = []
        pairs_r: List[int] = []
        for i, labs in enumerate(selected):
            for lb in labs:
                for j in label_rows.get(lb, ()):
                    pairs_l.append(i)
                    pairs_r.append(j)
        return self._combine(left, right, np.asarray(pairs_l, np.int64),
                             np.asarray(pairs_r, np.int64))

    # ------------------------------------------------------------------
    # Aggregate / Project
    # ------------------------------------------------------------------

    def _agg_value(self, agg: E.AggCall, table: Table, rows: np.ndarray,
                   aggregator: HierarchicalAggregator):
        name = agg.name
        if name == "COUNT":
            return int(len(rows))
        col = E.eval_expr(agg.args[0], table, rows)
        if name == "SUM":
            return float(np.sum(col.astype(np.float64)))
        if name == "AVG":
            return float(np.mean(col.astype(np.float64))) if len(rows) else 0.0
        if name == "MIN":
            return col.min() if len(rows) else None
        if name == "MAX":
            return col.max() if len(rows) else None
        if name in ("AI_AGG", "AI_SUMMARIZE_AGG"):
            out = aggregator.aggregate([str(v) for v in col],
                                       agg.instruction)
            self.agg_telemetry = aggregator.telemetry
            return out
        raise KeyError(name)

    def _agg_type(self, agg: E.AggCall, table: Table) -> Optional[str]:
        name = agg.name
        if name == "COUNT":
            return "int"
        if name in ("SUM", "AVG"):
            return "float"
        if name in ("AI_AGG", "AI_SUMMARIZE_AGG"):
            return "str"
        if name in ("MIN", "MAX") and agg.args \
                and isinstance(agg.args[0], E.Column):
            try:
                return table.types[
                    E.resolve_column(table, agg.args[0].name)]
            except KeyError:
                return None
        return None

    def _item_name(self, item: E.SelectItem, i: int) -> str:
        if item.alias:
            return item.alias
        e = item.expr
        if isinstance(e, E.Column):
            return e.name
        if isinstance(e, E.AggCall):
            return e.name.lower()
        if isinstance(e, E.AIComplete):
            return "ai_complete"
        if isinstance(e, E.AIClassify):
            return "ai_classify"
        if isinstance(e, E.AIScore):
            return "ai_score"
        if isinstance(e, E.AISimilarity):
            return "ai_similarity"
        if isinstance(e, E.AIEmbed):
            return "ai_embed"
        return f"col{i}"

    def _materialize_item(self, table: Table, item: E.SelectItem) -> Table:
        """Compute one select item as a column (GROUP BY <alias> support)."""
        one = self._exec_project(P.Project(_Materialized(table), (item,)))
        name = self._item_name(item, 0)
        return table.with_column(name, one.column(name))

    def _exec_aggregate(self, node: P.Aggregate) -> Table:
        table = self._exec(node.child)
        aggregator = HierarchicalAggregator(self.client, self.cfg.agg)
        key0 = None
        if node.group_by:
            try:
                key0 = E.resolve_column(table, node.group_by[0])
            except KeyError:
                # GROUP BY a select alias (e.g. an AI_CLASSIFY output):
                # materialize that item first, then group on it
                for item in node.items:
                    if item.alias == node.group_by[0]:
                        table = self._materialize_item(table, item)
                        break
                key0 = E.resolve_column(table, node.group_by[0])
            groups = table.group_indices(key0)
        else:
            groups = {None: np.arange(table.num_rows)}
        cols: Dict[str, List[Any]] = {}
        types: Dict[str, str] = {}
        for gkey, rows in groups.items():
            for i, item in enumerate(node.items):
                name = self._item_name(item, i)
                e = item.expr
                t: Optional[str] = None
                if isinstance(e, E.AggCall):
                    v = self._agg_value(e, table, rows, aggregator)
                    t = self._agg_type(e, table)
                elif isinstance(e, E.Column):
                    c = E.resolve_column(table, e.name)
                    v = table.column(c)[rows[0]]
                    t = table.types[c]
                elif isinstance(e, E.Star):
                    v = gkey
                    t = table.types.get(key0) if key0 is not None else None
                elif name in table:          # materialized alias column
                    v = table.column(name)[rows[0]]
                    t = table.types.get(name)
                else:
                    v = E.eval_expr(e, table, rows[:1])[0]
                cols.setdefault(name, []).append(v)
                if t:
                    types[name] = t
        # never force a dtype onto a column that carries NULLs (e.g. the
        # MIN/MAX of an empty group)
        types = {k: t for k, t in types.items()
                 if all(v is not None for v in cols[k])}
        return Table(cols, types or None)

    def _exec_project(self, node: P.Project) -> Table:
        table = self._exec(node.child)
        rows = np.arange(table.num_rows)
        # phase 1: assemble + submit every semantic item up front so the
        # pipeline can coalesce across projection items (cross-operator)
        handles: Dict[int, SemanticHandle] = {}
        item_labels: Dict[int, Tuple[str, ...]] = {}
        for i, item in enumerate(node.items):
            e = item.expr
            if isinstance(e, E.AIComplete):
                prompts = e.prompt.render(table, rows)
                md = row_metadata(table, rows)
                op = SemanticOp.complete(
                    prompts, md, e.model or self.client.default_model,
                    e.max_tokens)
                handles[i] = op.submit(self.client)
            elif isinstance(e, E.AIClassify):
                prompts = e.text.render(table, rows)
                md = row_metadata(table, rows)
                labels = e.labels
                if e.labels_expr is not None:
                    lv = E.eval_expr(e.labels_expr, table, rows[:1])
                    labels = tuple(lv[0]) if len(lv) else ()
                item_labels[i] = tuple(labels)
                op = SemanticOp.classify(
                    prompts, md, labels, e.model or self.client.default_model,
                    e.multi_label)
                handles[i] = op.submit(self.client)
        # phase 2: await + materialize columns
        cols: Dict[str, Any] = {}
        types: Dict[str, str] = {}
        for i, item in enumerate(node.items):
            e = item.expr
            if isinstance(e, E.Star):
                for c in table.column_names:
                    if not _is_hidden(c):
                        cols[c] = table.column(c)
                        types[c] = table.types[c]
                continue
            name = self._item_name(item, i)
            if isinstance(e, E.AIComplete):
                cols[name] = np.asarray(handles[i].texts(), dtype=object)
                types[name] = "str"
            elif isinstance(e, E.AIClassify):
                chosen = handles[i].chosen_labels()
                if e.multi_label:
                    cols[name] = np.asarray([tuple(c) for c in chosen],
                                            dtype=object)
                else:
                    cols[name] = np.asarray(
                        [c[0] if c else None for c in chosen], dtype=object)
                types[name] = "str"
            elif isinstance(e, E.AIFilter):
                cols[name] = self._eval_ai_filter(e, table, rows)
                types[name] = "bool"
            elif isinstance(e, E.AIScore):
                cols[name] = self._ai_scores(
                    e, table, rows, e.model or self.client.default_model)
                types[name] = "float"
            elif isinstance(e, E.AISimilarity):
                cols[name] = self._similarity_values(e, table, rows)
                types[name] = "float"
            elif isinstance(e, E.AIEmbed):
                cols[name] = self._embed_values(e, table, rows)
                types[name] = "str"
            elif any(isinstance(c, E.AISimilarity)
                     for c in E.ai_calls_in(e)):
                cols[name] = self._eval_mixed(e, table, rows)
            else:
                cols[name] = E.eval_expr(e, table, rows)
        if not cols:                      # SELECT over an empty item list
            cols["rows"] = np.arange(table.num_rows)
        return Table(cols, types or None)


class _Materialized(P.PlanNode):
    """Plan leaf wrapping an already-computed Table (internal)."""

    def __init__(self, table: Table):
        self.table = table
