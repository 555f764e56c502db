"""AisqlEngine — the public entry point: SQL text in, Table out.

Wires the full paper pipeline:

    parse (§3 dialect) -> build_plan -> AI-aware optimize (§5.1/§5.3)
        -> execute (§5.2 cascades, runtime adaptation) -> Table

plus the adaptive re-optimization loop: a `StatsStore` shared by the
cost model (reads) and the executor (writes) lets each query plan with
the previous queries' — and its own pilot sample's — observed
selectivity and cost numbers.  Per-query estimated-vs-actual accounting
is surfaced as `QueryReport.operators` and rendered by
`QueryReport.explain_analyze` (the paper's §4 instrumentation turned
into an EXPLAIN ANALYZE).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from repro_torch.core import expr as E
from repro_torch.core import plan as P
from repro_torch.core import sqlparse
from repro_torch.core.cost import Catalog, CostModel
from repro_torch.core.executor import ExecConfig, Executor
from repro_torch.core.optimizer import Optimizer, OptimizerConfig
from repro_torch.core.stats import StatsStore
from repro_torch.inference.api import CortexClient
from repro_torch.obs.trace import NOOP, activate, critical_path
from repro_torch.tables.table import Table


@dataclasses.dataclass
class OperatorReport:
    """Estimated-vs-actual accounting for one AI/relational predicate.

    ``est_*`` fields are captured at plan time (before execution, so a
    warm `StatsStore` shows up as better estimates, not as hindsight);
    ``actual_*`` fields come from the executor's per-predicate telemetry
    and are None when the operator never ran (e.g. short-circuited).
    Units: selectivities are fractions, costs are credits per row.
    """
    operator: str                       # executor predicate key
    est_rows_in: float                  # rows the planner expected to see
    est_selectivity: float
    # Wilson interval on the observed selectivity; (0.0, 1.0) — maximum
    # uncertainty — when the store has no evidence (cold start)
    est_selectivity_ci: tuple = (0.0, 1.0)
    est_cost_per_row: float = 0.0
    # "observed" | "blended" | "transferred" | "default"
    est_source: str = "default"
    actual_rows_in: Optional[int] = None
    actual_selectivity: Optional[float] = None
    actual_cost_per_row: Optional[float] = None
    actual_credits: Optional[float] = None


@dataclasses.dataclass
class QueryReport:
    """Everything the engine observed about one ``sql()`` call."""
    sql: str
    plan: str                  # optimized plan, pretty-printed
    optimizer_trace: list      # one line per plan rewrite decision
    est_llm_cost: float        # planner's credit estimate (pre-execution)
    wall_seconds: float
    ai_calls: int              # LLM requests dispatched (post-dedup)
    ai_credits: float          # credits actually spent
    ai_seconds: float          # modelled model-serving seconds
    rows_out: int
    # semantic-operator runtime telemetry (None on an eager client):
    # batch-size histogram, dedup hit counts/rate, queue-wait seconds,
    # submitted vs dispatched request counts, flush causes
    pipeline: Optional[Dict[str, Any]] = None
    # estimated-vs-actual per predicate (EXPLAIN ANALYZE source data)
    operators: List[OperatorReport] = dataclasses.field(default_factory=list)
    # mid-query re-optimization events: pilot reorders, cascade bypasses
    reoptimizations: List[str] = dataclasses.field(default_factory=list)
    # pilot-sample telemetry: sampled_rows, cold/warm predicate counts,
    # reordered flag, per-predicate observed selectivity (+ Wilson CI)
    # and cost_per_row; None when no Filter was piloted
    pilot: Optional[Dict[str, Any]] = None
    # partition-pull telemetry (partitioned mode only): partitions
    # total/executed/cancelled, rows scanned/emitted, early_terminated,
    # cancelled (never-dispatched) request count; None otherwise
    partitions: Optional[Dict[str, Any]] = None
    # semantic-index telemetry: index joins / top-k prunes run, kNN
    # probes and candidates, verification calls, texts embedded and the
    # EMBED requests actually dispatched for them (store hits cost
    # none); None when no query operator touched the index subsystem
    semindex: Optional[Dict[str, Any]] = None
    # plan-memo telemetry: hit flag, optimizer cost races actually run
    # (zero on a hit), memo entry count; None when the memo is disabled
    memo: Optional[Dict[str, Any]] = None
    # span-tree dict (parse/optimize/execute/dispatch hierarchy with
    # per-span rows/tokens/credits attributes); None unless the engine
    # was built with a tracing-enabled Observability — see docs/
    # observability.md for the span taxonomy and export formats
    trace: Optional[Dict[str, Any]] = None

    def explain_analyze(self) -> str:
        """EXPLAIN ANALYZE-style rendering: the optimized plan followed
        by a per-operator estimated-vs-actual table, re-optimization
        events and the pilot summary."""
        lines = [self.plan,
                 f"-- est LLM cost: {self.est_llm_cost:.6g} credits; "
                 f"actual: {self.ai_credits:.6g} credits "
                 f"({self.ai_calls} calls)"]
        if self.operators:
            hdr = (f"{'operator':<44} {'est.sel':>8} {'act.sel':>8} "
                   f"{'est.c/row':>10} {'act.c/row':>10} {'rows':>7} "
                   f"{'source':>9}")
            lines += ["-- operators (estimated vs actual):", hdr,
                      "-" * len(hdr)]
            for op in self.operators:
                act_sel = ("-" if op.actual_selectivity is None
                           else f"{op.actual_selectivity:.3f}")
                act_c = ("-" if op.actual_cost_per_row is None
                         else f"{op.actual_cost_per_row:.2e}")
                rows = ("-" if op.actual_rows_in is None
                        else str(op.actual_rows_in))
                lines.append(
                    f"{op.operator[:44]:<44} {op.est_selectivity:>8.3f} "
                    f"{act_sel:>8} {op.est_cost_per_row:>10.2e} "
                    f"{act_c:>10} {rows:>7} {op.est_source:>9}")
        for ev in self.reoptimizations:
            lines.append(f"-- reoptimized: {ev}")
        if self.pilot:
            lines.append(
                f"-- pilot: {self.pilot['sampled_rows']} rows sampled, "
                f"{self.pilot['cold_predicates']} cold / "
                f"{self.pilot['warm_predicates']} warm predicate(s), "
                f"reordered={self.pilot['reordered']}")
        if self.partitions:
            p = self.partitions
            suffix = " (early termination)" if p["early_terminated"] else ""
            lines.append(
                f"-- partitions: {p['partitions_executed']}/"
                f"{p['partitions_total']} executed, "
                f"{p['partitions_cancelled']} cancelled, "
                f"{p['rows_scanned']} rows scanned -> "
                f"{p['rows_emitted']} emitted, "
                f"{p['cancelled_requests']} queued request(s) "
                f"withdrawn{suffix}")
        if self.semindex:
            s = self.semindex
            lines.append(
                f"-- semindex: {s['index_joins']} join(s) / "
                f"{s['index_topk']} top-k via index, {s['probes']} probes "
                f"-> {s['candidates']} candidates, "
                f"{s['verify_calls']} verification call(s), "
                f"{s['embed_texts']} texts embedded "
                f"({s['embed_llm_calls']} EMBED requests)")
        if self.memo:
            m = self.memo
            lines.append(
                f"-- plan-memo: {'hit' if m['hit'] else 'miss'}, "
                f"{m['cost_races']} cost race(s) run, "
                f"{m['entries']} plan(s) memoized")
        if self.trace:
            lines.append("-- " + critical_path(self.trace))
        return "\n".join(lines)


class AisqlEngine:
    """SQL front door.

    Args:
        catalog: table registry.
        client: a `CortexClient` (eager or pipelined).
        optimizer: planner policy (`OptimizerConfig`).
        executor: runtime policy (`ExecConfig`) — cascades, chunking,
            pilot sampling, cascade bypass.
        llm_judge: optional §5.3 rewrite-oracle veto hook.
        stats: a `StatsStore` to share across engines/queries; by default
            a fresh in-memory store is created (adaptivity within the
            engine's lifetime, nothing persisted).
        stats_path: convenience — build the store from this JSON file
            and save back after every query (ignored when ``stats`` is
            passed explicitly; call ``stats.save(path)`` yourself then).
        semindex: the semantic index subsystem — ``True`` for a fresh
            default `SemanticIndexManager`, a `SemIndexConfig` to
            configure one, or a manager instance to *share* (the serving
            runtime passes one manager to every tenant session).  None
            (default) disables index-assisted plans entirely: the
            optimizer never races `SemanticJoinIndex` and top-k
            similarity queries embed through the client directly.
        semindex_path: persistence prefix for the embedding store
            (``<path>.json`` + ``<path>.npz``), used when the manager is
            built here; saved after every query like ``stats_path``.
        device: where a manager built here keeps its index and runs its
            searches (the similarity top-k kernel on a CUDA device, its
            plain version on ``"cpu"``).  A manager built here asks for
            CUDA unless the caller passes ``device="cpu"``; nothing falls
            back to the CPU on its own.  A shared manager keeps its own.
    """

    def __init__(self, catalog: Catalog, client: CortexClient, *,
                 optimizer: Optional[OptimizerConfig] = None,
                 executor: Optional[ExecConfig] = None,
                 llm_judge=None,
                 stats: Optional[StatsStore] = None,
                 stats_path: Optional[str] = None,
                 semindex=None,
                 semindex_path: Optional[str] = None,
                 obs=None, device="cuda"):
        from repro_torch.semindex import SemanticIndexManager, SemIndexConfig
        self.catalog = catalog
        self.client = client
        opt_cfg = optimizer or OptimizerConfig()
        self.stats_path = stats_path if stats is None else None
        self.stats = stats if stats is not None else StatsStore(stats_path)
        self.semindex_path = None
        if semindex is True:
            semindex = SemanticIndexManager(path=semindex_path,
                                            device=device)
            self.semindex_path = semindex_path
        elif isinstance(semindex, SemIndexConfig):
            semindex = SemanticIndexManager(semindex, path=semindex_path,
                                            device=device)
            self.semindex_path = semindex_path
        elif semindex is None and semindex_path is not None:
            semindex = SemanticIndexManager(path=semindex_path,
                                            device=device)
            self.semindex_path = semindex_path
        self.semindex = semindex or None
        self.cost = CostModel(catalog, default_model=client.default_model,
                              proxy_model=client.proxy_model,
                              embed_model=client.embed_model,
                              defaults=opt_cfg.cost_defaults,
                              stats=self.stats)
        self.cost.semindex = self.semindex
        # unlocks kNN prior transfer: with a semindex attached the cost
        # model can embed predicate prompts through this client
        self.cost.embed_client = client
        self.opt = Optimizer(catalog, cfg=opt_cfg, cost=self.cost,
                             llm_judge=llm_judge)
        self.exec = Executor(catalog, client, cfg=executor, cost=self.cost,
                             stats=self.stats, semindex=self.semindex)
        # keep the planner's TopK pricing on the path the runtime takes
        self.cost.topk_prefilter = self.exec.cfg.topk_prefilter
        # an `Observability` (repro_torch.obs): span tracing for every sql()
        # call plus the metrics registry the executor records into.
        # None (default) keeps the no-op fast path everywhere.
        self.obs = obs
        self.exec.obs = obs
        self.last_report: Optional[QueryReport] = None

    # ------------------------------------------------------------------
    def plan(self, sql: str) -> P.PlanNode:
        """Parse + optimize; returns the plan without executing it."""
        return self.opt.optimize(P.build_plan(sqlparse.parse(sql)))

    def explain(self, sql: str) -> str:
        """Optimized plan + per-node estimated rows + optimizer trace."""
        node = self.plan(sql)
        lines = [node.pretty(annotate=self._annotate_est),
                 f"-- est LLM cost: {self.cost.est_llm_cost(node):.6g} credits"]
        lines += [f"-- {t}" for t in self.opt.trace]
        return "\n".join(lines)

    def _annotate_est(self, node: P.PlanNode) -> str:
        try:
            return f"[est {self.cost.est_rows(node):.0f} rows]"
        except (TypeError, KeyError):
            return ""

    # ------------------------------------------------------------------
    # estimated-vs-actual accounting
    # ------------------------------------------------------------------

    def _collect_estimates(self, node: P.PlanNode) -> List[OperatorReport]:
        """Capture the planner's per-predicate numbers *before* execution
        (a warm store changes these — that is the adaptive loop)."""
        out: List[OperatorReport] = []

        def visit(n: P.PlanNode):
            for c in n.children():
                visit(c)
            if isinstance(n, P.Filter):
                rows = self.cost.est_rows(n.child)
                for p in n.predicates:
                    out.append(self._op_estimate(p, rows))
                    rows *= self.cost.predicate_selectivity(p)
            elif isinstance(n, P.Join) and n.residual:
                pairs = self.cost.est_rows(
                    P.Join(n.left, n.right, n.equi, ()))
                for p in n.residual:
                    out.append(self._op_estimate(p, pairs))
                    pairs *= self.cost.predicate_selectivity(p)
            elif isinstance(n, P.SemanticJoinClassify):
                import math
                l = self.cost.est_rows(n.left)
                r = self.cost.est_rows(n.right)
                calls = l * max(1.0, math.ceil(r / n.max_labels_per_call))
                fake = E.AIClassify(n.prompt, labels=(), model=n.model)
                out.append(self._op_estimate(fake, calls))
            elif isinstance(n, P.SemanticJoinIndex):
                import math
                l = self.cost.est_rows(n.left)
                r = self.cost.est_rows(n.right)
                cand = self.cost.index_candidates_per_probe(n, r)
                calls = l * max(1.0, math.ceil(
                    cand / max(n.max_labels_per_call, 1)))
                out.append(self._op_estimate(
                    self.cost.index_verify_surrogate(n), calls))
            elif isinstance(n, (P.Sort, P.TopK)):
                rows = self.cost.est_rows(n.child)
                cand = (self.cost.topk_candidates(rows, n.n)
                        if isinstance(n, P.TopK) else rows)
                prefilters = (isinstance(n, P.TopK)
                              and self.cost.topk_prefilter_applies(n, rows))
                for i, sk in enumerate(n.keys):
                    if isinstance(sk.expr, E.AISimilarity):
                        # embedding-based: every row embeds once (store
                        # coverage already discounts the warm fraction)
                        out.append(self._op_estimate(
                            self.cost.resolved_similarity(sk.expr), rows))
                        continue
                    if not isinstance(sk.expr, E.AIScore):
                        continue
                    prefilter = prefilters and i == 0
                    if prefilter:
                        # proxy scores the full input, the ordering
                        # model only the escalated candidates
                        out.append(self._op_estimate(
                            self.cost.resolved_score(
                                sk.expr, self.cost.proxy_model), rows))
                        out.append(self._op_estimate(
                            self.cost.resolved_score(sk.expr), cand))
                    else:
                        # without the prefilter every key scores the
                        # full input; with it, secondary keys score
                        # only the escalated candidates
                        out.append(self._op_estimate(
                            self.cost.resolved_score(sk.expr),
                            cand if prefilters else rows))
        visit(node)
        return out

    def _op_estimate(self, pred: E.Expr, rows_in: float) -> OperatorReport:
        lo, hi = self.cost.selectivity_interval(pred)
        return OperatorReport(
            operator=self.exec._pred_key(pred),
            est_rows_in=rows_in,
            est_selectivity=self.cost.predicate_selectivity(pred),
            est_selectivity_ci=(round(lo, 4), round(hi, 4)),
            est_cost_per_row=self.cost.predicate_cost_per_row(pred),
            est_source=self.cost.estimate_source(pred))

    def _fill_actuals(self, ops: List[OperatorReport]) -> None:
        for op in ops:
            st = self.exec.pred_stats.get(op.operator)
            if st is None or not st.evaluated:
                continue
            op.actual_rows_in = st.evaluated
            op.actual_selectivity = st.selectivity
            op.actual_cost_per_row = st.credits / st.evaluated
            op.actual_credits = st.credits

    # ------------------------------------------------------------------
    def sql(self, sql: str, on_batch=None) -> Table:
        """Execute ``sql`` end to end; telemetry lands on
        ``self.last_report`` and feedback in the shared `StatsStore`.
        With ``on_batch`` (a callable taking a `Table`), incremental
        result batches are delivered as the executor produces them —
        the returned table and all telemetry are unchanged."""
        obs = self.obs
        tr = obs.tracer() if obs is not None and obs.enabled else NOOP
        before = self.client.snapshot()
        t0 = time.perf_counter()
        with activate(tr), tr.span("query", kind="query") as qsp:
            with tr.span("parse", kind="parse"):
                ast = P.build_plan(sqlparse.parse(sql))
            with tr.span("optimize", kind="optimize") as osp:
                node = self.opt.optimize(ast)
                if tr.enabled:
                    for line in self.opt.trace:
                        tr.event("optimize.rewrite", decision=line)
                    osp.set(memo_hit=getattr(self.opt, "memo_hit", False),
                            cost_races=getattr(self.opt, "cost_races", 0),
                            rewrites=len(self.opt.trace))
            # estimates are frozen pre-execution so est-vs-actual is
            # honest
            est_cost = self.cost.est_llm_cost(node)
            operators = self._collect_estimates(node)
            with tr.span("execute", kind="execute") as esp:
                try:
                    if on_batch is not None:
                        out = self.exec.execute_stream(node, on_batch)
                    else:
                        out = self.exec.execute(node)
                except Exception:
                    # a failed query must not leave queued requests
                    # behind: a later barrier (possibly another
                    # session's) would dispatch and bill them on behalf
                    # of a query that produced nothing
                    if self.client.pipeline is not None:
                        self.client.cancel_queued()
                    raise
                # drain any still-queued pipeline work
                self.client.flush()
                esp.set(rows_out=out.num_rows)
            delta = self.client.meter_delta(before)
            if tr.enabled:
                qsp.set(rows_out=out.num_rows, ai_calls=delta["ai_calls"],
                        credits=delta["ai_credits"])
        dt = time.perf_counter() - t0
        self._fill_actuals(operators)
        pipe = delta.get("pipeline")
        if pipe and pipe.get("submitted"):
            self.stats.observe_pipeline(submitted=pipe["submitted"],
                                        dedup_hits=pipe["dedup_hits"])
        memo_info = None
        if self.opt.cfg.enable_plan_memo and self.opt.cfg.mode != "none":
            memo_info = {"hit": self.opt.memo_hit,
                         "cost_races": self.opt.cost_races,
                         "entries": len(self.opt.memo)}
        self.last_report = QueryReport(
            sql=sql, plan=node.pretty(), optimizer_trace=list(self.opt.trace),
            est_llm_cost=est_cost, wall_seconds=dt,
            ai_calls=delta["ai_calls"], ai_credits=delta["ai_credits"],
            ai_seconds=delta["ai_seconds"], rows_out=out.num_rows,
            pipeline=pipe, operators=operators,
            reoptimizations=list(self.exec.reoptimizations),
            pilot=self.exec.pilot_telemetry,
            partitions=self.exec.partition_telemetry,
            semindex=self.exec.index_telemetry,
            memo=memo_info,
            trace=tr.to_dict() if tr.enabled else None)
        if self.stats_path is not None:
            self.stats.save(self.stats_path)
        if self.semindex_path is not None and self.semindex is not None:
            self.semindex.save(self.semindex_path)
        return out

    # telemetry passthroughs ------------------------------------------------
    @property
    def pred_stats(self):
        return self.exec.pred_stats

    @property
    def cascades(self):
        return self.exec.cascades
