"""Cost model for AI-aware query optimization (paper §5.1) + learned stats.

The key departure from classical optimizers: the objective is the number /
price of LLM invocations, not join cardinality.  AI-operator selectivity
is unknown at compile time; cost per row is estimable from the average
token length of the referenced columns and the per-model price —
multimodal predicates (FILE args) are priced on the multimodal model tier.

Two estimate sources, consulted in order:

  1. **observed statistics** — when a `StatsStore` is attached and holds
     enough evidence for a predicate's fingerprint (pilot samples or past
     queries), selectivity and cost-per-row come from real executions,
     Bayes-blended with the static prior while the sample is small;
  2. **static defaults** — the classical fallbacks, all named and
     configurable on `CostDefaults` (reachable via
     ``OptimizerConfig.cost_defaults``) instead of inline literals.

Units used throughout this module:

  * **credits** — the paper's §4 billing unit; ``CREDITS_PER_MTOK[model]
    × tokens / 1e6``.  All ``*_cost_per_row`` / ``est_llm_cost`` values.
  * **tokens** — model-input tokens, estimated as ``chars / 4``.
  * **rows** — table cardinalities; ``est_rows`` returns fractional
    expected rows, not integers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from typing import List, Tuple

import numpy as np

from repro_torch.core import expr as E
from repro_torch.core import plan as P
from repro_torch.core.stats import (StatsStore, index_join_fingerprint,
                                    predicate_fingerprint,
                                    predicate_prompt_text, wilson_interval)
from repro_torch.inference.backend import CREDITS_PER_MTOK, EMBED, credits_for
from repro_torch.tables.table import Table

def _expr_name(e: E.Expr) -> str:
    """Column name of an expression side (fingerprint input)."""
    return e.name if isinstance(e, E.Column) else type(e).__name__


@dataclasses.dataclass
class CostDefaults:
    """Named fallback constants for every estimate the model cannot derive
    from catalog statistics or the `StatsStore`.

    Exposed on ``OptimizerConfig.cost_defaults`` so a workload can tune
    the planner's priors without touching code.  Units: selectivities are
    fractions in [0, 1]; ``rel_pred_cost`` is credits per row (kept many
    orders of magnitude below any LLM call); lengths are characters.
    """
    ai_selectivity: float = 0.5        # AI predicate pass rate, unknown a priori
    rel_pred_cost: float = 1e-7        # credits/row of a numpy comparison
    unknown_ndv: int = 100             # NDV of an unknown column
    unknown_avg_chars: float = 64.0    # avg value length of an unknown column
    min_tokens_per_value: float = 2.0  # floor on per-value token estimates
    eq_selectivity: float = 0.1        # "=" with a non-column left side
    inequality_selectivity: float = 1.0 / 3.0   # < <= > >= !=
    between_selectivity: float = 0.25
    in_list_selectivity: float = 0.5   # IN over a non-column expression
    func_selectivity: float = 0.5      # scalar builtins (FL_IS_IMAGE, ...)
    default_selectivity: float = 0.5   # anything else
    labels_per_left_row: float = 1.5   # SemanticJoinClassify fan-out
    # top-k prefilter: candidates escalated to the ordering model are
    # ``ceil(topk_candidate_factor * k)`` of the proxy's best rows
    topk_candidate_factor: float = 3.0
    # semantic index: fraction of a column's rows assumed *already*
    # embedded when the store cannot be consulted (0.0 = price the full
    # cold build; observed store coverage replaces this when available)
    index_coverage_default: float = 0.0
    # -- learned-stats trust policy -----------------------------------
    stats_min_rows: int = 24           # below this, observations are ignored
    stats_prior_strength: float = 16.0  # pseudo-rows backing the static prior
    # -- kNN prior transfer across predicates (cost model v2) ----------
    # a cold fingerprint borrows selectivity / cost-per-row / delegation
    # priors from the nearest *observed* predicates by prompt-embedding
    # similarity; needs a semindex + embed-capable client attached
    enable_stat_transfer: bool = True
    transfer_k: int = 3                # donor neighbours consulted
    transfer_min_sim: float = 0.35     # cosine floor for a donor to count
    # pseudo-row mass a perfect-similarity neighbour contributes; always
    # capped strictly below stats_min_rows, so a transferred prior can
    # never outrank a direct observation of the same size
    transfer_strength: float = 12.0


@dataclasses.dataclass
class TransferredPrior:
    """A cold predicate's estimates borrowed from its nearest observed
    neighbours by prompt-embedding similarity (cost model v2).

    ``n_eff`` is the pseudo-row mass backing the prior — similarity-
    scaled and hard-capped strictly below ``stats_min_rows``, so the
    `CostModel` always blends it toward the static prior and a direct
    observation of equal size always wins.  ``ci`` is a Wilson interval
    at a further similarity-discounted sample size: visibly wider than
    a same-``n`` direct observation's interval.
    """
    selectivity: float
    cost_per_row: float
    delegation_rate: float
    cascade_rows: int                  # donors' total cascaded rows
    n_eff: float                       # pseudo-rows (< stats_min_rows)
    donors: List[Tuple[str, float]]    # (fingerprint, cosine similarity)
    ci: Tuple[float, float]


@dataclasses.dataclass
class TableStats:
    """Per-table catalog statistics: row count, per-column NDV (distinct
    values) and average value length in characters."""
    rows: int
    ndv: Dict[str, int]
    avg_len: Dict[str, float]

    @classmethod
    def of(cls, t: Table) -> "TableStats":
        return cls(rows=t.num_rows,
                   ndv={c: t.ndv(c) for c in t.column_names},
                   avg_len={c: t.avg_len(c) for c in t.column_names})


class UnknownTableError(KeyError):
    """A query referenced a table the `Catalog` does not have.

    A ``KeyError`` subclass so every pre-existing ``except KeyError``
    around catalog lookups still works, but distinct enough that the
    serving layer maps *only* this — not every internal ``KeyError``
    bug — onto its client-side ``unknown_table`` error."""

    def __init__(self, name: str, known: "Dict[str, Table]"):
        super().__init__(name)
        self.table = name
        self.known = sorted(known)

    def __str__(self) -> str:
        return f"unknown table {self.table!r} (catalog has: {self.known})"


class _StatsDict(Dict[str, "TableStats"]):
    """Table-name -> `TableStats` that reports a miss as
    `UnknownTableError` (the first catalog lookup a query plan makes is
    usually ``catalog.stats[...]``, so the miss must carry the same
    client-mappable type as `Catalog.table`)."""

    def __missing__(self, name: str) -> "TableStats":
        raise UnknownTableError(name, self)


@dataclasses.dataclass
class Catalog:
    """The engine's table registry.

    Maps table name -> `Table` and eagerly computes `TableStats` for each
    (``self.stats``); both the optimizer's NDV/length estimates and the
    rewrite oracle's sample-value probes read through here.  Tables added
    after construction are not re-scanned — build a new Catalog instead.
    """
    tables: Dict[str, Table]

    def __post_init__(self):
        self.stats = _StatsDict(
            (k, TableStats.of(v)) for k, v in self.tables.items())

    def table(self, name: str) -> Table:
        """Return the registered `Table`; raises `UnknownTableError`
        (a ``KeyError``) if absent."""
        try:
            return self.tables[name]
        except KeyError:
            raise UnknownTableError(name, self.tables) from None


class CostModel:
    """Estimates rows, per-predicate selectivity/cost, and total LLM spend.

    Args:
        catalog: table registry supplying row counts / NDV / lengths.
        default_model: model priced for AI predicates that name none.
        multimodal_model: model priced for FILE-typed (multimodal) args.
        ai_selectivity_default: legacy override of
            ``defaults.ai_selectivity`` (kept for callers that predate
            `CostDefaults`).
        defaults: the static fallback constants (`CostDefaults`).
        stats: optional `StatsStore`; when set, observed selectivity and
            cost-per-row take precedence over the static defaults as soon
            as a fingerprint accumulates ``defaults.stats_min_rows``
            evaluated rows (blended with the prior below that — see
            `predicate_selectivity`).

    All costs are in **credits**, cardinalities in **rows**, token
    figures in **model-input tokens** (chars / 4).
    """

    def __init__(self, catalog: Catalog, *, default_model: str = "oracle-70b",
                 multimodal_model: str = "qwen2-vl-7b",
                 proxy_model: str = "proxy-8b",
                 embed_model: str = "arctic-embed-m",
                 ai_selectivity_default: Optional[float] = None,
                 defaults: Optional[CostDefaults] = None,
                 stats: Optional[StatsStore] = None):
        self.catalog = catalog
        self.default_model = default_model
        self.multimodal_model = multimodal_model
        self.proxy_model = proxy_model
        self.embed_model = embed_model
        # mirrors ExecConfig.topk_prefilter (the engine syncs it) so
        # TopK estimates price the path the executor will actually take
        self.topk_prefilter = True
        # the engine's SemanticIndexManager when a semantic index is
        # configured (None otherwise): unlocks the index-assisted join
        # race and lets TopK estimates read real store coverage
        self.semindex = None
        # the engine's client (set by `AisqlEngine`): lets the model
        # embed predicate prompts for kNN prior transfer; without it —
        # or without a semindex — transfer is disabled cleanly
        self.embed_client = None
        self.defaults = defaults or CostDefaults()
        if ai_selectivity_default is not None:
            self.defaults = dataclasses.replace(
                self.defaults, ai_selectivity=ai_selectivity_default)
        self.stats = stats
        # alias -> table stats resolved at plan time
        self._alias_stats: Dict[str, TableStats] = {}
        self._alias_tables: Dict[str, str] = {}
        # (model, qualified column) -> content keys, for store-coverage
        # estimates (catalog tables are immutable, so keys never change)
        self._coverage_keys: Dict[tuple, list] = {}
        # fingerprint -> (stats version, TransferredPrior|None): one
        # kNN computation per cold predicate per store state
        self._transfer_cache: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    def bind_alias(self, alias: str, table_name: str) -> None:
        """Associate a query alias with a catalog table's statistics (done
        automatically while walking Scans in `est_rows`)."""
        self._alias_stats[alias] = self.catalog.stats[table_name]
        self._alias_tables[alias] = table_name

    def _col_stats(self, qualified: str):
        alias, _, col = qualified.partition(".")
        st = self._alias_stats.get(alias)
        if st is None or col not in st.ndv:
            # unqualified or unknown: search all
            for st2 in self._alias_stats.values():
                if qualified in st2.ndv:
                    return st2, qualified
            return None, col
        return st, col

    def ndv(self, qualified: str) -> int:
        """Number of distinct values of an (alias-qualified) column;
        ``defaults.unknown_ndv`` when the column cannot be resolved."""
        st, col = self._col_stats(qualified)
        return st.ndv.get(col, self.defaults.unknown_ndv) if st \
            else self.defaults.unknown_ndv

    def avg_tokens(self, qualified: str) -> float:
        """Average per-value token count of a column (chars / 4, floored
        at ``defaults.min_tokens_per_value``)."""
        st, col = self._col_stats(qualified)
        chars = st.avg_len.get(col, self.defaults.unknown_avg_chars) if st \
            else self.defaults.unknown_avg_chars
        return max(chars / 4.0, self.defaults.min_tokens_per_value)

    # ------------------------------------------------------------------
    # observed-stats plumbing
    # ------------------------------------------------------------------

    def observed(self, pred: E.Expr):
        """The predicate's `PredObservation`, or None without a store."""
        if self.stats is None:
            return None
        return self.stats.get(predicate_fingerprint(pred))

    def _blend(self, observed: float, n_obs: float, prior: float) -> float:
        """Bayes-style shrinkage: observed mean backed by ``n_obs`` rows
        against a prior worth ``stats_prior_strength`` pseudo-rows."""
        n0 = self.defaults.stats_prior_strength
        return (observed * n_obs + prior * n0) / (n_obs + n0)

    # ------------------------------------------------------------------
    # kNN prior transfer (cost model v2)
    # ------------------------------------------------------------------

    def transferred_prior(self, pred: E.Expr
                          ) -> Optional[TransferredPrior]:
        """Borrowed estimates for a *cold* predicate from the k nearest
        observed predicates by prompt-embedding similarity.

        Requires the full transfer stack — a `StatsStore` with observed
        donors that registered prompt texts, a `SemanticIndexManager`
        (embedding store + top-k kernel) and an embed-capable client;
        with any piece missing (or ``enable_stat_transfer`` off) returns
        None and every estimate falls back to the static defaults, so
        transfer is an overlay, never a dependency.  Results are cached
        per (fingerprint, store version): re-planning is a dict lookup
        until new evidence lands.
        """
        d = self.defaults
        if not (d.enable_stat_transfer and self.stats is not None
                and self.semindex is not None
                and self.embed_client is not None):
            return None
        if not isinstance(pred, (E.AIFilter, E.AIScore, E.AIClassify)):
            return None
        text = predicate_prompt_text(pred)
        if not text:
            return None
        fp = predicate_fingerprint(pred)
        version = getattr(self.stats, "version", 0)
        cached = self._transfer_cache.get(fp)
        if cached is not None and cached[0] == version:
            return cached[1]
        prior = self._compute_transfer(fp, text)
        self._transfer_cache[fp] = (version, prior)
        return prior

    def _compute_transfer(self, fp: str, text: str
                          ) -> Optional[TransferredPrior]:
        d = self.defaults
        donors = []
        for key, obs in self.stats.items():
            if key == fp or obs.evaluated < d.stats_min_rows:
                continue
            donor_text = self.stats.prompt_text(key)
            if donor_text:
                donors.append((key, donor_text, obs))
        if not donors:
            return None
        vecs = self.semindex.embed_texts(
            self.embed_client, [text] + [t for _, t, _ in donors])
        k = min(d.transfer_k, len(donors))
        sims, idx = self.semindex.topk_candidates(vecs[:1], vecs[1:], k)
        pairs = [(float(s), int(i))
                 for s, i in zip(np.ravel(sims)[:k], np.ravel(idx)[:k])
                 if int(i) >= 0 and float(s) >= d.transfer_min_sim]
        if not pairs:
            return None
        wsum = sum(s for s, _ in pairs)
        sel = sum(s * donors[i][2].selectivity for s, i in pairs) / wsum
        cpr = sum(s * donors[i][2].cost_per_row for s, i in pairs) / wsum
        dele = sum(s * donors[i][2].delegation_rate
                   for s, i in pairs) / wsum
        top_sim = max(s for s, _ in pairs)
        # pseudo-rows: similarity-scaled, hard-capped strictly below the
        # direct-observation trust threshold
        n_eff = max(1.0, min(d.stats_min_rows - 1.0,
                             d.transfer_strength * top_sim))
        # the CI discounts the sample a second time by similarity —
        # transferred evidence at n rows must read wider than a direct
        # observation at n rows
        n_ci = max(1, int(n_eff * top_sim))
        ci = wilson_interval(int(round(sel * n_ci)), n_ci)
        return TransferredPrior(
            selectivity=sel, cost_per_row=cpr, delegation_rate=dele,
            cascade_rows=sum(donors[i][2].cascade_rows for _, i in pairs),
            n_eff=n_eff, donors=[(donors[i][0], s) for s, i in pairs],
            ci=(round(ci[0], 4), round(ci[1], 4)))

    def estimate_source(self, pred: E.Expr) -> str:
        """Provenance of this predicate's estimates: ``"observed"``
        (store is confident), ``"blended"`` (some evidence, shrunk toward
        the prior), ``"transferred"`` (no direct evidence — priors
        borrowed from the nearest observed predicates, or a cross-tenant
        shared-pool view) or ``"default"`` (static fallback only)."""
        if not isinstance(pred, (E.AIFilter, E.AIScore, E.AIClassify,
                                 E.AISimilarity, E.AIEmbed)):
            return "default"
        obs = self.observed(pred)
        if obs is None or not obs.evaluated:
            if self.transferred_prior(pred) is not None:
                return "transferred"
            return "default"
        if getattr(obs, "shared_prior", False):
            return "transferred"
        if obs.evaluated >= self.defaults.stats_min_rows:
            return "observed"
        return "blended"

    # ------------------------------------------------------------------
    # per-predicate estimates
    # ------------------------------------------------------------------

    def predicate_cost_per_row(self, pred: E.Expr) -> float:
        """Credits per evaluated row.

        AI predicates: observed credits/row from the `StatsStore` when
        available (prior-blended below ``stats_min_rows``), else the
        static token estimate ``price(model) × (template + arg tokens)``.
        Non-AI predicates: ``defaults.rel_pred_cost``.
        """
        if isinstance(pred, (E.AIFilter, E.AIScore, E.AIClassify,
                             E.AISimilarity, E.AIEmbed)):
            static = self._static_ai_cost_per_row(pred)
            obs = self.observed(pred)
            if obs is not None and obs.evaluated:
                if (obs.evaluated >= self.defaults.stats_min_rows
                        and not getattr(obs, "shared_prior", False)):
                    return obs.cost_per_row
                # shared-pool views and small samples stay prior-blended:
                # borrowed evidence must read less confident than own
                return self._blend(obs.cost_per_row, obs.evaluated, static)
            tp = self.transferred_prior(pred)
            if tp is not None:
                return self._blend(tp.cost_per_row, tp.n_eff, static)
            return static
        # comparisons over AI_SIMILARITY (e.g. ``AI_SIMILARITY(a,b) >
        # 0.8``) cost their embedded sides per row, not a numpy compare
        inner = [c for c in E.ai_calls_in(pred)
                 if isinstance(c, (E.AISimilarity, E.AIEmbed))]
        if inner:
            return sum(self._static_ai_cost_per_row(c) for c in inner)
        return self.defaults.rel_pred_cost

    def _embed_side_cost(self, side: E.Expr, coverage: float = 0.0,
                         model: Optional[str] = None) -> float:
        """Credits to embed one row of ``side`` on the embedding tier.
        Literals embed once per query — per-row that amortizes to ~0."""
        if not side.refs():
            return 0.0
        toks = sum(self.avg_tokens(r) for r in side.refs())
        return credits_for(model or self.embed_model, 1, EMBED) * toks \
            * (1.0 - coverage)

    def _column_values(self, qualified: str):
        """Raw values of an alias-qualified column, or None."""
        alias, _, col = qualified.partition(".")
        tname = self._alias_tables.get(alias)
        if tname is None:
            return None
        t = self.catalog.tables.get(tname)
        if t is None:
            return None
        name = col if col in t else (qualified if qualified in t else None)
        return t.column(name) if name else None

    def embed_coverage(self, side: E.Expr,
                       model: Optional[str] = None) -> float:
        """Fraction of ``side``'s values already in the embedding store
        (real coverage when a `SemanticIndexManager` is attached and the
        side is one resolvable column; the static default otherwise) —
        this is how a warm store makes index-assisted plans cheap at
        plan time, not just at run time.

        The column's content keys are computed once per (model, column)
        and cached for the engine's lifetime (catalog tables are
        immutable), so repeated plan-time coverage checks are dict
        lookups, not re-hashes of the whole column.
        """
        d = self.defaults.index_coverage_default
        if self.semindex is None:
            return d
        refs = side.refs()
        if len(refs) != 1:
            return d
        qualified = next(iter(refs))
        model = model or self.semindex.cfg.model or self.embed_model
        dim = self.semindex.cfg.dim
        # cache under the *resolved table*, not the query alias — the
        # same alias letter binds to different tables across queries on
        # one long-lived cost model
        alias, _, leaf = qualified.partition(".")
        tname = self._alias_tables.get(alias)
        cache_key = ((model, dim, f"{tname}.{leaf or qualified}")
                     if tname else None)
        keys = self._coverage_keys.get(cache_key) if cache_key else None
        if keys is None:
            vals = self._column_values(qualified)
            if vals is None:
                return d
            from repro_torch.semindex.store import content_key
            keys = [content_key(model, str(v), dim) for v in vals]
            if cache_key:
                self._coverage_keys[cache_key] = keys
        if not keys:
            return d
        store = self.semindex.store
        return sum(k in store for k in keys) / len(keys)

    def _embed_model_of(self, pred: E.Expr) -> str:
        """The embedding model an AI_EMBED / AI_SIMILARITY will actually
        use: an explicit ``model =>`` wins over the default tier."""
        return getattr(pred, "model", None) or self.embed_model

    def _static_ai_cost_per_row(self, pred: E.Expr) -> float:
        if isinstance(pred, E.AIEmbed):
            m = self._embed_model_of(pred)
            return self._embed_side_cost(
                pred.arg, self.embed_coverage(pred.arg, m), m)
        if isinstance(pred, E.AISimilarity):
            m = self._embed_model_of(pred)
            return (self._embed_side_cost(
                        pred.left, self.embed_coverage(pred.left, m), m)
                    + self._embed_side_cost(
                        pred.right, self.embed_coverage(pred.right, m), m))
        if isinstance(pred, (E.AIFilter, E.AIScore)):
            model = pred.model or (
                self.multimodal_model
                if isinstance(pred, E.AIFilter) and pred.multimodal
                else self.default_model)
            toks = len(pred.prompt.template) / 4.0 + sum(
                self.avg_tokens(r) for r in pred.refs())
            return CREDITS_PER_MTOK.get(model, 0.5) * toks / 1e6
        model = pred.model or self.default_model
        toks = sum(self.avg_tokens(r) for r in pred.refs()) + \
            4.0 * max(len(pred.labels), 4)
        return CREDITS_PER_MTOK.get(model, 0.5) * toks / 1e6

    def predicate_selectivity(self, pred: E.Expr) -> float:
        """Expected pass fraction of the predicate, in [0, 1].

        AI predicates consult the `StatsStore` first: with at least
        ``defaults.stats_min_rows`` observed rows the observed pass rate
        is returned as-is; with fewer it is shrunk toward the static
        prior (``defaults.ai_selectivity``) by ``stats_prior_strength``
        pseudo-rows; with none the prior is returned — so a cold-start
        plan is exactly the static plan.  Relational predicates use the
        classical NDV-based rules with `CostDefaults` fallbacks.
        """
        d = self.defaults
        if isinstance(pred, (E.AIScore, E.AISimilarity, E.AIEmbed)):
            return 1.0                 # value-producing, never filters rows
        if isinstance(pred, (E.AIFilter, E.AIClassify)):
            obs = self.observed(pred)
            if obs is not None and obs.evaluated:
                if (obs.evaluated >= d.stats_min_rows
                        and not getattr(obs, "shared_prior", False)):
                    return obs.selectivity
                return self._blend(obs.selectivity, obs.evaluated,
                                   d.ai_selectivity)
            tp = self.transferred_prior(pred)
            if tp is not None:
                return self._blend(tp.selectivity, tp.n_eff,
                                   d.ai_selectivity)
            return d.ai_selectivity
        if isinstance(pred, E.InList):
            if isinstance(pred.expr, E.Column):
                nd = self.ndv(pred.expr.name)
                return min(1.0, len(pred.values) / max(nd, 1))
            return d.in_list_selectivity
        if isinstance(pred, E.Between):
            return d.between_selectivity
        if isinstance(pred, E.BinOp):
            if pred.op == "=":
                lc = pred.left if isinstance(pred.left, E.Column) else None
                if lc is not None:
                    return 1.0 / max(self.ndv(lc.name), 1)
                return d.eq_selectivity
            return d.inequality_selectivity
        if isinstance(pred, E.Not):
            return 1.0 - self.predicate_selectivity(pred.arg)
        if isinstance(pred, E.BoolOp):
            sels = [self.predicate_selectivity(a) for a in pred.args]
            if pred.op == "and":
                out = 1.0
                for s in sels:
                    out *= s
            else:
                inv = 1.0
                for s in sels:
                    inv *= (1.0 - s)
                out = 1.0 - inv
            return out
        if isinstance(pred, E.FuncCall):
            return d.func_selectivity
        return d.default_selectivity

    def predicate_rank(self, pred: E.Expr) -> float:
        """Hellerstein expensive-predicate rank: ``cost_per_row / (1 -
        selectivity)`` in credits — evaluation order ascending by rank
        minimises expected filter cost.  Uses observed stats when the
        store has them (same precedence as the underlying estimates)."""
        c = self.predicate_cost_per_row(pred)
        s = self.predicate_selectivity(pred)
        return c / max(1.0 - s, 1e-9)

    def selectivity_interval(self, pred: E.Expr):
        """``(lo, hi)`` Wilson confidence interval on an AI predicate's
        selectivity: from observed evidence when the store has any, from
        the (similarity-widened) transferred prior for a cold predicate
        with usable neighbours, and ``(0.0, 1.0)`` — maximum uncertainty
        — for a true cold start."""
        if not isinstance(pred, (E.AIFilter, E.AIClassify)):
            return 0.0, 1.0
        obs = self.observed(pred)
        if obs is None or not obs.evaluated:
            tp = self.transferred_prior(pred)
            if tp is not None:
                return tp.ci
            return 0.0, 1.0
        return obs.selectivity_ci()

    # ------------------------------------------------------------------
    # plan-level cardinality & LLM-cost estimation
    # ------------------------------------------------------------------

    def est_rows(self, node: P.PlanNode) -> float:
        """Expected output cardinality of a plan subtree, in rows.

        Walking Scans binds aliases to table stats as a side effect, so
        call this on the root before per-predicate estimates.
        """
        if isinstance(node, P.Scan):
            self.bind_alias(node.alias, node.table)
            return float(self.catalog.stats[node.table].rows)
        if isinstance(node, P.Filter):
            r = self.est_rows(node.child)
            for p in node.predicates:
                r *= self.predicate_selectivity(p)
            return r
        if isinstance(node, P.Join):
            l = self.est_rows(node.left)
            r = self.est_rows(node.right)
            if node.equi:
                lk, rk = node.equi[0]
                denom = max(self.ndv(lk), self.ndv(rk), 1)
                out = l * r / denom
            else:
                out = l * r
            for p in node.residual:
                out *= self.predicate_selectivity(p)
            return out
        if isinstance(node, (P.SemanticJoinClassify, P.SemanticJoinIndex)):
            l = self.est_rows(node.left)
            return l * self.defaults.labels_per_left_row
        if isinstance(node, P.TopK):
            return min(self.est_rows(node.child), float(node.n))
        if isinstance(node, (P.Project, P.Aggregate, P.Limit, P.Sort)):
            r = self.est_rows(node.children()[0])
            if isinstance(node, P.Aggregate) and node.group_by:
                return min(r, self.ndv(node.group_by[0]))
            if isinstance(node, P.Limit):
                return min(r, node.n)
            return r
        raise TypeError(node)

    def est_llm_cost(self, node: P.PlanNode) -> float:
        """Total expected LLM **credits** of the plan — the §5.1 objective
        every optimizer rewrite minimises."""
        total = 0.0
        if isinstance(node, P.Filter):
            rows = self.est_rows(node.child)
            for p in node.predicates:
                total += rows * self.predicate_cost_per_row(p)
                rows *= self.predicate_selectivity(p)
        if isinstance(node, P.Join):
            l = self.est_rows(node.left)
            r = self.est_rows(node.right)
            pairs = l * r if not node.equi else self.est_rows(
                P.Join(node.left, node.right, node.equi, ()))
            for p in node.residual:
                total += pairs * self.predicate_cost_per_row(p)
                pairs *= self.predicate_selectivity(p)
        if isinstance(node, P.SemanticJoinClassify):
            l = self.est_rows(node.left)
            r = self.est_rows(node.right)
            calls_per_row = max(1.0, math.ceil(r / node.max_labels_per_call))
            labels_per_call = min(r, float(node.max_labels_per_call))
            # the same surrogate the executor records observations under,
            # so cross-query feedback reaches the rewrite decision; the
            # static fallback prices the real per-call context — left
            # text plus a full label chunk — so the three-way race with
            # the index plan compares like with like
            fake = E.AIClassify(node.prompt, labels=(), model=node.model)
            obs = self.observed(fake)
            static = self._verify_call_cost(node, labels_per_call)
            if obs is not None and obs.evaluated:
                if obs.evaluated >= self.defaults.stats_min_rows:
                    per_call = obs.cost_per_row
                else:
                    per_call = self._blend(obs.cost_per_row, obs.evaluated,
                                           static)
            else:
                per_call = static
            total += l * calls_per_row * per_call
        if isinstance(node, P.SemanticJoinIndex):
            total += self._index_join_cost(node)
        if isinstance(node, P.Sort):
            rows = self.est_rows(node.child)
            for sk in node.keys:
                if isinstance(sk.expr, E.AIScore):
                    total += rows * self.predicate_cost_per_row(
                        self.resolved_score(sk.expr))
                elif isinstance(sk.expr, E.AISimilarity):
                    total += rows * self.predicate_cost_per_row(
                        self.resolved_similarity(sk.expr))
        if isinstance(node, P.TopK):
            rows = self.est_rows(node.child)
            cand = self.topk_candidates(rows, node.n)
            prefilter = self.topk_prefilter_applies(node, rows)
            for i, sk in enumerate(node.keys):
                if isinstance(sk.expr, E.AISimilarity):
                    # embedding-based: every distinct row text embeds
                    # once regardless of pruning (the index saves the
                    # *re*-embeds, which coverage already discounts)
                    total += rows * self.predicate_cost_per_row(
                        self.resolved_similarity(sk.expr))
                    continue
                if not isinstance(sk.expr, E.AIScore):
                    continue
                if prefilter and i == 0:
                    # proxy scores the full input; only the candidates
                    # are escalated to the ordering model
                    total += rows * self.predicate_cost_per_row(
                        self.resolved_score(sk.expr, self.proxy_model))
                    total += cand * self.predicate_cost_per_row(
                        self.resolved_score(sk.expr))
                else:
                    scored = cand if prefilter else rows
                    total += scored * self.predicate_cost_per_row(
                        self.resolved_score(sk.expr))
        for c in node.children():
            total += self.est_llm_cost(c)
        return total

    # ------------------------------------------------------------------
    # semantic ORDER BY helpers
    # ------------------------------------------------------------------

    def resolved_score(self, pred: E.AIScore,
                       model: Optional[str] = None) -> E.AIScore:
        """The surrogate the executor records observations under: an
        `E.AIScore` with its model made explicit (the fingerprint keeps
        proxy-prefilter and oracle scores as distinct populations)."""
        return E.AIScore(pred.prompt,
                         model=model or pred.model or self.default_model)

    def resolved_similarity(self, pred: E.AISimilarity) -> E.AISimilarity:
        """`E.AISimilarity` with the embedding model made explicit —
        the surrogate both pricing and executor telemetry key on."""
        return E.AISimilarity(pred.left, pred.right,
                              model=pred.model or self.embed_model)

    # ------------------------------------------------------------------
    # index-assisted semantic join pricing
    # ------------------------------------------------------------------

    def index_candidates_per_probe(self, node: P.SemanticJoinIndex,
                                   right_rows: float) -> float:
        """Learned mean kNN candidates per probe row for this blocking
        site (`StatsStore.observe_index` feedback); static default is
        the configured ``k``."""
        obs = None
        if self.stats is not None:
            obs = self.stats.get(index_join_fingerprint(
                node.prompt.template, node.model,
                _expr_name(node.left_arg), node.label_col))
        cand = (obs.candidates_per_probe
                if obs is not None and obs.index_probes else float(node.k))
        return min(cand, right_rows) if right_rows else cand

    def index_verify_surrogate(self, node) -> E.AIClassify:
        """The surrogate `E.AIClassify` the executor records the index
        join's verification calls under — labels ``("__index__",)`` keep
        it a distinct fingerprint from the full rewrite's surrogate (the
        two have very different per-call token counts)."""
        return E.AIClassify(node.prompt, labels=("__index__",),
                            model=node.model)

    def _index_join_cost(self, node: P.SemanticJoinIndex) -> float:
        """Expected credits of index-assisted blocking: embed both sides
        (store coverage discounts), then one multi-label verification
        call per left row over ~candidates_per_probe labels."""
        l = self.est_rows(node.left)
        r = self.est_rows(node.right)
        label_side = E.Column(node.label_col)
        emb = (l * self._embed_side_cost(node.left_arg,
                                         self.embed_coverage(node.left_arg))
               + r * self._embed_side_cost(label_side,
                                           self.embed_coverage(label_side)))
        cand = self.index_candidates_per_probe(node, r)
        calls_per_row = max(1.0, math.ceil(
            cand / max(node.max_labels_per_call, 1)))
        fake = self.index_verify_surrogate(node)
        obs = self.observed(fake)
        static = self._verify_call_cost(node, cand)
        if obs is not None and obs.evaluated:
            if obs.evaluated >= self.defaults.stats_min_rows:
                per_call = obs.cost_per_row
            else:
                per_call = self._blend(obs.cost_per_row, obs.evaluated,
                                       static)
        else:
            per_call = static
        return emb + l * calls_per_row * per_call

    def _verify_call_cost(self, node, labels_in_call: float) -> float:
        """Static per-call price of one multi-label verification call
        (classify rewrite or index blocking): the left text plus
        ``labels_in_call`` candidate labels in the context."""
        model = node.model or self.default_model
        label_toks = max(self.avg_tokens(node.label_col), 2.0) + 2.0
        toks = (len(node.prompt.template) / 4.0
                + sum(self.avg_tokens(rf) for rf in node.left_arg.refs())
                + labels_in_call * label_toks)
        return CREDITS_PER_MTOK.get(model, 0.5) * toks / 1e6

    def topk_candidates(self, rows: float, n: int) -> float:
        """Rows escalated to the ordering model by the top-k prefilter."""
        return min(rows, float(max(
            n, math.ceil(self.defaults.topk_candidate_factor * n))))

    def topk_prefilter_applies(self, node: P.TopK, rows: float) -> bool:
        """Whether the executor's proxy prefilter would run for this
        TopK: enabled, AI-scored primary key, a proxy distinct from the
        ordering model, and fewer candidates than input rows."""
        if not (self.topk_prefilter and node.keys
                and isinstance(node.keys[0].expr, E.AIScore)):
            return False
        oracle = node.keys[0].expr.model or self.default_model
        return (oracle != self.proxy_model
                and self.topk_candidates(rows, node.n) < rows)
