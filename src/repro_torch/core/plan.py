"""Logical query plan for AISQL.

Plan nodes are immutable; the optimizer rewrites trees.  ``build_plan``
translates a parsed Query into an initial (unoptimized) plan:
scans -> left-deep join tree -> WHERE filter -> aggregate/project -> limit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set, Tuple

from repro_torch.core import expr as E
from repro_torch.core.sqlparse import Query


class PlanNode:
    def children(self) -> Tuple["PlanNode", ...]:
        return ()

    def out_aliases(self) -> Set[str]:
        out: Set[str] = set()
        for c in self.children():
            out |= c.out_aliases()
        return out

    def pretty(self, indent: int = 0, annotate=None) -> str:
        """Indented tree rendering.  ``annotate(node) -> str`` (optional)
        appends a per-node suffix — EXPLAIN ANALYZE uses it to attach
        estimated-vs-actual rows/cost to each operator."""
        pad = "  " * indent
        line = pad + self._describe()
        if annotate is not None:
            suffix = annotate(self)
            if suffix:
                line += f"  {suffix}"
        return "\n".join([line] + [c.pretty(indent + 1, annotate)
                                   for c in self.children()])

    def _describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Scan(PlanNode):
    table: str
    alias: str

    def out_aliases(self):
        return {self.alias}

    def _describe(self):
        return f"Scan {self.table} AS {self.alias}"


@dataclasses.dataclass(frozen=True)
class Filter(PlanNode):
    child: PlanNode
    predicates: Tuple[E.Expr, ...]     # conjuncts, evaluation order = tuple order

    def children(self):
        return (self.child,)

    def _describe(self):
        kinds = ["AI" if p.is_ai() else "rel" for p in self.predicates]
        return f"Filter [{', '.join(kinds)}] ({len(self.predicates)} conjuncts)"


@dataclasses.dataclass(frozen=True)
class Join(PlanNode):
    left: PlanNode
    right: PlanNode
    equi: Tuple[Tuple[str, str], ...]          # (left_col, right_col)
    residual: Tuple[E.Expr, ...] = ()          # non-equi ON conjuncts (may be AI)

    def children(self):
        return (self.left, self.right)

    def _describe(self):
        r = f" residual={len(self.residual)}" if self.residual else ""
        return f"Join equi={list(self.equi)}{r}"


@dataclasses.dataclass(frozen=True)
class SemanticJoinClassify(PlanNode):
    """§5.3 rewrite: AI_FILTER cross join -> per-left-row multi-label
    AI_CLASSIFY with the right side's label column as candidate set."""
    left: PlanNode
    right: PlanNode
    prompt: E.Prompt                 # original two-side predicate prompt
    left_arg: E.Expr                 # the left-side text expression
    label_col: str                   # right-side column holding labels
    model: Optional[str] = None
    max_labels_per_call: int = 50    # context-window chunking

    def children(self):
        return (self.left, self.right)

    def _describe(self):
        return (f"SemanticJoinClassify labels={self.label_col} "
                f"chunk={self.max_labels_per_call}")


@dataclasses.dataclass(frozen=True)
class SemanticJoinIndex(PlanNode):
    """Index-assisted semantic-join blocking (the tier below §5.3's
    classification rewrite): kNN candidate generation on the vector
    index narrows each left row to ``k`` plausible labels for near-zero
    credits, and the LLM verifies only those candidates — one
    multi-label AI_CLASSIFY per left row over a candidate set that is
    k/|R| of the full label universe.  Cost-raced by the optimizer
    against `SemanticJoinClassify` and the naive nested loop."""
    left: PlanNode
    right: PlanNode
    prompt: E.Prompt                 # original two-side predicate prompt
    left_arg: E.Expr                 # the left-side text expression
    label_col: str                   # right-side column holding labels
    model: Optional[str] = None
    k: int = 8                       # kNN candidates per left row
    max_labels_per_call: int = 50    # context-window chunking

    def children(self):
        return (self.left, self.right)

    def _describe(self):
        return (f"SemanticJoinIndex labels={self.label_col} k={self.k}")


@dataclasses.dataclass(frozen=True)
class Project(PlanNode):
    child: PlanNode
    items: Tuple[E.SelectItem, ...]

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Project ({len(self.items)} items)"


@dataclasses.dataclass(frozen=True)
class Aggregate(PlanNode):
    child: PlanNode
    group_by: Tuple[str, ...]
    items: Tuple[E.SelectItem, ...]

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Aggregate by {list(self.group_by)}"


@dataclasses.dataclass(frozen=True)
class SortKey:
    """One ORDER BY key; ``expr`` may be a structured expression or an
    `E.AIScore` (semantic ordering via the SCORE request kind)."""
    expr: E.Expr
    desc: bool = False


@dataclasses.dataclass(frozen=True)
class Sort(PlanNode):
    child: PlanNode
    keys: Tuple[SortKey, ...]

    def children(self):
        return (self.child,)

    def _describe(self):
        kinds = ["AI" if isinstance(k.expr, (E.AIScore, E.AISimilarity))
                 else "rel" for k in self.keys]
        dirs = ["DESC" if k.desc else "ASC" for k in self.keys]
        return ("Sort [" + ", ".join(f"{k} {d}"
                                     for k, d in zip(kinds, dirs)) + "]")


@dataclasses.dataclass(frozen=True)
class TopK(PlanNode):
    """Fused ORDER BY + LIMIT (optimizer rewrite of ``Limit(Sort(...))``
    with an AI-scored primary key): the executor may prefilter with
    cheap proxy scores and escalate only the top candidates to the
    ordering model — the early-exit path for top-k search workloads."""
    child: PlanNode
    keys: Tuple[SortKey, ...]
    n: int

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"TopK {self.n} ({len(self.keys)} keys)"


@dataclasses.dataclass(frozen=True)
class Limit(PlanNode):
    child: PlanNode
    n: int

    def children(self):
        return (self.child,)

    def _describe(self):
        return f"Limit {self.n}"


# ---------------------------------------------------------------------------
# Query -> initial plan
# ---------------------------------------------------------------------------


def _alias_of(name: str) -> str:
    return name.split(".", 1)[0] if "." in name else ""


def refs_aliases(e: E.Expr) -> Set[str]:
    return {_alias_of(r) for r in e.refs() if _alias_of(r)}


def _classify_on_conjunct(c: E.Expr, left_aliases: Set[str],
                          right_alias: str):
    """-> ("equi", (lcol, rcol)) | ("residual", expr) | ("left"/"right", expr)."""
    if (isinstance(c, E.BinOp) and c.op == "="
            and isinstance(c.left, E.Column) and isinstance(c.right, E.Column)):
        la, ra = _alias_of(c.left.name), _alias_of(c.right.name)
        if la in left_aliases and ra == right_alias:
            return "equi", (c.left.name, c.right.name)
        if ra in left_aliases and la == right_alias:
            return "equi", (c.right.name, c.left.name)
    al = refs_aliases(c)
    if al and al <= left_aliases:
        return "left", c
    if al == {right_alias}:
        return "right", c
    return "residual", c


def build_plan(q: Query) -> PlanNode:
    node: PlanNode = Scan(q.table.table, q.table.alias)
    left_aliases = {q.table.alias}
    for jc in q.joins:
        right: PlanNode = Scan(jc.ref.table, jc.ref.alias)
        equi, residual, lpreds, rpreds = [], [], [], []
        for c in E.split_conjuncts(jc.on):
            kind, payload = _classify_on_conjunct(c, left_aliases,
                                                  jc.ref.alias)
            if kind == "equi":
                equi.append(payload)
            elif kind == "left":
                lpreds.append(payload)
            elif kind == "right":
                rpreds.append(payload)
            else:
                residual.append(payload)
        if lpreds:
            node = Filter(node, tuple(lpreds))
        if rpreds:
            right = Filter(right, tuple(rpreds))
        node = Join(node, right, tuple(equi), tuple(residual))
        left_aliases.add(jc.ref.alias)
    if q.where is not None:
        node = Filter(node, tuple(E.split_conjuncts(q.where)))
    has_agg = bool(q.group_by) or any(
        isinstance(it.expr, E.AggCall) for it in q.select)
    if has_agg:
        node = Aggregate(node, tuple(q.group_by), tuple(q.select))
        # ORDER BY above the aggregate: keys reference output columns
        # (aliases, agg names) of the aggregate itself
        if q.order_by:
            node = Sort(node, tuple(SortKey(o.expr, o.desc)
                                    for o in q.order_by))
    else:
        # ORDER BY below the projection so keys can reference base
        # columns the SELECT list drops; keys naming a select alias are
        # substituted with the aliased expression first
        if q.order_by:
            node = Sort(node, tuple(
                SortKey(_substitute_alias(o.expr, q.select), o.desc)
                for o in q.order_by))
        node = Project(node, tuple(q.select))
    if q.limit is not None:
        node = Limit(node, q.limit)
    return node


def _substitute_alias(e: E.Expr, items: Sequence[E.SelectItem]) -> E.Expr:
    """ORDER BY <select-alias> names the aliased expression."""
    if isinstance(e, E.Column):
        for it in items:
            if it.alias is not None and it.alias == e.name:
                return it.expr
    return e
