"""Expression AST for the AISQL dialect (paper §3).

Relational scalar expressions evaluate vectorised over a Table; the AI
operators (AI_FILTER / AI_CLASSIFY / AI_COMPLETE) are *not* evaluated here —
the executor owns them (batching, cascades, cost metering).  This module
only provides structure, column-reference analysis and prompt rendering.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.tables.table import FileRef, Table, fl_is_audio, fl_is_image


class Expr:
    def refs(self) -> Set[str]:
        raise NotImplementedError

    def is_ai(self) -> bool:
        return bool(ai_calls_in(self))


@dataclasses.dataclass(frozen=True)
class Column(Expr):
    name: str                      # possibly qualified: "p.abstract"

    def refs(self):
        return {self.name}


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: Any

    def refs(self):
        return set()


@dataclasses.dataclass(frozen=True)
class Star(Expr):
    def refs(self):
        return set()


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str                        # = != < <= > >= + - * /
    left: Expr
    right: Expr

    def refs(self):
        return self.left.refs() | self.right.refs()


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    lo: Expr
    hi: Expr

    def refs(self):
        return self.expr.refs() | self.lo.refs() | self.hi.refs()


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    values: Tuple[Any, ...]

    def refs(self):
        return self.expr.refs()


@dataclasses.dataclass(frozen=True)
class BoolOp(Expr):
    op: str                        # "and" | "or"
    args: Tuple[Expr, ...]

    def refs(self):
        out: Set[str] = set()
        for a in self.args:
            out |= a.refs()
        return out


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    arg: Expr

    def refs(self):
        return self.arg.refs()


@dataclasses.dataclass(frozen=True)
class FuncCall(Expr):
    """Scalar builtin (FL_IS_IMAGE, FL_IS_AUDIO, LENGTH, ...)."""
    name: str
    args: Tuple[Expr, ...]

    def refs(self):
        out: Set[str] = set()
        for a in self.args:
            out |= a.refs()
        return out


@dataclasses.dataclass(frozen=True)
class Prompt(Expr):
    """PROMPT('template with {0} {1}', arg0, arg1) — §3.1/3.3."""
    template: str
    args: Tuple[Expr, ...]

    def refs(self):
        out: Set[str] = set()
        for a in self.args:
            out |= a.refs()
        return out

    def render(self, table: Table, rows: Optional[np.ndarray] = None
               ) -> List[str]:
        cols = [eval_expr(a, table, rows) for a in self.args]
        n = len(cols[0]) if cols else (
            len(rows) if rows is not None else table.num_rows)
        out = []
        for i in range(n):
            vals = [c[i] for c in cols]
            out.append(self.template.format(*vals))
        return out


@dataclasses.dataclass(frozen=True)
class AIFilter(Expr):
    """AI_FILTER(PROMPT(...)) or AI_FILTER('predicate', col) — §3.2."""
    prompt: Prompt
    model: Optional[str] = None

    def refs(self):
        return self.prompt.refs()

    @property
    def multimodal(self) -> bool:
        # heuristic mirror of the compiler: FILE-typed args => multimodal
        return any(isinstance(a, FuncCall) and a.name.startswith("FL_")
                   for a in self.prompt.args)


@dataclasses.dataclass(frozen=True)
class AIScore(Expr):
    """AI_SCORE(PROMPT(...)) — the model's confidence in [0, 1] that the
    prompt's statement holds for the row.  The semantic ORDER BY key:
    ``ORDER BY AI_SCORE(...) DESC LIMIT k`` is the paper's top-k search
    workload.  Reuses the SCORE request kind of AI_FILTER but returns the
    raw score instead of thresholding it."""
    prompt: Prompt
    model: Optional[str] = None

    def refs(self):
        return self.prompt.refs()


@dataclasses.dataclass(frozen=True)
class AIEmbed(Expr):
    """AI_EMBED(col) — the column's embedding vector (EMBED request
    kind, priced per input token on the embedding tier).  A projection
    item; also the building block AI_SIMILARITY reduces to."""
    arg: Expr
    model: Optional[str] = None

    def refs(self):
        return self.arg.refs()


@dataclasses.dataclass(frozen=True)
class AISimilarity(Expr):
    """AI_SIMILARITY(a, b) — cosine similarity of the two sides'
    embeddings, in [-1, 1].  Embedding-based by definition (no
    generative model): each side costs one EMBED request per distinct
    text, so a literal side embeds exactly once per query and the
    semantic index can answer ``ORDER BY AI_SIMILARITY(...) LIMIT k``
    without touching the inference tier at all."""
    left: Expr
    right: Expr
    model: Optional[str] = None

    def refs(self):
        return self.left.refs() | self.right.refs()


@dataclasses.dataclass(frozen=True)
class AIClassify(Expr):
    """AI_CLASSIFY(text, [labels...]) — §3.4."""
    text: Prompt
    labels: Tuple[str, ...] = ()
    labels_expr: Optional[Expr] = None   # label list from a column (rewrite)
    multi_label: bool = False
    model: Optional[str] = None

    def refs(self):
        out = self.text.refs()
        if self.labels_expr is not None:
            out |= self.labels_expr.refs()
        return out


@dataclasses.dataclass(frozen=True)
class AIComplete(Expr):
    prompt: Prompt
    model: Optional[str] = None
    max_tokens: int = 48

    def refs(self):
        return self.prompt.refs()


@dataclasses.dataclass(frozen=True)
class AggCall(Expr):
    """Aggregate in a SELECT list: COUNT/SUM/AVG/MIN/MAX or
    AI_AGG(col, instruction) / AI_SUMMARIZE_AGG(col)."""
    name: str
    args: Tuple[Expr, ...]
    instruction: Optional[str] = None

    def refs(self):
        out: Set[str] = set()
        for a in self.args:
            out |= a.refs()
        return out

    @property
    def is_ai(self) -> bool:  # type: ignore[override]
        return self.name in ("AI_AGG", "AI_SUMMARIZE_AGG")


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


# ---------------------------------------------------------------------------
# analysis helpers
# ---------------------------------------------------------------------------


def ai_calls_in(e: Expr) -> List[Expr]:
    out: List[Expr] = []

    def walk(x):
        if isinstance(x, (AIFilter, AIScore, AIClassify, AIComplete,
                          AIEmbed, AISimilarity)):
            out.append(x)
        if isinstance(x, AggCall) and x.name in ("AI_AGG", "AI_SUMMARIZE_AGG"):
            out.append(x)
        for f in dataclasses.fields(x) if dataclasses.is_dataclass(x) else []:
            v = getattr(x, f.name)
            if isinstance(v, Expr):
                walk(v)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, Expr):
                        walk(item)
    walk(e)
    return out


def split_conjuncts(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    if isinstance(e, BoolOp) and e.op == "and":
        out: List[Expr] = []
        for a in e.args:
            out.extend(split_conjuncts(a))
        return out
    return [e]


def conjoin(preds: Sequence[Expr]) -> Optional[Expr]:
    preds = list(preds)
    if not preds:
        return None
    if len(preds) == 1:
        return preds[0]
    return BoolOp("and", tuple(preds))


# ---------------------------------------------------------------------------
# vectorised evaluation of NON-AI expressions
# ---------------------------------------------------------------------------


def resolve_column(table: Table, name: str) -> str:
    if name in table:
        return name
    # unqualified reference: unique suffix match on "alias.col"
    matches = [c for c in table.column_names
               if c.endswith("." + name) or c == name]
    if len(matches) == 1:
        return matches[0]
    raise KeyError(f"column {name!r} not found (or ambiguous) in "
                   f"{table.column_names}")


_SCALAR_FUNCS = {
    "FL_IS_IMAGE": lambda col: np.asarray([fl_is_image(v) for v in col]),
    "FL_IS_AUDIO": lambda col: np.asarray([fl_is_audio(v) for v in col]),
    "LENGTH": lambda col: np.asarray([len(str(v)) for v in col]),
    "LOWER": lambda col: np.asarray([str(v).lower() for v in col], object),
    "UPPER": lambda col: np.asarray([str(v).upper() for v in col], object),
}


def eval_expr(e: Expr, table: Table, rows: Optional[np.ndarray] = None
              ) -> np.ndarray:
    """Evaluate a non-AI expression over (a subset of) a table."""
    n = table.num_rows if rows is None else len(rows)

    def col(name):
        resolved = resolve_column(table, name)
        if rows is None:
            return table.column(resolved)
        # segment-wise on chunked tables: touches only the chunks that
        # hold `rows`, never the whole column
        return table.gather(resolved, rows)

    if isinstance(e, Column):
        return col(e.name)
    if isinstance(e, Literal):
        return np.full(n, e.value, dtype=object if isinstance(e.value, str)
                       else None)
    if isinstance(e, BinOp):
        l = eval_expr(e.left, table, rows)
        r = eval_expr(e.right, table, rows)
        ops = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
               "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
               ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
               "+": lambda a, b: a + b, "-": lambda a, b: a - b,
               "*": lambda a, b: a * b, "/": lambda a, b: a / b}
        return ops[e.op](l, r)
    if isinstance(e, Between):
        v = eval_expr(e.expr, table, rows)
        lo = eval_expr(e.lo, table, rows)
        hi = eval_expr(e.hi, table, rows)
        return (v >= lo) & (v <= hi)
    if isinstance(e, InList):
        v = eval_expr(e.expr, table, rows)
        allowed = set(e.values)
        return np.asarray([x in allowed for x in v])
    if isinstance(e, BoolOp):
        parts = [eval_expr(a, table, rows) for a in e.args]
        out = parts[0].astype(bool)
        for p in parts[1:]:
            out = (out & p.astype(bool)) if e.op == "and" else (out | p.astype(bool))
        return out
    if isinstance(e, Not):
        return ~eval_expr(e.arg, table, rows).astype(bool)
    if isinstance(e, FuncCall):
        fn = _SCALAR_FUNCS.get(e.name.upper())
        if fn is None:
            raise KeyError(f"unknown function {e.name}")
        return fn(eval_expr(e.args[0], table, rows))
    if isinstance(e, (AIFilter, AIScore, AIClassify, AIComplete, AIEmbed,
                      AISimilarity, AggCall)):
        raise RuntimeError(f"AI/aggregate expression reached eval_expr: {e}; "
                           "the executor must handle it")
    raise TypeError(f"cannot evaluate {type(e).__name__}")
