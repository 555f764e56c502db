"""Semantic-model catalog + NL→AISQL compilation.

The paper's chat front-ends do not speak SQL: they POST a natural-
language question plus a *semantic model* — a curated description of the
tables (business meaning per column, synonyms, verified example
queries) — and the service compiles the question into AISQL against
that model.  This module provides both halves:

  * `SemanticModel`: the curated catalog description, validated against
    the live `Catalog` (every described table/column must exist; every
    verified example query must parse and resolve).  Serializable to a
    plain dict/JSON structure (YAML-compatible; loading YAML works when
    the interpreter has ``pyyaml``, but nothing here requires it).
  * `NL2SQLOperator`: compiles a question to AISQL via the existing
    `CortexClient` COMPLETE path.  Every generated query is round-
    tripped through ``sqlparse.parse`` → plan → `Optimizer` **and**
    validated against the semantic model before it may execute; a
    query that fails validation is retried with the error appended to
    the prompt, and exhaustion surfaces the last validation error as
    `NL2SQLError` — a rejected query never reaches the engine.

Grounding for tests/benchmarks: the `SimulatedBackend` understands a
``"nl2sql"`` metadata block (question + examples) and answers with the
semantically matching verified query — sometimes corrupted, so the
validation loop is exercised end to end (see
``repro_torch.inference.simulator``).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import expr as E
from repro_torch.core import plan as P
from repro_torch.core import sqlparse
from repro_torch.core.cost import Catalog
from repro_torch.core.optimizer import Optimizer, OptimizerConfig
from repro_torch.core.sqlparse import ParseError, Query
from repro_torch.inference.api import CortexClient


class SemanticValidationError(ValueError):
    """A query (or the model itself) failed semantic-model validation:
    unknown table, unresolvable column, or a verified example that no
    longer matches the live catalog."""


class NL2SQLError(RuntimeError):
    """NL→AISQL compilation failed for a question: every attempt was
    rejected by the parse/optimize/semantic validation loop.  Carries
    the last rejected SQL and its validation error."""

    def __init__(self, question: str, attempts: int,
                 last_sql: Optional[str], last_error: Exception):
        self.question = question
        self.attempts = attempts
        self.last_sql = last_sql
        self.last_error = last_error
        super().__init__(
            f"could not compile question {question!r} after {attempts} "
            f"attempt(s); last error: {last_error}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnSpec:
    """One described column: business meaning + NL synonyms."""
    name: str
    description: str = ""
    synonyms: Tuple[str, ...] = ()


@dataclasses.dataclass
class TableSpec:
    """One described table."""
    name: str
    description: str = ""
    columns: List[ColumnSpec] = dataclasses.field(default_factory=list)

    def column(self, name: str) -> Optional[ColumnSpec]:
        for c in self.columns:
            if c.name == name:
                return c
        return None


@dataclasses.dataclass
class VerifiedQuery:
    """A curated (question, AISQL) pair: few-shot grounding for the
    compiler and a regression anchor for the model itself."""
    name: str
    question: str
    sql: str


@dataclasses.dataclass
class SemanticModel:
    """The curated catalog description a chat front-end queries against."""
    name: str = "default"
    description: str = ""
    tables: List[TableSpec] = dataclasses.field(default_factory=list)
    verified: List[VerifiedQuery] = dataclasses.field(default_factory=list)

    # -- construction --------------------------------------------------
    @classmethod
    def from_catalog(cls, catalog: Catalog, *, name: str = "default",
                     description: str = "") -> "SemanticModel":
        """Skeleton model over a live catalog: every table and every
        non-hidden column, with empty descriptions to be curated."""
        tables = []
        for tname, t in catalog.tables.items():
            cols = [ColumnSpec(c) for c in t.column_names
                    if not c.rsplit(".", 1)[-1].startswith("_")]
            tables.append(TableSpec(tname, columns=cols))
        return cls(name=name, description=description, tables=tables)

    def table(self, name: str) -> Optional[TableSpec]:
        for t in self.tables:
            if t.name == name:
                return t
        return None

    # -- validation ----------------------------------------------------
    def validate(self, catalog: Catalog) -> None:
        """The model must agree with the live catalog: every described
        table and column exists, and every verified query parses and
        resolves.  Raises `SemanticValidationError` on the first
        mismatch (`ParseError` propagates for unparsable examples)."""
        if not self.tables:
            raise SemanticValidationError(
                "semantic model describes no tables")
        for spec in self.tables:
            if spec.name not in catalog.tables:
                raise SemanticValidationError(
                    f"semantic model table {spec.name!r} does not exist "
                    f"in the catalog")
            live = catalog.tables[spec.name]
            for col in spec.columns:
                if col.name not in live.column_names:
                    raise SemanticValidationError(
                        f"semantic model column "
                        f"{spec.name}.{col.name} does not exist "
                        f"(live columns: {sorted(live.column_names)})")
        for vq in self.verified:
            q = sqlparse.parse(vq.sql)
            try:
                self.validate_query(q, catalog)
            except SemanticValidationError as e:
                raise SemanticValidationError(
                    f"verified query {vq.name!r} is invalid: {e}") from e

    def validate_query(self, q: Query, catalog: Catalog) -> None:
        """A parsed query must resolve entirely inside the model: every
        table referenced is described, every column reference names a
        live column of a referenced table."""
        refs = [q.table] + [j.ref for j in q.joins]
        alias_to_table: Dict[str, str] = {}
        for ref in refs:
            if self.table(ref.table) is None:
                raise SemanticValidationError(
                    f"unknown table {ref.table!r} (semantic model knows: "
                    f"{sorted(t.name for t in self.tables)})")
            alias_to_table[ref.alias] = ref.table
        for col in self._column_refs(q):
            self._resolve_column(col, alias_to_table, catalog)

    def _resolve_column(self, col: str, alias_to_table: Dict[str, str],
                        catalog: Catalog) -> None:
        if "." in col:
            alias, bare = col.split(".", 1)
            table = alias_to_table.get(alias)
            if table is None:
                raise SemanticValidationError(
                    f"column {col!r} references unknown alias {alias!r} "
                    f"(in scope: {sorted(alias_to_table)})")
            candidates = [table]
        else:
            bare, candidates = col, list(alias_to_table.values())
        for table in candidates:
            live = catalog.tables.get(table)
            if live is not None and bare in live.column_names:
                return
        raise SemanticValidationError(
            f"column {col!r} does not resolve against "
            f"{sorted(set(candidates))}")

    @staticmethod
    def _column_refs(q: Query) -> List[str]:
        exprs: List[E.Expr] = [it.expr for it in q.select]
        exprs += [j.on for j in q.joins]
        if q.where is not None:
            exprs.append(q.where)
        exprs += [o.expr for o in q.order_by]
        refs: List[str] = []
        for e in exprs:
            refs.extend(sorted(e.refs()))
        refs.extend(q.group_by)
        return refs

    # -- (de)serialization: plain dicts, JSON, YAML-compatible ---------
    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "description": self.description,
            "tables": [
                {"name": t.name, "description": t.description,
                 "columns": [
                     {"name": c.name, "description": c.description,
                      "synonyms": list(c.synonyms)}
                     for c in t.columns]}
                for t in self.tables],
            "verified_queries": [
                {"name": v.name, "question": v.question, "sql": v.sql}
                for v in self.verified],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "SemanticModel":
        return cls(
            name=d.get("name", "default"),
            description=d.get("description", ""),
            tables=[
                TableSpec(
                    t["name"], t.get("description", ""),
                    [ColumnSpec(c["name"], c.get("description", ""),
                                tuple(c.get("synonyms", ())))
                     for c in t.get("columns", ())])
                for t in d.get("tables", ())],
            verified=[
                VerifiedQuery(v["name"], v["question"], v["sql"])
                for v in d.get("verified_queries", ())])

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "SemanticModel":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_yaml(cls, text: str) -> "SemanticModel":
        """The on-disk schema is YAML-compatible; parsing YAML needs
        ``pyyaml``, which is optional — JSON always works."""
        try:
            import yaml
        except ImportError as e:       # pragma: no cover - env dependent
            raise RuntimeError(
                "pyyaml is not installed; use from_json()") from e
        return cls.from_dict(yaml.safe_load(text))

    # -- prompt rendering ----------------------------------------------
    def prompt_context(self) -> str:
        """The model rendered as grounding text for the compiler LLM."""
        lines: List[str] = []
        if self.description:
            lines.append(self.description)
        for t in self.tables:
            desc = f" -- {t.description}" if t.description else ""
            lines.append(f"table {t.name}{desc}")
            for c in t.columns:
                extra = []
                if c.description:
                    extra.append(c.description)
                if c.synonyms:
                    extra.append("synonyms: " + ", ".join(c.synonyms))
                suffix = (" -- " + "; ".join(extra)) if extra else ""
                lines.append(f"  column {c.name}{suffix}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# NL -> AISQL
# ---------------------------------------------------------------------------

_SQL_FENCE_RE = re.compile(r"```(?:sql)?\s*(.+?)\s*```", re.DOTALL)


def extract_sql(text: str) -> str:
    """The SQL from a completion: the fenced block when present, else
    the text from the first SELECT onward, else the raw text."""
    m = _SQL_FENCE_RE.search(text)
    if m:
        return m.group(1).strip()
    low = text.upper()
    i = low.find("SELECT")
    return text[i:].strip() if i >= 0 else text.strip()


class NL2SQLOperator:
    """Compile natural-language questions to validated AISQL.

    The validation loop is the contract: *every* candidate the LLM
    produces is (1) parsed (`ParseError` on malformed SQL), (2) checked
    against the semantic model (unknown tables/columns), and (3) built
    into a plan and run through the `Optimizer` — only a query that
    survives all three may execute.  A rejected candidate's error is
    appended to the next attempt's prompt; after ``max_attempts`` the
    last error surfaces as `NL2SQLError`.
    """

    def __init__(self, model: SemanticModel, catalog: Catalog,
                 client: CortexClient, *, llm_model: Optional[str] = None,
                 max_attempts: int = 2,
                 optimizer: Optional[OptimizerConfig] = None,
                 validate_model: bool = True):
        if validate_model:
            model.validate(catalog)
        self.model = model
        self.catalog = catalog
        self.client = client
        self.llm_model = llm_model
        self.max_attempts = max(int(max_attempts), 1)
        self.optimizer = Optimizer(catalog, cfg=optimizer)
        # compilation telemetry
        self.compiled = 0
        self.rejected_attempts = 0
        self.failed = 0

    # -- prompt assembly ----------------------------------------------
    def _prompt(self, question: str, feedback: Optional[str]) -> str:
        parts = [
            "Translate the question into one AISQL query.",
            "Schema:", self.model.prompt_context(),
        ]
        if self.model.verified:
            parts.append("Examples:")
            for vq in self.model.verified:
                parts.append(f"Q: {vq.question}\nSQL: {vq.sql}")
        if feedback:
            parts.append(f"The previous attempt was rejected: {feedback}\n"
                         f"Produce a corrected query.")
        parts.append(f"Q: {question}\nSQL:")
        return "\n\n".join(parts)

    def _metadata(self, question: str) -> Dict:
        # grounding block the deterministic simulator keys on; a real
        # backend simply ignores it
        return {"nl2sql": {
            "question": question,
            "examples": [{"question": vq.question, "sql": vq.sql}
                         for vq in self.model.verified],
        }}

    # -- validation ----------------------------------------------------
    def validate_sql(self, sql: str) -> P.PlanNode:
        """Parse → semantic-model check → plan → optimize; returns the
        optimized plan, raises `ParseError` / `SemanticValidationError`."""
        q = sqlparse.parse(sql)
        self.model.validate_query(q, self.catalog)
        return self.optimizer.optimize(P.build_plan(q))

    # -- compilation ---------------------------------------------------
    def compile(self, question: str) -> str:
        """The validated AISQL for ``question`` (the compiled SQL text;
        call `validate_sql` again for the plan).  Raises `NL2SQLError`
        when every attempt is rejected."""
        feedback: Optional[str] = None
        last_sql: Optional[str] = None
        last_err: Optional[Exception] = None
        for _ in range(self.max_attempts):
            prompt = self._prompt(question, feedback)
            [completion] = self.client.complete(
                [prompt], model=self.llm_model,
                max_tokens=128, metadata=[self._metadata(question)])
            sql = extract_sql(completion)
            last_sql = sql
            try:
                self.validate_sql(sql)
            except (ParseError, SemanticValidationError) as e:
                self.rejected_attempts += 1
                feedback = f"{sql!r}: {e}"
                last_err = e
                continue
            self.compiled += 1
            return sql
        self.failed += 1
        assert last_err is not None
        raise NL2SQLError(question, self.max_attempts, last_sql, last_err)


# ---------------------------------------------------------------------------
# seeded question corpus (benchmark/test grounding)
# ---------------------------------------------------------------------------

_PARAPHRASES = (
    "{q}",
    "please {q}",
    "show me: {q}",
    "{q} thanks",
    "i need to {q}",
    "could you {q}",
)


def question_corpus(model: SemanticModel, n: int, *, seed: int = 0
                    ) -> List[Tuple[str, VerifiedQuery]]:
    """``n`` (question, grounding) pairs: deterministic paraphrases of
    the model's verified questions — the NL→AISQL acceptance gate
    compiles these and checks the result against the verified query's
    rows."""
    if not model.verified:
        raise ValueError("semantic model has no verified queries")
    out: List[Tuple[str, VerifiedQuery]] = []
    for i in range(n):
        vq = model.verified[(seed + i) % len(model.verified)]
        tpl = _PARAPHRASES[(seed + i) % len(_PARAPHRASES)]
        out.append((tpl.format(q=vq.question), vq))
    return out
