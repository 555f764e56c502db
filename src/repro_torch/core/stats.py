"""Learned statistics store — the feedback half of adaptive re-optimization.

The paper's core planning problem is that semantic operators' *cost and
selectivity are unknown during query compilation*.  This module closes the
loop: every AI-predicate evaluation (pilot samples, full passes, cascade
routing, pipeline dedup) folds observations into a `StatsStore`, keyed by a
**predicate fingerprint** that is stable across queries and across
syntactically-different-but-equivalent predicates (table aliases are
stripped, prompt templates and models are canonical).  The `CostModel`
consults the store *before* its static defaults, so the second query — or
the post-pilot remainder of the first — plans with real numbers.

Recorded per fingerprint (`PredObservation`):

  * **selectivity** — passed / evaluated rows, with a Wilson-score
    confidence interval (`selectivity_ci`) so the planner can tell a
    confident estimate from noise;
  * **cost per row** — observed credits / evaluated row (dispatch-metered,
    so dedup savings show up) plus wall seconds;
  * **cascade delegation rate** — oracle escalations / rows routed through
    a SUPG-IT cascade for this predicate (drives the cascade-bypass
    re-decision);
  * **dedup hit rate** — pipeline-level, stored under the reserved
    ``__pipeline__`` key.

Persistence is plain JSON (`save` / `load` round-trip) so learned stats
survive across engine instances — the production pattern of a statistics
service shared by all queries over a workload.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.core import expr as E

PIPELINE_KEY = "__pipeline__"      # reserved fingerprint for global stats


# ---------------------------------------------------------------------------
# predicate fingerprinting
# ---------------------------------------------------------------------------


def _leaf(col: str) -> str:
    """Strip the table alias: ``a.body`` and ``articles.body`` -> ``body``."""
    return col.rsplit(".", 1)[-1]


def _canon(e: E.Expr) -> str:
    """Alias-free canonical form of a non-AI expression."""
    if isinstance(e, E.Column):
        return _leaf(e.name)
    if isinstance(e, E.Literal):
        return repr(e.value)
    if isinstance(e, E.BinOp):
        return f"({_canon(e.left)}{e.op}{_canon(e.right)})"
    if isinstance(e, E.Between):
        return f"between({_canon(e.expr)},{_canon(e.lo)},{_canon(e.hi)})"
    if isinstance(e, E.InList):
        return f"in({_canon(e.expr)},{sorted(map(repr, e.values))})"
    if isinstance(e, E.Not):
        return f"not({_canon(e.arg)})"
    if isinstance(e, E.BoolOp):
        return f"{e.op}({','.join(_canon(a) for a in e.args)})"
    if isinstance(e, E.FuncCall):
        return f"{e.name.upper()}({','.join(_canon(a) for a in e.args)})"
    if isinstance(e, E.AISimilarity):
        # cosine similarity is symmetric: canonicalize the side order so
        # AI_SIMILARITY(a, b) and AI_SIMILARITY(b, a) share an identity
        lo, hi = sorted((_canon(e.left), _canon(e.right)))
        return f"ai_similarity({lo},{hi},{e.model or ''})"
    if isinstance(e, E.AIEmbed):
        return f"ai_embed({_canon(e.arg)},{e.model or ''})"
    if isinstance(e, E.Prompt):
        return f"prompt({e.template!r},{','.join(_canon(a) for a in e.args)})"
    return type(e).__name__


def predicate_fingerprint(pred: E.Expr) -> str:
    """Stable cross-query identity of a predicate.

    Two predicates share a fingerprint iff an engine would answer them
    identically per row: same operator kind, same prompt template, same
    model, same *unaliased* argument columns.  ``WHERE AI_FILTER(
    PROMPT('x {0}', a.body))`` and the same filter written against alias
    ``b`` therefore share learned statistics.
    """
    if isinstance(pred, E.AIFilter):
        return (f"AI_FILTER|{pred.prompt.template}|{pred.model or ''}|"
                f"{','.join(_canon(a) for a in pred.prompt.args)}")
    if isinstance(pred, E.AIScore):
        # the model is part of the identity: proxy-prefilter scores and
        # oracle scores of the same prompt are distinct cost populations
        return (f"AI_SCORE|{pred.prompt.template}|{pred.model or ''}|"
                f"{','.join(_canon(a) for a in pred.prompt.args)}")
    if isinstance(pred, E.AIClassify):
        return (f"AI_CLASSIFY|{pred.text.template}|{pred.model or ''}|"
                f"{','.join(sorted(pred.labels))}|"
                f"{','.join(_canon(a) for a in pred.text.args)}")
    if isinstance(pred, E.AISimilarity):
        # symmetric operator, symmetric key: sort the canonical sides so
        # learned stats never split across the two argument orders
        lo, hi = sorted((_canon(pred.left), _canon(pred.right)))
        return f"AI_SIMILARITY|{pred.model or ''}|{lo}|{hi}"
    if isinstance(pred, E.AIEmbed):
        return f"AI_EMBED|{pred.model or ''}|{_canon(pred.arg)}"
    return f"REL|{_canon(pred)}"


def index_join_fingerprint(template: str, model, left_arg: str,
                           label_col: str) -> str:
    """Identity of one index-assisted semantic-join blocking site: the
    `StatsStore` accumulates probe/candidate volume under it, giving the
    cost model a learned candidate rate for the next race."""
    return (f"INDEX_JOIN|{template}|{model or ''}|"
            f"{_leaf(left_arg)}|{_leaf(label_col)}")


def predicate_prompt_text(pred: E.Expr) -> Optional[str]:
    """Natural-language text embedding a predicate's *meaning* — the
    kNN-transfer key (cost model v2).  The prompt template carries the
    semantic content; the unaliased argument columns disambiguate
    same-template predicates over different data.  None for operators
    whose statistics are not transferable by meaning (similarity /
    embed produce values, relational predicates are priced statically).
    """
    if isinstance(pred, (E.AIFilter, E.AIScore)):
        args = " ".join(_canon(a) for a in pred.prompt.args)
        return f"{pred.prompt.template} {args}".strip()
    if isinstance(pred, E.AIClassify):
        args = " ".join(_canon(a) for a in pred.text.args)
        return f"{pred.text.template} {args}".strip()
    return None


# ---------------------------------------------------------------------------
# observations
# ---------------------------------------------------------------------------


def wilson_interval(passed: int, evaluated: int, *, z: float = 1.96
                    ) -> Tuple[float, float]:
    """Wilson-score ``(lo, hi)`` confidence interval on a pass rate.

    Used instead of the normal approximation because pilot samples are
    small (tens of rows) and AI selectivities are often near 0 or 1,
    exactly where the normal interval degenerates.
    """
    if evaluated <= 0:
        return 0.0, 1.0
    p = passed / evaluated
    denom = 1.0 + z * z / evaluated
    centre = p + z * z / (2 * evaluated)
    margin = z * math.sqrt((p * (1 - p) + z * z / (4 * evaluated))
                           / evaluated)
    return (max(0.0, (centre - margin) / denom),
            min(1.0, (centre + margin) / denom))


@dataclasses.dataclass
class PredObservation:
    """Accumulated execution-time evidence for one predicate fingerprint.

    Counters are additive across queries; all derived quantities
    (selectivity, cost per row, delegation rate) are recomputed from the
    raw counts so merging two stores is exact.
    """
    evaluated: int = 0            # rows the predicate was evaluated on
    passed: int = 0               # rows where it returned true
    credits: float = 0.0          # LLM credits spent on those rows
    seconds: float = 0.0          # wall seconds spent on those rows
    queries: int = 0              # distinct queries that contributed
    cascade_rows: int = 0         # rows routed through a cascade
    cascade_oracle: int = 0      # of those, rows escalated to the oracle
    dedup_submitted: int = 0      # pipeline: requests submitted
    dedup_hits: int = 0           # pipeline: requests served by dedup
    index_probes: int = 0         # semantic index: kNN probe rows issued
    index_candidates: int = 0     # of those, candidates surfaced in total

    # -- derived -------------------------------------------------------
    @property
    def selectivity(self) -> float:
        return self.passed / self.evaluated if self.evaluated else 0.5

    def selectivity_ci(self, z: float = 1.96) -> Tuple[float, float]:
        return wilson_interval(self.passed, self.evaluated, z=z)

    @property
    def cost_per_row(self) -> float:
        """Observed credits per evaluated row (0.0 when unobserved)."""
        return self.credits / self.evaluated if self.evaluated else 0.0

    @property
    def seconds_per_row(self) -> float:
        return self.seconds / self.evaluated if self.evaluated else 0.0

    @property
    def delegation_rate(self) -> float:
        """Cascade escalation rate: oracle calls / cascaded rows."""
        return (self.cascade_oracle / self.cascade_rows
                if self.cascade_rows else 0.0)

    @property
    def dedup_hit_rate(self) -> float:
        return (self.dedup_hits / self.dedup_submitted
                if self.dedup_submitted else 0.0)

    @property
    def candidates_per_probe(self) -> float:
        """Semantic index: observed mean kNN candidates surfaced per
        probe row (0.0 when unobserved) — the learned candidate rate
        behind the index-vs-rewrite cost race."""
        return (self.index_candidates / self.index_probes
                if self.index_probes else 0.0)

    # -- (de)serialisation --------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PredObservation":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def merge(self, other: "PredObservation") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class StatsStore:
    """Persistent map: predicate fingerprint -> `PredObservation`.

    One instance is shared by the `CostModel` (reads), the `Executor`
    (writes, during pilot sampling and full evaluation) and the
    `AisqlEngine` (cascade / pipeline roll-ups after each query).  With a
    ``path`` the store loads existing stats on construction and `save`
    writes them back as JSON — no other I/O happens implicitly.

    Thread-safe: under the serving runtime one store is written by every
    concurrent query session, so all recording, merging and persistence
    happens under a reentrant lock — two writers folding observations
    into the same fingerprint lose nothing.  Readers get live
    `PredObservation` objects; their counters are plain ints/floats
    updated only under the lock, so a read sees a consistent-enough
    snapshot for planning purposes.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.RLock()
        self._obs: Dict[str, PredObservation] = {}
        # fingerprint -> natural-language prompt text (kNN-transfer key);
        # only fingerprints with a registered text can donate priors
        self._prompts: Dict[str, str] = {}
        # bumped on every write — cheap cache-invalidation handle for
        # derived state (the cost model's transferred-prior cache)
        self.version = 0
        if path is not None and os.path.exists(path):
            self.load(path)

    # -- access --------------------------------------------------------
    def get(self, key: str) -> Optional[PredObservation]:
        return self._obs.get(key)

    def for_pred(self, pred: E.Expr) -> Optional[PredObservation]:
        return self._obs.get(predicate_fingerprint(pred))

    def confident(self, key: str, *, min_rows: int = 32) -> bool:
        """True when the fingerprint has at least ``min_rows`` observed
        row evaluations — the planner's trust threshold."""
        o = self._obs.get(key)
        return o is not None and o.evaluated >= min_rows

    def __len__(self) -> int:
        return len(self._obs)

    def keys(self):
        return self._obs.keys()

    def items(self) -> Iterator[Tuple[str, PredObservation]]:
        """Snapshot of ``(fingerprint, observation)`` pairs (taken under
        the lock, so concurrent writers never corrupt the iteration)."""
        with self._lock:
            return iter(list(self._obs.items()))

    def prompt_text(self, key: str) -> Optional[str]:
        return self._prompts.get(key)

    def prompt_texts(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._prompts)

    def register_prompt(self, key: str, text: str) -> None:
        """Associate a fingerprint with its natural-language prompt text
        so it can donate (and receive) kNN-transferred priors."""
        if not text:
            return
        with self._lock:
            if self._prompts.get(key) != text:
                self._prompts[key] = text
                self.version += 1

    # -- recording -----------------------------------------------------
    def _entry(self, key: str) -> PredObservation:
        return self._obs.setdefault(key, PredObservation())

    def observe_predicate(self, key: str, *, evaluated: int, passed: int,
                          credits: float = 0.0, seconds: float = 0.0,
                          new_query: bool = False) -> PredObservation:
        """Fold one evaluation batch (rows, outcomes, spend) into ``key``."""
        with self._lock:
            o = self._entry(key)
            o.evaluated += int(evaluated)
            o.passed += int(passed)
            o.credits += float(credits)
            o.seconds += float(seconds)
            if new_query:
                o.queries += 1
            self.version += 1
            return o

    def note_query(self, keys) -> None:
        """Count one contributing query for each (already observed)
        fingerprint — called once per executed query by the executor."""
        with self._lock:
            for key in keys:
                o = self._obs.get(key)
                if o is not None:
                    o.queries += 1
            self.version += 1

    def observe_cascade(self, key: str, *, rows: int, oracle_calls: int
                        ) -> PredObservation:
        """Record SUPG-IT routing volume for a cascaded predicate."""
        with self._lock:
            o = self._entry(key)
            o.cascade_rows += int(rows)
            o.cascade_oracle += int(oracle_calls)
            self.version += 1
            return o

    def observe_index(self, key: str, *, probes: int, candidates: int
                      ) -> PredObservation:
        """Record semantic-index blocking volume (probe rows issued and
        candidates surfaced) for an `index_join_fingerprint` — the
        learned candidate-rate feedback the next cost race reads."""
        with self._lock:
            o = self._entry(key)
            o.index_probes += int(probes)
            o.index_candidates += int(candidates)
            self.version += 1
            return o

    def observe_pipeline(self, *, submitted: int, dedup_hits: int
                         ) -> PredObservation:
        """Record the request pipeline's dedup effectiveness (global)."""
        with self._lock:
            o = self._entry(PIPELINE_KEY)
            o.dedup_submitted += int(submitted)
            o.dedup_hits += int(dedup_hits)
            self.version += 1
            return o

    # -- persistence ---------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        """Atomically persist the store as JSON.

        The payload is written to a same-directory temp file and moved
        into place with ``os.replace`` — a crash mid-write (power loss,
        kill -9) leaves either the previous complete file or the new
        complete file, never a truncated one that would poison the next
        engine's ``__init__``.
        """
        path = path or self.path
        if path is None:
            raise ValueError("StatsStore.save: no path configured")
        with self._lock:
            payload = {
                "format": 2,
                "observations": {k: o.to_dict()
                                 for k, o in self._obs.items()},
                "prompts": dict(self._prompts),
            }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    @staticmethod
    def _canonical_key(key: str) -> str:
        """Map a legacy (pre-symmetry) fingerprint to its canonical form:
        old stores may hold ``AI_SIMILARITY|model|b|a`` twins whose
        evidence belongs under the sorted-side key."""
        if key.startswith("AI_SIMILARITY|"):
            parts = key.split("|")
            if len(parts) == 4:       # templates with '|' are not ours
                return "|".join(parts[:2] + sorted(parts[2:]))
        return key

    def load(self, path: Optional[str] = None) -> None:
        """Merge a persisted store into this one.

        Corrupt or partially-written files (the pre-atomic-save failure
        mode) warn and contribute nothing instead of raising — learned
        statistics are an optimization, never a reason a query engine
        fails to construct.  Legacy asymmetric ``AI_SIMILARITY`` twin
        keys are folded into their canonical (sorted-side) key.
        """
        path = path or self.path
        try:
            with open(path) as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                raise ValueError("stats payload is not an object")
        except (json.JSONDecodeError, ValueError, OSError) as exc:
            warnings.warn(
                f"StatsStore: ignoring unreadable stats file {path!r} "
                f"({exc}); starting from empty statistics", stacklevel=2)
            return
        if "observations" in payload:       # format 2
            observations = payload.get("observations", {})
            prompts = payload.get("prompts", {})
        else:                               # legacy flat format
            observations, prompts = payload, {}
        with self._lock:
            for k, d in observations.items():
                try:
                    obs = PredObservation.from_dict(d)
                except (TypeError, AttributeError):
                    warnings.warn(f"StatsStore: skipping malformed entry "
                                  f"{k!r} in {path!r}", stacklevel=2)
                    continue
                k = self._canonical_key(k)
                if k in self._obs:
                    self._obs[k].merge(obs)
                else:
                    self._obs[k] = obs
            for k, text in prompts.items():
                self._prompts.setdefault(self._canonical_key(k), str(text))
            self.version += 1

    def clear(self) -> None:
        with self._lock:
            self._obs.clear()
            self._prompts.clear()
            self.version += 1

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: o.to_dict() for k, o in self._obs.items()}
