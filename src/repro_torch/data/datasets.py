"""Synthetic recreations of the paper's public benchmark datasets.

No network access is available, so each HuggingFace dataset used in §6 is
regenerated with the paper's cardinalities and a *difficulty* parameter
calibrated so the simulated proxy/oracle models land near the paper's
quality numbers.  Hidden columns (``_truth``, ``_difficulty``, ``_labels``)
carry ground truth to the calibrated simulator; ``SELECT *`` never
returns them.

Provided datasets:

  * cascade suite (§6.2 / Table 2 / Fig 11): NQ, BOOLQ, IMDB, SST2,
    QUORA, FARL — boolean-filter tables;
  * semantic-join suite (§6.3 / Tables 3–4 / Fig 12): NASDAQ, EURLEX,
    BIODEX, ABTBUY, AG NEWS (100/200), ARXIV, NYT, CNN — (left, right)
    table pairs with true pair sets;
  * NYT articles (Fig 9/10): single articles table with a category column
    whose IN-selectivity is adjustable;
  * the arXiv example of §5.1 (papers / paper_images with FILE columns).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.tables.table import FileRef, Table

_WORDS = ("data systems query model learning neural market stock product "
          "review energy database cloud index storage scan vector language "
          "policy health climate film music soccer election science space "
          "biology drug protein court law finance tax art travel food").split()


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


def _name_key(name: str) -> int:
    """Stable 16-bit key for a dataset name.  ``hash()`` is salted per
    process (PYTHONHASHSEED), which silently regenerated a *different*
    corpus every run — benchmark gates need bit-stable data."""
    import hashlib
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:2],
                          "little")


def _sentence(rng, n=12) -> str:
    return " ".join(rng.choice(_WORDS, size=n))


# ---------------------------------------------------------------------------
# cascade suite (§6.2)
# ---------------------------------------------------------------------------

# name -> (rows, difficulty, positive_rate).  Difficulty calibrates the Beta
# mixture in the simulator: higher = weaker proxy separation (lower speedup),
# mirroring the per-dataset spread in Fig 11 (NQ easy .. BOOLQ/QUORA hard).
CASCADE_DATASETS: Dict[str, Tuple[int, float, float]] = {
    "NQ":    (4000, 0.10, 0.45),
    "BOOLQ": (3500, 0.42, 0.60),
    "IMDB":  (5000, 0.22, 0.50),
    "SST2":  (4000, 0.25, 0.52),
    "QUORA": (6000, 0.40, 0.37),
    "FARL":  (4000, 0.38, 0.50),
}

CASCADE_PREDICATES: Dict[str, str] = {
    "NQ":    "Does the passage answer the question? {0}",
    "BOOLQ": "Is the answer to this yes/no question true? {0}",
    "IMDB":  "Does this movie review express positive sentiment? {0}",
    "SST2":  "Is the sentiment of this sentence positive? {0}",
    "QUORA": "Are these two questions duplicates? {0}",
    "FARL":  "Is this news headline reliable (not fake)? {0}",
}


def cascade_table(name: str, *, rows: Optional[int] = None, seed: int = 0
                  ) -> Table:
    n, difficulty, pos_rate = CASCADE_DATASETS[name]
    n = rows or n
    rng = _rng((seed, _name_key(name)))
    truth = rng.random(n) < pos_rate
    text = [f"[{name}:{i}] " + _sentence(rng, 18) for i in range(n)]
    return Table({
        "id": np.arange(n),
        "text": text,
        "_truth": truth,
        "_difficulty": np.full(n, difficulty),
    }, name=name.lower())


# ---------------------------------------------------------------------------
# semantic-join suite (§6.3, Table 4 cardinalities)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """Per-dataset calibration.  The four error knobs are fit to the paper's
    Table 4 per-dataset precision/recall (baseline cross-join AI_FILTER
    vs AI_CLASSIFY rewrite):

      fp_bias / fn_bias — pairwise AI_FILTER flip rates (the systematic
        yes-bias of isolated binary decisions drives the baseline's poor
        precision on NASDAQ/NYT and the no-bias drives ARXIV's low recall);
      cls_drop — per-true-label drop prob of the multi-label rewrite
        (conservative selection: the EURLEX/BIODEX recall loss);
      cls_adds — expected *count* of false labels added per left row
        (comparative reasoning keeps it ~constant, not per-candidate).
    """
    name: str
    left_rows: int
    right_rows: int
    kind: str                 # "entity" (1:1 matching) | "category" (n:few)
    labels_per_left: float    # mean true labels per left row
    doc_words: int            # left-document length (drives per-call tokens)
    label_words: int          # label verbosity (EuroVoc/MedDRA are phrases)
    fp_bias: float
    fn_bias: float
    cls_drop: float
    cls_adds: float


JOIN_DATASETS: Dict[str, JoinSpec] = {
    #                          name        L    R   kind      lpl  words lw  fp      fn     drop   adds
    "NASDAQ":     JoinSpec("NASDAQ",     100, 100, "entity",   1.0, 120, 2, 0.35,   0.04,  0.27,  0.13),
    "EURLEX":     JoinSpec("EURLEX",      50, 194, "category", 4.0, 160, 5, 0.10,   0.17,  0.79,  0.14),
    "BIODEX":     JoinSpec("BIODEX",      50, 197, "category", 3.5, 160, 3, 0.135,  0.415, 0.80,  1.01),
    "ABTBUY":     JoinSpec("ABTBUY",     100, 100, "entity",   1.0, 100, 2, 0.0004, 0.033, 0.032, 0.032),
    "AGNEWS_100": JoinSpec("AGNEWS_100", 100, 100, "category", 1.2,  80, 2, 0.0081, 0.13,  0.39,  0.072),
    "AGNEWS_200": JoinSpec("AGNEWS_200", 200, 200, "category", 1.2,  80, 2, 0.0048, 0.20,  0.39,  0.10),
    "ARXIV":      JoinSpec("ARXIV",      500, 500, "category", 2.0, 100, 6, 0.0006, 0.82,  0.80,  0.33),
    "NYT":        JoinSpec("NYT",        500, 500, "category", 1.5, 100, 2, 0.066,  0.225, 0.586, 0.40),
    "CNN":        JoinSpec("CNN",        500, 500, "category", 1.3, 220, 2, 0.001,  0.01,  0.016, 0.31),
}

JOIN_PROMPTS: Dict[str, str] = {
    "NASDAQ": "Company record {0} refers to the same company as ticker "
              "entry {1}",
    "EURLEX": "Legal document {0} falls under EuroVoc descriptor {1}",
    "BIODEX": "Patient report {0} mentions adverse reaction {1}",
    "ABTBUY": "Product listing {0} is the same product as listing {1}",
    "AGNEWS_100": "News article {0} belongs to topic {1}",
    "AGNEWS_200": "News article {0} belongs to topic {1}",
    "ARXIV": "Paper abstract {0} belongs to arXiv category {1}",
    "NYT": "Article {0} belongs to NYT section {1}",
    "CNN": "CNN story {0} is about category {1}",
}


def join_tables(name: Optional[str] = None, *, seed: int = 0,
                spec: Optional[JoinSpec] = None
                ) -> Tuple[Table, Table, JoinSpec]:
    """Returns (left, right, spec).  left.label_names carries truth as a
    hidden ``_labels`` tuple column; right is the label/category side.
    Pass ``spec`` to generate a custom corpus (e.g. the index-blocking
    benchmark's large-label-universe workload) with the same machinery.
    """
    spec = spec or JOIN_DATASETS[name]
    name = spec.name
    rng = _rng((seed, _name_key(name)))
    L, R = spec.left_rows, spec.right_rows
    if spec.kind == "entity":
        # R unique entities; left rows each match exactly one
        labels = [f"{name.lower()}-entity-{j:03d} "
                  + _sentence(rng, spec.label_words) for j in range(R)]
        match = rng.permutation(R)[:L] if R >= L else rng.integers(0, R, L)
        truth = [(labels[match[i]],) for i in range(L)]
    else:
        # category style: a modest label universe, several true per row
        labels = [f"{name.lower()}-cat-{j:03d} "
                  + _sentence(rng, spec.label_words) for j in range(R)]
        truth = []
        for i in range(L):
            k = max(1, int(rng.poisson(spec.labels_per_left)))
            k = min(k, R)
            truth.append(tuple(labels[j] for j in
                               sorted(rng.choice(R, size=k, replace=False))))
    left = Table({
        "id": np.arange(L),
        "content": [f"[{name}:{i}] " + _sentence(rng, spec.doc_words)
                    for i in range(L)],
        "_labels": [t for t in truth],
        "_fp_bias": np.full(L, spec.fp_bias),
        "_fn_bias": np.full(L, spec.fn_bias),
        "_drop_prob": np.full(L, spec.cls_drop),
        "_add_frac": np.full(L, spec.cls_adds / R),
    }, name=name.lower() + "_l")
    right = Table({
        "rid": np.arange(R),
        "label": labels,
    }, name=name.lower() + "_r")
    return left, right, spec


# ---------------------------------------------------------------------------
# NYT articles (Fig 9 / Fig 10)
# ---------------------------------------------------------------------------

NYT_CATEGORIES = ("politics", "business", "technology", "science", "health",
                  "sports", "arts", "travel", "food", "opinion")


def nyt_articles(n: int = 1000, *, seed: int = 0,
                 ai_selectivity: float = 0.30) -> Table:
    """1000-article table.  ``category`` is uniform over 10 values so an
    ``IN`` list of k categories has selectivity k/10 (the Fig 9 sweep);
    ``_truth`` grounds the AI_FILTER predicate at the given selectivity."""
    rng = _rng((seed, 42))
    cat = rng.choice(NYT_CATEGORIES, size=n)
    truth = rng.random(n) < ai_selectivity
    return Table({
        "id": np.arange(n),
        "category": cat,
        "body": [f"[nyt:{i}] " + _sentence(rng, 40) for i in range(n)],
        "_truth": truth,
        "_difficulty": np.full(n, 0.15),
    }, name="ny_articles")


def skewed_articles(n: int = 2000, *, seed: int = 0,
                    sel_broad: float = 0.95, sel_narrow: float = 0.05
                    ) -> Table:
    """Adaptive-reoptimization workload: two equal-length text columns
    whose AI predicates have wildly different true selectivities.

    ``headline`` and ``summary`` have the same average length (so static
    token-based cost estimates cannot tell the predicates apart), but the
    column-scoped ground truth ``_truth__headline`` passes ``sel_broad``
    of rows while ``_truth__summary`` passes ``sel_narrow`` — the
    skewed-selectivity case where the static default (0.5 for every AI
    predicate) is badly wrong in both directions."""
    rng = _rng((seed, 909))
    return Table({
        "id": np.arange(n),
        "headline": [f"[hl:{i}] " + _sentence(rng, 12) for i in range(n)],
        "summary": [f"[sm:{i}] " + _sentence(rng, 12) for i in range(n)],
        "_truth__headline": rng.random(n) < sel_broad,
        "_truth__summary": rng.random(n) < sel_narrow,
        "_difficulty": np.full(n, 0.05),
    }, name="articles")


def nyt_join_pair(n_left: int = 400, *, out_in_ratio: float = 1.0,
                  seed: int = 0, ai_selectivity: float = 0.3
                  ) -> Tuple[Table, Table]:
    """Two tables whose equi-join emits ``out_in_ratio * n_left`` rows
    (the Fig 10 sweep): every left row joins ~ratio right rows."""
    rng = _rng((seed, 77))
    left = Table({
        "key": np.arange(n_left),
        "body": [f"[nyt:{i}] " + _sentence(rng, 30) for i in range(n_left)],
        "_truth": rng.random(n_left) < ai_selectivity,
        "_difficulty": np.full(n_left, 0.15),
    }, name="ny_articles_v1")
    n_pairs = int(round(out_in_ratio * n_left))
    keys = rng.integers(0, n_left, size=max(n_pairs, 1))
    right = Table({
        "key": keys,
        "meta": [f"meta-{i}" for i in range(len(keys))],
    }, name="ny_meta")
    return left, right


# ---------------------------------------------------------------------------
# §5.1 arXiv example schema (papers / paper_images with FILE columns)
# ---------------------------------------------------------------------------


def papers_tables(n_papers: int = 1000, images_per_paper: int = 10, *,
                  seed: int = 0, date_sel: float = 0.10,
                  abstract_sel: float = 0.10, image_sel: float = 0.30
                  ) -> Tuple[Table, Table]:
    rng = _rng((seed, 5151))
    n = n_papers
    dates = rng.integers(2000, 2026, size=n)
    papers = Table({
        "id": np.arange(n),
        "title": [f"Paper {i}: " + _sentence(rng, 6) for i in range(n)],
        "date": dates,
        "abstract": [f"[abs:{i}] " + _sentence(rng, 50) for i in range(n)],
        "pdf": [FileRef(f"s3://papers/{i}.pdf", "application/pdf")
                for i in range(n)],
        "_truth": rng.random(n) < abstract_sel,
        "_difficulty": np.full(n, 0.12),
    }, name="papers")
    m = n * images_per_paper
    images = Table({
        "id": np.repeat(np.arange(n), images_per_paper),
        "image_file": [FileRef(f"s3://papers/img/{i}.png", "image/png")
                       for i in range(m)],
        "_truth": rng.random(m) < image_sel,
        "_difficulty": np.full(m, 0.2),
    }, name="paper_images")
    return papers, images


# ---------------------------------------------------------------------------
# quality metrics shared by benchmarks
# ---------------------------------------------------------------------------


def prf1(tp: int, fp: int, fn: int) -> Tuple[float, float, float]:
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def binary_metrics(pred: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    pred = np.asarray(pred, bool)
    truth = np.asarray(truth, bool)
    tp = int((pred & truth).sum())
    fp = int((pred & ~truth).sum())
    fn = int((~pred & truth).sum())
    tn = int((~pred & ~truth).sum())
    p, r, f1 = prf1(tp, fp, fn)
    return {"accuracy": (tp + tn) / max(len(pred), 1), "precision": p,
            "recall": r, "f1": f1}


def pair_metrics(pred_pairs: set, true_pairs: set) -> Dict[str, float]:
    tp = len(pred_pairs & true_pairs)
    fp = len(pred_pairs - true_pairs)
    fn = len(true_pairs - pred_pairs)
    p, r, f1 = prf1(tp, fp, fn)
    return {"precision": p, "recall": r, "f1": f1}


def true_pairs_of(left: Table, right: Table) -> set:
    """(left_id, right_label) truth set from the hidden ``_labels`` column."""
    out = set()
    lbl = left.column("_labels")
    ids = left.column("id")
    for i in range(left.num_rows):
        for lb in lbl[i]:
            out.add((int(ids[i]), str(lb)))
    return out
