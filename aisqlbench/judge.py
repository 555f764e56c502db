"""The comparison behind ``correct``: the program's answers, taken from
the timed path, against the plain reference run afterwards on the same
rows and tokens.

Numbers compared (each with a limit of its own in the cell's file):

``score_gap``    AI_FILTER: the widest |d - d_ref| over the sampled rows,
                 d = logit(yes) - logit(no) at the prompt's last token
                 (the program's from its SCORE, d = log(s / (1 - s)))
``rows_wrong``   AI_FILTER: sampled rows that the query kept or dropped
                 against the reference's decision d_ref >= 0, where
                 |d_ref| exceeds the cell's tie (its ``tie``, else its
                 ``score_gap`` limit: a nearer tie may fall either way)
``failed``       queries of the window that failed or never returned

The control (the reference in fp8, the architecture's
``Reference(precision="fp8")``) is judged the same way, by its own
scores.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from aisqlbench import tokens

BIG = 1e9


def logit_of(score: float) -> float:
    """d from a SCORE s = 1 / (1 + exp(-d))."""
    if not 0.0 < score < 1.0:
        return math.copysign(BIG, score - 0.5)
    return math.log(score / (1.0 - score))


def d_of(logits: torch.Tensor) -> float:
    """logit(yes) - logit(no) of one position's logits [V]."""
    return float(logits[tokens.YES_ID] - logits[tokens.NO_ID])


def score_numbers(rows: List[Dict], ref_logits: List[torch.Tensor],
                  tie: float) -> Dict[str, float]:
    gap, wrong = 0.0, 0
    for r, lg in zip(rows, ref_logits):
        d_ref = d_of(lg[-1])
        gap = max(gap, abs(r["d"] - d_ref))
        if r["kept"] != (d_ref >= 0.0) and abs(d_ref) > tie:
            wrong += 1
    return {"score_gap": gap, "rows_wrong": float(wrong)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Optional[bool]:
    """True when every number lies within its limit; None when a number
    has no limit (a cell being measured)."""
    if any(n not in limits for n in numbers):
        return None
    return all(numbers[n] <= limits[n] for n in numbers)
