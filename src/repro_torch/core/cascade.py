"""Adaptive model cascades for AI_FILTER (paper §5.2) — SUPG-IT.

A lightweight *proxy* model scores every row; two learned thresholds
(τ_low, τ_high) partition rows into reject / uncertainty / accept regions;
only the uncertainty region is escalated to the *oracle* model.

The thresholds are learned **online** (streaming, per worker, no
inter-worker communication — the paper's distributed design):

  * within each batch a budget fraction ρ of rows is sampled for oracle
    labeling via importance sampling with weights ∝ sqrt(s_i), mixed with
    a uniform component for coverage;
  * τ_low comes from a weighted ROC curve with a sampling-corrected recall
    target (lower confidence bound on recall ≥ target);
  * τ_high is the minimum threshold whose statistical *lower bound* on
    precision meets the precision target;
  * as oracle labels accumulate across batches the confidence bounds
    tighten and the uncertainty region narrows.

Rows still inside [τ_low, τ_high) are routed to the oracle if the oracle
budget permits; otherwise the proxy prediction (s ≥ 0.5) is the fallback.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CascadeConfig:
    recall_target: float = 0.90
    precision_target: float = 0.90
    sample_budget_frac: float = 0.10   # ρ: oracle labels per batch (learning)
    oracle_budget_frac: float = 0.50   # cap on total oracle calls / total rows
    uniform_mix: float = 0.25          # α: uniform mass in the sampling dist
    delta: float = 0.05                # 1-δ confidence for the bounds
    batch_size: int = 256
    min_samples: int = 16              # below this: route everything to oracle
    max_learning_samples: int = 384    # stop importance sampling once the
    #                                    bounds are tight (uncertainty region
    #                                    narrows as labels accumulate — §5.2)
    seed: int = 0


@dataclasses.dataclass
class CascadeStats:
    rows: int = 0
    proxy_calls: int = 0
    oracle_calls: int = 0
    sampled_for_learning: int = 0
    accepted_by_proxy: int = 0
    rejected_by_proxy: int = 0
    uncertain_to_oracle: int = 0
    uncertain_fallback: int = 0
    tau_low: float = 0.0
    tau_high: float = 1.0

    @property
    def delegation_rate(self) -> float:
        """Oracle escalations per routed row.  The executor folds this
        into the `StatsStore` after each query; once it is observed near
        1.0 the runtime bypasses the cascade entirely (the proxy is not
        separating this predicate) — see ``ExecConfig.
        cascade_bypass_delegation``."""
        return self.oracle_calls / max(self.rows, 1)


def _norm_lcb(mean: float, var: float, n: float, delta: float) -> float:
    """Normal-approximation lower confidence bound on a weighted mean."""
    if n <= 1:
        return 0.0
    z = _z_of(delta)
    return mean - z * math.sqrt(max(var, 1e-12) / n)


def _z_of(delta: float) -> float:
    # inverse normal CDF via Acklam-lite rational approx (delta in (0, 0.5])
    p = 1.0 - delta
    # Beasley-Springer-Moro
    a = [2.50662823884, -18.61500062529, 41.39119773534, -25.44106049637]
    b = [-8.47351093090, 23.08336743743, -21.06224101826, 3.13082909833]
    c = [0.3374754822726147, 0.9761690190917186, 0.1607979714918209,
         0.0276438810333863, 0.0038405729373609, 0.0003951896511919,
         0.0000321767881768, 0.0000002888167364, 0.0000003960315187]
    y = p - 0.5
    if abs(y) < 0.42:
        r = y * y
        num = y * (((a[3] * r + a[2]) * r + a[1]) * r + a[0])
        den = (((b[3] * r + b[2]) * r + b[1]) * r + b[0]) * r + 1.0
        return num / den
    r = p if y > 0 else 1.0 - p
    r = math.log(-math.log(1.0 - r))
    x = c[0]
    for i in range(1, 9):
        x += c[i] * r ** i
    return x if y > 0 else -x


class SupgItCascade:
    """Streaming two-threshold learner + router (one instance per worker)."""

    def __init__(self, cfg: Optional[CascadeConfig] = None):
        self.cfg = cfg or CascadeConfig()
        self._rng = np.random.default_rng(self.cfg.seed)
        # accumulated oracle-labelled sample: scores, labels, importance wts
        self._s: List[float] = []
        self._y: List[bool] = []
        self._w: List[float] = []
        self.tau_low = 0.0
        self.tau_high = 1.0
        self.stats = CascadeStats(tau_low=0.0, tau_high=1.0)

    # ------------------------------------------------------------------
    # threshold learning
    # ------------------------------------------------------------------

    def _sample_for_labels(self, scores: np.ndarray) -> np.ndarray:
        """Importance sample indices (w ∝ sqrt(s), uniform-mixed)."""
        n = len(scores)
        m = max(1, int(round(self.cfg.sample_budget_frac * n)))
        m = min(m, n)
        imp = np.sqrt(np.clip(scores, 1e-6, 1.0))
        imp = imp / imp.sum()
        p = (1 - self.cfg.uniform_mix) * imp + self.cfg.uniform_mix / n
        p = p / p.sum()
        idx = self._rng.choice(n, size=m, replace=False, p=p)
        # Horvitz-Thompson style weights for the *sampling distribution*
        self._batch_weights = 1.0 / (n * p[idx])
        return idx

    def observe(self, scores: np.ndarray, labels: np.ndarray,
                weights: Optional[np.ndarray] = None) -> None:
        """Fold oracle-labelled (score, label) pairs into the estimator."""
        w = np.ones(len(scores)) if weights is None else weights
        self._s.extend(float(x) for x in scores)
        self._y.extend(bool(x) for x in labels)
        self._w.extend(float(x) for x in w)
        self._refit()

    def _refit(self) -> None:
        if len(self._s) < self.cfg.min_samples:
            return
        s = np.asarray(self._s)
        y = np.asarray(self._y, dtype=bool)
        w = np.asarray(self._w)
        order = np.argsort(s)                       # ascending score
        s, y, w = s[order], y[order], w[order]
        self.tau_low = self._fit_tau_low(s, y, w)
        self.tau_high = self._fit_tau_high(s, y, w)
        if self.tau_high < self.tau_low:            # degenerate: collapse
            mid = 0.5 * (self.tau_high + self.tau_low)
            self.tau_low = self.tau_high = mid
        self.stats.tau_low = self.tau_low
        self.stats.tau_high = self.tau_high

    def _fit_tau_low(self, s, y, w) -> float:
        """Largest τ with (sampling-corrected) recall above τ ≥ target.

        Weighted recall(τ) = Σ{w·y·[s ≥ τ]} / Σ{w·y}.  We take a conservative
        margin: effective sample size based normal correction.
        """
        wy = w * y
        total_pos = wy.sum()
        if total_pos <= 0:
            return 0.0
        # cumulative positive mass ABOVE each candidate threshold
        rev_cum = np.cumsum(wy[::-1])[::-1]          # mass at index >= i
        recall = rev_cum / total_pos
        n_eff = (w.sum() ** 2) / max((w ** 2).sum(), 1e-12)
        z = _z_of(self.cfg.delta)
        margin = z * np.sqrt(np.clip(recall * (1 - recall), 0, None)
                             / max(n_eff, 1.0))
        ok = (recall - margin) >= self.cfg.recall_target
        if not ok.any():
            return 0.0
        # largest threshold index where corrected recall still meets target
        i = int(np.max(np.nonzero(ok)[0]))
        return float(s[i])

    def _fit_tau_high(self, s, y, w) -> float:
        """Minimum τ whose precision lower bound meets the target."""
        wy = w * y
        rev_w = np.cumsum(w[::-1])[::-1]
        rev_wy = np.cumsum(wy[::-1])[::-1]
        prec = rev_wy / np.maximum(rev_w, 1e-12)
        # effective n above each threshold
        rev_w2 = np.cumsum((w ** 2)[::-1])[::-1]
        n_eff = (rev_w ** 2) / np.maximum(rev_w2, 1e-12)
        var = np.clip(prec * (1 - prec), 1e-6, None)
        z = _z_of(self.cfg.delta)
        lcb = prec - z * np.sqrt(var / np.maximum(n_eff, 1.0))
        ok = lcb >= self.cfg.precision_target
        if not ok.any():
            return 1.0 + 1e-9                        # accept nothing
        i = int(np.min(np.nonzero(ok)[0]))
        return float(s[i])

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def run(self,
            rows: Sequence,
            proxy_score_fn: Callable[[Sequence], np.ndarray],
            oracle_label_fn: Callable[[Sequence], np.ndarray],
            ) -> np.ndarray:
        """Filter a stream of rows; returns boolean predictions.

        ``proxy_score_fn(batch_rows) -> s_i``; ``oracle_label_fn(batch_rows)
        -> bool labels``.  Batches are processed independently; threshold
        state carries across batches (streaming).
        """
        rows = list(rows)
        n_total = len(rows)
        out = np.zeros(n_total, dtype=bool)
        bs = self.cfg.batch_size
        for lo in range(0, n_total, bs):
            hi = min(lo + bs, n_total)
            batch = rows[lo:hi]
            scores = np.asarray(proxy_score_fn(batch), dtype=np.float64)
            self.stats.rows += len(batch)
            self.stats.proxy_calls += len(batch)
            # streaming budget: the instance may serve many run() calls
            # (the executor feeds row chunks); the cap tracks rows *seen*.
            oracle_budget = int(
                math.ceil(self.cfg.oracle_budget_frac * self.stats.rows))

            # --- importance sample for threshold learning ---
            remaining_budget = oracle_budget - self.stats.oracle_calls
            sampled_idx = np.asarray([], dtype=int)
            sampled_labels = np.asarray([], dtype=bool)
            if (remaining_budget > 0
                    and len(self._s) < self.cfg.max_learning_samples):
                sampled_idx = self._sample_for_labels(scores)
                sampled_idx = sampled_idx[:remaining_budget]
                if len(sampled_idx):
                    sampled_labels = np.asarray(
                        oracle_label_fn([batch[i] for i in sampled_idx]),
                        dtype=bool)
                    self.stats.oracle_calls += len(sampled_idx)
                    self.stats.sampled_for_learning += len(sampled_idx)
                    self.observe(scores[sampled_idx], sampled_labels,
                                 self._batch_weights[:len(sampled_idx)])

            ready = len(self._s) >= self.cfg.min_samples
            if ready:
                accept = scores >= self.tau_high
                reject = scores < self.tau_low
                uncertain = ~(accept | reject)
            else:
                # cold start: no trusted thresholds — everything is uncertain
                # (routed to the oracle while budget permits)
                accept = np.zeros(len(batch), dtype=bool)
                reject = np.zeros(len(batch), dtype=bool)
                uncertain = np.ones(len(batch), dtype=bool)

            pred = np.zeros(len(batch), dtype=bool)
            pred[accept] = True
            self.stats.accepted_by_proxy += int(accept.sum())
            self.stats.rejected_by_proxy += int(reject.sum())

            # reuse labels already bought for learning
            known = dict(zip(sampled_idx.tolist(), sampled_labels.tolist()))
            unc_idx = np.nonzero(uncertain)[0]
            need = [i for i in unc_idx if i not in known]
            for i in unc_idx:
                if i in known:
                    pred[i] = known[i]
            remaining_budget = (oracle_budget - self.stats.oracle_calls
                                if len(self._s) >= self.cfg.min_samples
                                else len(need))   # cold start: always escalate
            to_oracle = need[:max(remaining_budget, 0)]
            fallback = need[len(to_oracle):]
            if to_oracle:
                labels = np.asarray(
                    oracle_label_fn([batch[i] for i in to_oracle]), dtype=bool)
                for i, lb in zip(to_oracle, labels):
                    pred[i] = lb
                self.stats.oracle_calls += len(to_oracle)
                self.stats.uncertain_to_oracle += len(to_oracle)
                # uncertainty-region labels also inform the thresholds
                # (weight 1: they were deterministically selected)
                self.observe(scores[to_oracle], labels)
            for i in fallback:
                pred[i] = scores[i] >= 0.5
            self.stats.uncertain_fallback += len(fallback)
            out[lo:hi] = pred
        return out


# ---------------------------------------------------------------------------
# Calibration-based cascade (the complementary algorithm in [21]):
# fit a reliability curve on accumulated oracle labels, then choose static
# thresholds from the calibrated probabilities.  Used for ablations.
# ---------------------------------------------------------------------------


class CalibratedCascade:
    """Isotonic-calibration cascade: calibrate proxy scores on a warmup
    sample, then set thresholds where the *calibrated* probability crosses
    the precision / (1-recall) targets."""

    def __init__(self, cfg: Optional[CascadeConfig] = None):
        self.cfg = cfg or CascadeConfig()
        self._rng = np.random.default_rng(self.cfg.seed)
        self.stats = CascadeStats()

    @staticmethod
    def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
        """Pool-adjacent-violators: weighted isotonic regression."""
        y = y.astype(np.float64)
        w = w.astype(np.float64)
        n = len(y)
        # classic stack-based PAVA
        vals: List[float] = []
        wts: List[float] = []
        counts: List[int] = []
        for i in range(n):
            vals.append(y[i])
            wts.append(w[i])
            counts.append(1)
            while len(vals) > 1 and vals[-2] > vals[-1]:
                v = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / (wts[-2] + wts[-1])
                wt = wts[-2] + wts[-1]
                c = counts[-2] + counts[-1]
                vals = vals[:-2] + [v]
                wts = wts[:-2] + [wt]
                counts = counts[:-2] + [c]
        out = np.empty(n)
        pos = 0
        for v, c in zip(vals, counts):
            out[pos:pos + c] = v
            pos += c
        return out

    def run(self, rows, proxy_score_fn, oracle_label_fn) -> np.ndarray:
        rows = list(rows)
        n = len(rows)
        out = np.zeros(n, dtype=bool)
        scores = np.asarray(proxy_score_fn(rows), dtype=np.float64)
        self.stats.rows += n
        self.stats.proxy_calls += n
        m = max(self.cfg.min_samples,
                int(round(self.cfg.sample_budget_frac * n)))
        m = min(m, n)
        warm = self._rng.choice(n, size=m, replace=False)
        labels = np.asarray(oracle_label_fn([rows[i] for i in warm]),
                            dtype=bool)
        self.stats.oracle_calls += m
        order = np.argsort(scores[warm])
        cal = self._pava(labels[order].astype(float), np.ones(m))
        s_sorted = scores[warm][order]
        # calibrated probability for each row by interpolation
        p = np.interp(scores, s_sorted, cal, left=cal[0], right=cal[-1])
        tau_high_p = self.cfg.precision_target
        tau_low_p = 1.0 - self.cfg.recall_target
        accept = p >= tau_high_p
        reject = p < tau_low_p
        uncertain = ~(accept | reject)
        out[accept] = True
        known = dict(zip(warm.tolist(), labels.tolist()))
        need = [i for i in np.nonzero(uncertain)[0] if i not in known]
        for i in np.nonzero(uncertain)[0]:
            if i in known:
                out[i] = known[i]
        budget = int(math.ceil(self.cfg.oracle_budget_frac * n))
        to_oracle = need[:max(budget - self.stats.oracle_calls, 0)]
        if to_oracle:
            lb = np.asarray(oracle_label_fn([rows[i] for i in to_oracle]),
                            dtype=bool)
            for i, v in zip(to_oracle, lb):
                out[i] = v
            self.stats.oracle_calls += len(to_oracle)
            self.stats.uncertain_to_oracle += len(to_oracle)
        for i in need[len(to_oracle):]:
            out[i] = scores[i] >= 0.5
            self.stats.uncertain_fallback += 1
        self.stats.accepted_by_proxy += int(accept.sum())
        self.stats.rejected_by_proxy += int(reject.sum())
        return out
