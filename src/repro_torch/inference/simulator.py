"""Calibrated simulated backend for quality experiments.

The cascade (§6.2) and join-rewrite (§6.3) evaluations need ground-truth
labels and a *realistic proxy-confidence distribution*; with no network
access the HuggingFace datasets are recreated synthetically (repro.data)
and this backend plays the role of the LLMs:

  * SCORE:  s_i ~ Beta mixture conditioned on the true label.  The mixture
    parameters are per-"dataset difficulty" (passed in request metadata),
    calibrated so proxy-only accuracy lands where the paper's Table 2 puts
    Llama-3.1-8B, and oracle error rates where Llama-3.3-70B lands.
  * CLASSIFY: the model answers correctly with prob (1 - err); errors are
    drawn from the remaining candidates.  Multi-label adds per-label
    drop/add noise — reproducing the precision/recall trade-offs of §6.3.
  * COMPLETE: template completion (used for AI_AGG/SUMMARIZE text paths).
  * EMBED: deterministic topic-correlated unit vectors — word-bag anchor
    mixtures by default, ground-truth-anchored when the request metadata
    carries ``truth_labels`` / ``embed_anchor`` (the semantic-index
    analogue of the SCORE path's ``truth``).  Billed at the per-kind
    embedding rate through the same meters, and fault-injectable like
    every other kind (the fault die rolls before any request is served).

Latency/cost model: per-request latency = base + tokens * per_token, with
constants measured from the real JAX engine and scaled by model size, so
simulated "execution time" stays tied to compute reality.  Determinism:
every random draw is keyed by (seed, request fingerprint).
"""
from __future__ import annotations

import hashlib
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED, SCORE,
                                     EngineFailure, EngineTimeout, Request,
                                     Result, credits_for)

# model quality/latency profiles: (error_rate_scale, seconds per 1k tokens)
# latency constants derive from bf16 FLOPs at 197 TFLOP/s/chip with 60% MFU
# over 8 chips — the per-model ratios are what matters for speedup numbers.
MODEL_PROFILES: Dict[str, Dict[str, float]] = {
    "proxy-8b": {"err_scale": 1.0, "s_per_ktok": 0.017},
    "oracle-70b": {"err_scale": 0.28, "s_per_ktok": 0.149},
    "minitron-8b": {"err_scale": 1.0, "s_per_ktok": 0.017},
    "qwen3-32b": {"err_scale": 0.45, "s_per_ktok": 0.068},
    "command-r-35b": {"err_scale": 0.42, "s_per_ktok": 0.074},
    "stablelm-12b": {"err_scale": 0.8, "s_per_ktok": 0.026},
    "recurrentgemma-9b": {"err_scale": 0.95, "s_per_ktok": 0.019},
    "phi3.5-moe-42b-a6.6b": {"err_scale": 0.55, "s_per_ktok": 0.014},
    "qwen2-moe-a2.7b": {"err_scale": 1.2, "s_per_ktok": 0.006},
    "qwen2-vl-7b": {"err_scale": 0.9, "s_per_ktok": 0.080},
    "rwkv6-1.6b": {"err_scale": 1.5, "s_per_ktok": 0.004},
    "whisper-base": {"err_scale": 1.0, "s_per_ktok": 0.002},
    # EMBED-class models: a single encoder pass, no decode loop
    "arctic-embed-m": {"err_scale": 1.0, "s_per_ktok": 0.003},
    "e5-base-embed": {"err_scale": 1.0, "s_per_ktok": 0.004},
}

# default dimensionality of simulated embeddings (overridable per request
# via metadata["embed_dim"]); 64 keeps random anchors near-orthogonal
# (cos ~ N(0, 1/64)) while staying cheap for the kernel path
EMBED_DIM = 64
# Per-request overhead is model-proportional: a fixed-depth decode/launch
# cost equivalent to ~64 tokens of that model's throughput, plus a small
# model-independent scheduling constant.
BASE_OVERHEAD_TOKENS = 64
SCHED_LATENCY_S = 0.001


def _rng_for(seed: int, *parts) -> np.random.Generator:
    h = hashlib.sha256(("|".join(str(p) for p in parts)).encode()).digest()
    return np.random.default_rng([seed, int.from_bytes(h[:8], "little")])


class SimulatedBackend:
    """Drop-in InferenceBackend with calibrated quality + compute-tied cost.

    ``clock`` accumulates modelled serving seconds (batch-aware: requests in
    one submit_batch share engine throughput).

    Transient-fault injection (the production retry path's test rig):
    with ``fault_rate`` / ``timeout_rate`` > 0 each ``submit_batch`` call
    rolls a deterministic die (keyed by seed and a per-backend attempt
    counter, so retries of the same batch re-roll) and raises
    `EngineFailure` / `EngineTimeout` **before any request is served or
    billed** — a faulted batch costs nothing, so retry layers can never
    double-bill.  Result draws stay keyed by request fingerprint, so a
    successful retry returns bit-identical answers to a fault-free run.
    """

    def __init__(self, models: Optional[Sequence[str]] = None, *, seed: int = 0,
                 batch_parallelism: int = 8, fault_rate: float = 0.0,
                 timeout_rate: float = 0.0, fault_seed: Optional[int] = None,
                 fault_burst_every: int = 0, fault_burst_len: int = 0):
        self.models = list(models or MODEL_PROFILES)
        self.seed = seed
        self.batch_parallelism = batch_parallelism
        self.fault_rate = float(fault_rate)
        self.timeout_rate = float(timeout_rate)
        self.fault_seed = seed if fault_seed is None else fault_seed
        # bursty fault process (production outages cluster in time): with
        # fault_burst_every > 0 the fault/timeout die only rolls during
        # the first fault_burst_len attempts of each fault_burst_every
        # window of the attempt counter; service is clean in between
        self.fault_burst_every = int(fault_burst_every)
        self.fault_burst_len = int(fault_burst_len)
        self.clock_s = 0.0
        self.total_credits = 0.0
        self.calls_by_model: Dict[str, int] = {}
        self.faults_injected = 0
        self.timeouts_injected = 0
        self._fault_attempts = 0
        # meters and the attempt counter are mutated per submit_batch;
        # concurrent serving dispatches serialize here
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def hosted_models(self) -> List[str]:
        return list(self.models)

    def capacity_hint(self) -> int:
        """Preferred per-dispatch batch size (scheduler right-sizing):
        modelled parallel slots × a queueing factor."""
        return self.batch_parallelism * 32

    def submit_batch(self, requests: Sequence[Request]) -> List[Result]:
        with self._lock:
            return self._submit_batch_locked(requests)

    def _maybe_inject_fault(self) -> None:
        """Raise a transient failure/timeout *before* serving or billing
        anything — all-or-nothing per batch, deterministic per attempt."""
        if not (self.fault_rate or self.timeout_rate):
            return
        self._fault_attempts += 1
        if self.fault_burst_every > 0:
            phase = (self._fault_attempts - 1) % self.fault_burst_every
            if phase >= self.fault_burst_len:
                return          # between bursts: clean service
        rng = _rng_for(self.fault_seed, "fault", self._fault_attempts)
        u = rng.random()
        if u < self.fault_rate:
            self.faults_injected += 1
            raise EngineFailure(
                f"injected transient fault (attempt {self._fault_attempts})")
        if u < self.fault_rate + self.timeout_rate:
            self.timeouts_injected += 1
            raise EngineTimeout(
                f"injected timeout (attempt {self._fault_attempts})")

    def _submit_batch_locked(self, requests: Sequence[Request]
                             ) -> List[Result]:
        self._maybe_inject_fault()
        out: List[Result] = []
        batch_s = 0.0
        for r in requests:
            prof = MODEL_PROFILES.get(r.model, MODEL_PROFILES["proxy-8b"])
            ntok = max(len(r.prompt) // 4, 8)
            if r.kind == CLASSIFY and r.labels:
                ntok += sum(len(l) // 4 + 2 for l in r.labels)
            lat = (SCHED_LATENCY_S + prof["s_per_ktok"]
                   * (ntok + BASE_OVERHEAD_TOKENS) / 1e3)
            res = self._serve_one(r, prof, ntok)
            res.latency_s = lat
            res.credits = credits_for(r.model, ntok, r.kind)
            out.append(res)
            batch_s += lat
            self.total_credits += res.credits
            self.calls_by_model[r.model] = self.calls_by_model.get(r.model, 0) + 1
        # batched execution amortises across parallel slots
        self.clock_s += batch_s / self.batch_parallelism
        return out

    # ------------------------------------------------------------------
    def _serve_one(self, r: Request, prof, ntok: int) -> Result:
        rng = _rng_for(self.seed, r.model, r.kind, r.prompt)
        md = r.metadata
        if r.kind == EMBED:
            vec = self._embed(r)
            return Result(r.request_id, r.model, EMBED,
                          embedding=tuple(float(x) for x in vec),
                          tokens_in=ntok)
        if r.kind == SCORE and ("fp_bias" in md or "fn_bias" in md):
            # explicit error-bias calibration (semantic-join pair predicates):
            # a negative pair reads as positive with prob fp_bias (the
            # systematic yes-bias of isolated binary decisions, §6.3) and a
            # positive reads as negative with prob fn_bias.
            truth = bool(md.get("truth", False))
            flip = float(md.get("fn_bias", 0.0)) if truth else \
                float(md.get("fp_bias", 0.0))
            eff = truth ^ (rng.random() < flip)
            conc = 14.0
            s = rng.beta(conc, 1.0) if eff else rng.beta(1.0, conc)
            return Result(r.request_id, r.model, SCORE, score=float(s),
                          tokens_in=ntok)
        if r.kind == SCORE:
            truth = bool(md.get("truth", rng.random() < 0.5))
            difficulty = float(md.get("difficulty", 0.3))
            # hardness of this particular row (some rows are intrinsically
            # ambiguous for every model — shared via the row fingerprint)
            row_rng = _rng_for(self.seed + 1, "row", r.prompt)
            hard = row_rng.random() < difficulty
            err = difficulty * prof["err_scale"]
            if hard:
                # ambiguous rows: scores near the middle, weakly informative;
                # stronger models (lower err_scale) skew toward the truth side
                boost = (1.0 / max(prof["err_scale"], 0.3)) ** 0.5
                if truth:
                    s = rng.beta(2.2 * boost, 1.8)
                else:
                    s = rng.beta(1.8, 2.2 * boost)
            else:
                conc = 9.0 / max(prof["err_scale"], 0.2)
                s = rng.beta(conc, 1.0) if truth else rng.beta(1.0, conc)
            wrong = rng.random() < err * (0.8 if hard else 0.15)
            if wrong:
                s = 1.0 - s
            return Result(r.request_id, r.model, SCORE, score=float(s),
                          tokens_in=ntok)
        if r.kind == CLASSIFY:
            labels = list(r.labels or ())
            truth_labels = md.get("truth_labels")
            err = min(0.95, float(md.get("difficulty", 0.25)) *
                      prof["err_scale"])
            if truth_labels is None:
                chosen = [labels[rng.integers(len(labels))]] if labels else []
            elif r.multi_label and ("drop_prob" in md or "add_frac" in md):
                # explicit calibration for the §6.3 rewrite: each true label
                # is kept with prob 1-drop (conservative-selection recall
                # loss); each false candidate is added with prob add_frac
                # (comparative reasoning keeps the count low and independent
                # of the candidate-set size).  Every draw is keyed by the
                # (prompt, label) pair — not the candidate-set composition —
                # so classifying over a *subset* of the labels (the semantic
                # index's candidate pruning) returns exactly the full run's
                # decisions restricted to that subset.
                drop = float(md.get("drop_prob", 0.0))
                add = float(md.get("add_frac", 0.0))
                chosen = []
                for lb in labels:
                    lrng = _rng_for(self.seed, r.model, r.kind, r.prompt,
                                    "label", lb)
                    if lb in truth_labels:
                        if lrng.random() >= drop:
                            chosen.append(lb)
                    elif lrng.random() < add:
                        chosen.append(lb)
            elif r.multi_label:
                chosen = []
                for lb in labels:
                    if lb in truth_labels:
                        # multi-label recall penalty: conservative selection
                        keep = rng.random() > (err + float(md.get(
                            "recall_penalty", 0.0)))
                        if keep:
                            chosen.append(lb)
                    else:
                        if rng.random() < err * 0.08:
                            chosen.append(lb)
                if not chosen and labels:
                    chosen = [labels[rng.integers(len(labels))]]
            else:
                tl = [t for t in truth_labels if t in labels]
                if tl and rng.random() >= err:
                    chosen = [tl[0]]
                else:
                    pool = [l for l in labels if l not in truth_labels] or labels
                    chosen = [pool[rng.integers(len(pool))]]
            return Result(r.request_id, r.model, CLASSIFY,
                          label=(chosen[0] if chosen else None),
                          labels=tuple(chosen), tokens_in=ntok)
        # COMPLETE with an "nl2sql" grounding block: NL->AISQL
        # compilation — answer with the verified query whose question
        # matches, sometimes corrupted so the caller's validation loop
        # is exercised (a retry re-prompts with feedback, which changes
        # the rng key and usually repairs the draw)
        if md.get("nl2sql"):
            return self._serve_nl2sql(r, prof, rng, ntok)
        # COMPLETE: deterministic template text (extract/combine/summarize)
        text = md.get("canned") or _template_completion(r.prompt)
        return Result(r.request_id, r.model, COMPLETE, text=text,
                      tokens_in=ntok, tokens_out=max(len(text) // 4, 1))

    def _serve_nl2sql(self, r: Request, prof, rng, ntok: int) -> Result:
        spec = r.metadata["nl2sql"]
        question = str(spec.get("question", "")).lower()
        qtok = set(re.findall(r"[a-z0-9_]+", question))
        best_sql, best_score = "SELECT 1", -1.0
        for ex in spec.get("examples", ()):
            etok = set(re.findall(
                r"[a-z0-9_]+", str(ex.get("question", "")).lower()))
            score = len(qtok & etok) / max(len(etok), 1)
            if score > best_score:
                best_sql, best_score = str(ex.get("sql", "")), score
        err = min(0.9, float(spec.get("difficulty", 0.15))
                  * prof["err_scale"])
        sql = best_sql
        if rng.random() < err:
            # corruptions are always *invalid* SQL — either untokenizable
            # (ParseError) or referencing a column no catalog has
            # (semantic rejection) — so a query that passes validation
            # is always the grounded-truth answer
            if rng.random() < 0.5:
                sql = sql + " ???"
            else:
                sql = re.sub(r"(?i)^\s*SELECT\s",
                             "SELECT no_such_column_xx, ", sql, count=1)
        return Result(r.request_id, r.model, COMPLETE,
                      text=f"```sql\n{sql}\n```",
                      tokens_in=ntok, tokens_out=max(len(sql) // 4, 1))

    # ------------------------------------------------------------------
    # EMBED: deterministic topic-correlated unit vectors
    # ------------------------------------------------------------------

    def _anchor(self, key: str, dim: int) -> np.ndarray:
        """Fixed unit vector for a topic/label/word string — shared by
        every request (and every model), so two texts about the same
        topic land near each other in embedding space."""
        v = _rng_for(self.seed, "embed-anchor", key).standard_normal(dim)
        n = np.linalg.norm(v)
        return v / max(n, 1e-12)

    def _embed(self, r: Request) -> np.ndarray:
        """Deterministic embedding of ``r.prompt``.

        Grounding mirrors the SCORE/CLASSIFY paths: when the request's
        metadata carries ``truth_labels`` (the hidden ``_labels`` column)
        the vector is the normalized mean of those labels' anchors plus
        small noise — so a document sits close to exactly its true labels
        and the index's kNN candidates recover the ground-truth pairs.
        Without truth metadata the vector is a word-bag mixture of
        per-word anchors: texts sharing vocabulary are similar, arbitrary
        texts are near-orthogonal.  Every component is keyed by
        (seed, text), so results are bit-identical across retries and
        across the dedup cache.
        """
        md = r.metadata
        dim = int(md.get("embed_dim", EMBED_DIM))
        noise_scale = float(md.get("embed_noise", 0.05))
        anchor_key = md.get("embed_anchor")
        tl = md.get("truth_labels")
        if anchor_key is not None:
            # label/category rows: the text *is* the topic (the semantic
            # index manager marks the label side of a join this way)
            vec = self._anchor(str(anchor_key), dim)
        elif tl is not None:
            tl = list(tl) if isinstance(tl, (tuple, list, set)) else [tl]
            vec = np.zeros(dim)
            for lb in tl:
                vec += self._anchor(str(lb), dim)
        else:
            words = r.prompt.split()
            vec = np.zeros(dim)
            for w in dict.fromkeys(words):      # distinct words, kept order
                vec += self._anchor(w.lower(), dim) * words.count(w)
        vec = vec / max(np.linalg.norm(vec), 1e-12)
        noise = _rng_for(self.seed, "embed-noise",
                         r.prompt).standard_normal(dim)
        noise = noise / max(np.linalg.norm(noise), 1e-12)
        # bounded angular perturbation: noise_scale ~ radians off-axis
        vec = vec + noise_scale * noise
        return vec / max(np.linalg.norm(vec), 1e-12)


def _template_completion(prompt: str) -> str:
    head = prompt.strip().splitlines()[-1][:80] if prompt.strip() else ""
    digest = hashlib.sha256(prompt.encode()).hexdigest()[:8]
    return f"[{digest}] {head}"
