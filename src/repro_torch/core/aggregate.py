"""AI_AGG / AI_SUMMARIZE_AGG — hierarchical aggregation (paper §3.5, Alg. 1)
with the §5.4 short-circuit.

Three LLM phases over a text column that exceeds any context window:

  Extract(R)   — key information from a batch of rows -> intermediate state
  Combine(S)   — recursively merge intermediate states
  Summarize(s) — final user-facing text

``BATCH_SIZE`` is a token budget; rows are accumulated until the buffer
exceeds it.  The short-circuit detects inputs that fit in one context
window and performs a single Summarize call (−86.1 % latency on small
groups in the paper).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.inference.api import CortexClient


def _tokens(text: str) -> int:
    return max(len(text) // 4, 1)


@dataclasses.dataclass
class AggConfig:
    batch_size_tokens: int = 2048      # BATCH_SIZE of Algorithm 1
    context_window_tokens: int = 3072  # short-circuit threshold
    short_circuit: bool = True
    model: Optional[str] = None
    max_tokens_out: int = 96


@dataclasses.dataclass
class AggTelemetry:
    extract_calls: int = 0
    combine_calls: int = 0
    summarize_calls: int = 0
    short_circuited: bool = False

    @property
    def llm_calls(self) -> int:
        return self.extract_calls + self.combine_calls + self.summarize_calls


_EXTRACT_TMPL = ("Extract the key information relevant to the task from the "
                 "following rows.{task}\nRows:\n{rows}")
_COMBINE_TMPL = ("Combine these intermediate notes, discarding redundant "
                 "information.{task}\nNotes:\n{states}")
_SUMMARIZE_TMPL = ("Produce the final aggregate answer.{task}\nNotes:\n{state}")


class HierarchicalAggregator:
    """Implements Algorithm 1 (incremental fold with bounded buffers)."""

    def __init__(self, client: CortexClient, cfg: Optional[AggConfig] = None):
        self.client = client
        self.cfg = cfg or AggConfig()
        self.telemetry = AggTelemetry()

    # ------------------------------------------------------------------
    def _task_clause(self, instruction: Optional[str]) -> str:
        return f"\nTask: {instruction}" if instruction else ""

    def _extract_all(self, buffers: List[List[str]], instruction
                     ) -> List[str]:
        """One batched Extract pass over every row buffer (buffer
        boundaries are pure token arithmetic, so all Extract calls are
        independent and ride a single engine batch)."""
        prompts = [_EXTRACT_TMPL.format(task=self._task_clause(instruction),
                                        rows="\n".join(rows))
                   for rows in buffers]
        self.telemetry.extract_calls += len(prompts)
        return self.client.complete(prompts, model=self.cfg.model,
                                    max_tokens=self.cfg.max_tokens_out)

    def _combine(self, states: List[str], instruction) -> List[str]:
        """Merge as many states as fit one context window per call."""
        out: List[str] = []
        group: List[str] = []
        budget = self.cfg.context_window_tokens
        used = 0
        prompts: List[str] = []
        for s in states:
            t = _tokens(s)
            if group and used + t > budget:
                prompts.append(_COMBINE_TMPL.format(
                    task=self._task_clause(instruction),
                    states="\n".join(group)))
                group, used = [], 0
            group.append(s)
            used += t
        if group:
            prompts.append(_COMBINE_TMPL.format(
                task=self._task_clause(instruction), states="\n".join(group)))
        self.telemetry.combine_calls += len(prompts)
        return self.client.complete(prompts, model=self.cfg.model,
                                    max_tokens=self.cfg.max_tokens_out)

    def _summarize(self, state: str, instruction) -> str:
        self.telemetry.summarize_calls += 1
        prompt = _SUMMARIZE_TMPL.format(task=self._task_clause(instruction),
                                        state=state)
        return self.client.complete([prompt], model=self.cfg.model,
                                    max_tokens=self.cfg.max_tokens_out)[0]

    # ------------------------------------------------------------------
    def aggregate(self, texts: Sequence[str],
                  instruction: Optional[str] = None) -> str:
        """Algorithm 1 as a batched three-phase fold.

        Rows are partitioned into BATCH_SIZE-bounded buffers up front (a
        pure token computation), so the Extract phase is ONE batched LLM
        call over all buffers instead of a sequential per-buffer fold;
        Combine then reduces the intermediate states level by level (each
        level one batched call).  Call counts match the incremental fold;
        the batching is what lets the request pipeline coalesce an entire
        aggregation into a handful of engine batches.
        """
        texts = [str(t) for t in texts]
        self.telemetry = AggTelemetry()
        total = sum(_tokens(t) for t in texts)
        # §5.4 short-circuit: the whole input fits one context window
        if self.cfg.short_circuit and total <= self.cfg.context_window_tokens:
            self.telemetry.short_circuited = True
            return self._summarize("\n".join(texts), instruction)

        # phase 1: partition rows into token-budget buffers, batch-extract
        buffers: List[List[str]] = []
        cur: List[str] = []
        used = 0
        for t in texts:
            if cur and used + _tokens(t) > self.cfg.batch_size_tokens:
                buffers.append(cur)
                cur, used = [], 0
            cur.append(t)
            used += _tokens(t)
        if cur:
            buffers.append(cur)
        S = self._extract_all(buffers, instruction)
        # phase 2: combine tree.  The naive three-phase path always invokes
        # Combine at least once (the per-phase API overhead the §5.4
        # short-circuit eliminates).
        S = self._combine(S, instruction)
        while len(S) > 1:
            nxt = self._combine(S, instruction)
            if len(nxt) >= len(S):      # states no longer shrink: force-merge
                nxt = ["\n".join(nxt)]
            S = nxt
        return self._summarize(S[0], instruction)
