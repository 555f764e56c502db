"""Inference request/result types and the backend protocol.

Everything above this line (AISQL executor, cascades, join rewrite) talks to
``InferenceBackend.submit_batch`` only — the real engines (JAX or PyTorch)
and the calibrated simulator are interchangeable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

COMPLETE = "complete"
SCORE = "score"        # binary predicate -> confidence in [0,1]
CLASSIFY = "classify"  # choose label(s) from a candidate set
EMBED = "embed"        # text -> unit vector (the semantic index's fuel)


@dataclasses.dataclass
class Request:
    prompt: str
    model: str
    kind: str = COMPLETE
    max_tokens: int = 32
    labels: Optional[Tuple[str, ...]] = None
    multi_label: bool = False
    # opaque payload: ground-truth hooks for the simulator, routing hints…
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    request_id: int = 0


@dataclasses.dataclass
class Result:
    request_id: int
    model: str
    kind: str
    text: str = ""
    score: Optional[float] = None            # SCORE kind
    label: Optional[str] = None              # CLASSIFY kind (top-1)
    labels: Optional[Tuple[str, ...]] = None  # CLASSIFY multi-label
    embedding: Optional[Tuple[float, ...]] = None  # EMBED kind (unit vector)
    tokens_in: int = 0
    tokens_out: int = 0
    credits: float = 0.0
    latency_s: float = 0.0
    engine_id: str = ""


class InferenceBackend(Protocol):
    def submit_batch(self, requests: Sequence[Request]) -> List[Result]: ...
    def hosted_models(self) -> List[str]: ...


class EngineFailure(RuntimeError):
    """Raised by an engine when a (possibly injected) fault occurs; the
    scheduler retries on a healthy replica."""


class EngineTimeout(EngineFailure):
    """An engine exceeded its serving deadline (injected via the
    simulator's ``timeout_rate``); retried exactly like a failure but
    counted separately so serving telemetry can tell them apart."""


# --- model pricing tables (credits per 1M tokens), mirrors §4's observation
# that AI credits dominate and that multimodal/oracle models cost more.
# Generative kinds (COMPLETE / SCORE / CLASSIFY) price every token the
# model processes at the model's rate:
CREDITS_PER_MTOK = {
    "proxy-8b": 0.19,
    "oracle-70b": 1.33,
    "recurrentgemma-9b": 0.22,
    "command-r-35b": 0.83,
    "qwen3-32b": 0.75,
    "stablelm-12b": 0.30,
    "minitron-8b": 0.19,
    "whisper-base": 0.06,
    "phi3.5-moe-42b-a6.6b": 0.17,   # active-param priced
    "qwen2-moe-a2.7b": 0.08,
    "qwen2-vl-7b": 0.90,            # multimodal premium (paper §5.1)
    "rwkv6-1.6b": 0.05,
}
# EMBED-class models are priced per *input* token only — there is no
# completion pass, so the rate sits an order of magnitude below even the
# proxy tier (the economics behind index-assisted pruning: an embedding
# costs ~1% of a proxy call over the same text).
EMBED_CREDITS_PER_MTOK = {
    "arctic-embed-m": 0.02,
    "e5-base-embed": 0.03,
}
_DEFAULT_CREDITS_PER_MTOK = 0.5
_DEFAULT_EMBED_CREDITS_PER_MTOK = 0.03
# request kind -> (pricing table, default rate).  Kinds absent here fall
# back to the generative table, so SCORE/CLASSIFY/COMPLETE prices are
# bit-identical to the pre-table formula.
KIND_PRICING = {
    EMBED: (EMBED_CREDITS_PER_MTOK, _DEFAULT_EMBED_CREDITS_PER_MTOK),
}


def credits_for(model: str, tokens: int, kind: Optional[str] = None) -> float:
    """Credits for processing ``tokens`` input tokens with ``model``.

    ``kind`` selects the pricing table: EMBED-class requests bill at the
    embedding rate (input tokens only, no completion tokens); every other
    kind — and the legacy two-argument call — uses the generative table.
    """
    table, default = KIND_PRICING.get(kind,
                                      (CREDITS_PER_MTOK,
                                       _DEFAULT_CREDITS_PER_MTOK))
    return table.get(model, default) * tokens / 1e6
