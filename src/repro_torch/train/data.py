"""Deterministic synthetic LM data pipeline.

Goals (what a real fleet needs from the data layer, scaled down):
  * deterministic per (seed, step, shard) — restart-safe: resuming from a
    checkpoint at step k regenerates exactly the batches k, k+1, …;
  * shardable — each data-parallel worker draws only its slice;
  * cheap — tokens are generated by a counter-based hash (no host RNG state
    to checkpoint).

The "corpus" is a Zipf-ish token distribution with short-range structure so
the CE loss actually decreases during smoke training.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


def _philox(seed: int, a: np.ndarray) -> np.ndarray:
    """Counter-based pseudo-random uint32 from int64 counters."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + np.uint64(seed * 2654435761 + 1)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    x = (x * np.uint64(0xFF51AFD7ED558CCD)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0
    eff_vocab: int = 0          # structured range (defaults to min(4096, V))

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0
        self.local_batch = self.global_batch // self.num_shards
        if not self.eff_vocab:
            self.eff_vocab = min(4096, self.vocab_size)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """tokens/labels/loss_mask for one step (this shard's slice)."""
        B, S = self.local_batch, self.seq_len
        row0 = step * self.global_batch + self.shard_id * B
        counters = (np.arange(B, dtype=np.int64)[:, None] + row0) * (S + 1) \
            + np.arange(S + 1, dtype=np.int64)[None, :]
        u = _philox(self.seed, counters).astype(np.float64) / 2 ** 32
        # Zipf-ish marginal + deterministic short-range repetition structure
        z = (self.eff_vocab ** u - 1.0) / (self.eff_vocab - 1.0)
        toks = (z * (self.eff_vocab - 1)).astype(np.int32) + 1
        rep = _philox(self.seed + 1, counters) % 4 == 0
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        tokens = toks[:, :-1]
        labels = toks[:, 1:]
        return {
            "tokens": tokens,
            "labels": labels,
            "loss_mask": np.ones((B, S), np.float32),
        }
