"""Paged KV cache: fixed-size blocks, a free-list allocator, block tables.

The PyTorch counterpart of ``repro.inference.paged_kv``.  The pool mirrors
``model.init_cache`` leaf for leaf with the ``(batch, Smax)`` axis pair
replaced by ``(num_blocks, block_size)``: a period leaf
``[P, B, Smax, KV, hd]`` becomes ``[P, NB, bs, KV, hd]``.  Each live
sequence owns a block table, allocated from a host-side LIFO free list at
admission and returned at retirement.  Block 0 is a scratch block:
unassigned table entries point at it, so gathers of empty slots read junk
that is never trusted, and writes of invalid positions are left out.

``scatter`` updates the pool **in place** (the JAX version returned a new
pool, which the jitted step donated) and returns it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch


class OutOfBlocks(RuntimeError):
    """Free list exhausted: the caller should defer admission."""


def _leaf_axis(shape, block_size: int) -> int:
    """Index of the (batch, seq) axis pair in an ``init_cache(1, bs)``
    leaf: the first ``i`` with ``shape[i] == 1 and shape[i+1] == bs``."""
    for i in range(len(shape) - 1):
        if shape[i] == 1 and shape[i + 1] == block_size:
            return i
    raise ValueError(
        f"cache leaf {tuple(shape)} has no (batch, seq={block_size}) axis "
        "pair: architecture is not paged-cache compatible")


class PagedKVCache:
    def __init__(self, model, *, block_size: int = 32, num_blocks: int = 64,
                 device="cpu"):
        if block_size < 2:
            raise ValueError("block_size must be >= 2")
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is scratch)")
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        template = model.init_cache(1, self.block_size, device="meta")
        self._axes: Dict[str, Dict[str, int]] = {}
        self.pool: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, sub in template.items():
            if key == "len":
                continue
            self._axes[key] = {}
            self.pool[key] = {}
            for name, blk in sub.items():
                self._axes[key][name] = axes = {
                    leaf: _leaf_axis(x.shape, self.block_size)
                    for leaf, x in blk.items()}
                self.pool[key][name] = {
                    leaf: torch.zeros(
                        x.shape[:axes[leaf]]
                        + (self.num_blocks, self.block_size)
                        + x.shape[axes[leaf] + 2:], dtype=x.dtype,
                        device=device)
                    for leaf, x in blk.items()}
        # LIFO free list; block 0 stays out as the scratch block
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))

    # ------------------------------------------------------------------
    # host-side allocator
    # ------------------------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        return max(-(-int(tokens) // self.block_size), 1)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def max_seq_blocks(self) -> int:
        """Largest block table a single sequence can hold."""
        return self.num_blocks - 1

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n} blocks, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free_blocks(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)

    # ------------------------------------------------------------------
    # gather / scatter (pool passed explicitly, as in the JAX version)
    # ------------------------------------------------------------------

    def _leaves(self, tree):
        for key, sub in tree.items():
            for name, blk in sub.items():
                for leaf in blk:
                    yield key, name, leaf

    def gather(self, pool, tables: torch.Tensor, lens: torch.Tensor):
        """Materialise the dense model cache view of ``tables``.

        pool: as ``self.pool``; tables: int [B, nb]; lens: int32 [B].
        Returns a fresh ``model.init_cache``-shaped cache with
        Smax = nb * bs and ``"len" = lens``.
        """
        B, nb = tables.shape
        flat = tables.reshape(-1).long()
        cache: Dict[str, Any] = {k: {n: {} for n in sub}
                                 for k, sub in pool.items()}
        for key, name, leaf in self._leaves(pool):
            x = pool[key][name][leaf]
            a = self._axes[key][name][leaf]
            g = x.index_select(a, flat)                 # [..., B*nb, bs, ...]
            shp = tuple(x.shape)
            cache[key][name][leaf] = g.reshape(
                shp[:a] + (B, nb * shp[a + 1]) + shp[a + 2:])
        cache["len"] = lens
        return cache

    def scatter(self, pool, cache, tables: torch.Tensor, start: torch.Tensor,
                count: torch.Tensor, width: int):
        """Persist newly written cache positions back into the pool.

        cache: dense view returned by the model, with new tokens written at
        positions ``start .. start+width-1`` per row; start/count: int
        [B]; ``width`` is the per-row write window (the prefill chunk size,
        or 1 for a decode step).  Only the first ``count`` positions per row
        are persisted: ragged chunk tails and inactive slots never touch
        the pool.  The JAX version sends the other positions to an
        out-of-range block and drops them; here they are masked out of the
        index set.  Updates ``pool`` in place and returns it.
        """
        bs = self.block_size
        B, nbw = tables.shape
        dev = tables.device
        i = torch.arange(width, dtype=torch.long, device=dev)[None]   # [1,C]
        pos = start.long()[:, None] + i                              # [B,C]
        keep = i < count.long()[:, None]
        blk = torch.gather(tables.long(), 1, (pos // bs).clamp(0, nbw - 1))
        off = pos % bs
        bidx = torch.arange(B, device=dev)[:, None].expand(B, width)
        blk, off, bidx, pos = blk[keep], off[keep], bidx[keep], pos[keep]
        for key, name, leaf in self._leaves(pool):
            a = self._axes[key][name][leaf]
            lead = (slice(None),) * a
            dst = pool[key][name][leaf]
            dst[lead + (blk, off)] = cache[key][name][leaf][lead + (bidx, pos)]
        return pool
