"""Byte-budgeted spill manager for chunked storage.

A `SpillManager` tracks the resident bytes of every `SpillSegment`
registered with it and, when a byte budget is configured, evicts the
least-recently-used segments to disk (one ``.npz`` file per segment)
until the resident set fits.  Reload is transparent: touching a spilled
segment's `arrays()` reads the file back and re-admits the segment,
possibly evicting others.

Segments are immutable once *sealed* (the normal state for table
chunks).  A segment may be created unsealed — the embedding store's
append-open vector pages use this — in which case it is pinned in
memory and skipped by eviction until `seal()` is called.  Because
sealed segments never change, a segment that has been spilled once
never rewrites its file: a later eviction just drops the in-memory
arrays again.

Byte accounting: fixed-width arrays count `arr.nbytes`; object arrays
(str/file columns) additionally count the string payload of each cell,
`sum(len(str(x)))` — an estimate, but a stable one, so budgets and the
reported `peak_bytes` are deterministic across runs.

Thread safety: one re-entrant lock per manager guards all segment state
transitions (admit / touch / evict / reload), giving a single lock
order and making concurrent executor workers safe.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from repro_torch.obs.trace import active_tracer


def array_bytes(arr: np.ndarray) -> int:
    """Estimated resident bytes of ``arr`` including object payloads."""
    n = int(arr.nbytes)
    if arr.dtype == object:
        n += int(sum(len(str(x)) for x in arr))
    return n


class SpillSegment:
    """A named bundle of equal-length arrays that can round-trip to disk.

    State is one of: resident (arrays in memory), spilled (arrays on
    disk at `path`).  All transitions go through the owning manager's
    lock.  `arrays()` is the only accessor — it loads on demand and
    counts as an LRU touch.
    """

    def __init__(self, manager: "SpillManager", arrays: Dict[str, np.ndarray],
                 *, sealed: bool = True):
        self._mgr = manager
        self._arrays: Optional[Dict[str, np.ndarray]] = dict(arrays)
        self._names = list(arrays)
        self.sealed = sealed
        self.nbytes = sum(array_bytes(a) for a in arrays.values())
        self.path: Optional[str] = None
        self.sid = manager._next_sid()
        manager._admit(self)

    @property
    def resident(self) -> bool:
        return self._arrays is not None

    def arrays(self) -> Dict[str, np.ndarray]:
        return self._mgr._access(self)

    def seal(self) -> None:
        """Mark immutable; the segment becomes eligible for eviction."""
        self._mgr._seal(self)

    # -- manager-internal (called under the manager lock) --------------
    def _recount(self) -> None:
        assert self._arrays is not None
        self.nbytes = sum(array_bytes(a) for a in self._arrays.values())

    def _write(self) -> None:
        if self.path is None:
            self.path = os.path.join(self._mgr.directory(),
                                     f"seg{self.sid}.npz")
            assert self._arrays is not None
            # positional member names: column names may not be valid
            # npz keywords; order is recovered from self._names
            np.savez(self.path, *[self._arrays[n] for n in self._names])

    def _drop(self) -> None:
        self._arrays = None

    def _load(self) -> None:
        assert self.path is not None
        with np.load(self.path, allow_pickle=True) as z:
            self._arrays = {n: z[f"arr_{i}"]
                            for i, n in enumerate(self._names)}


class SpillManager:
    """LRU byte-budget accountant for a set of `SpillSegment`s.

    Args:
        budget_bytes: resident-byte ceiling; ``None`` tracks bytes but
            never evicts.  The segment currently being admitted or read
            is exempt, so the instantaneous peak can exceed the budget
            by roughly one segment.
        spill_dir: where segment files go; defaults to a lazily created
            temporary directory.

    Counters (all monotonic): ``tracked_bytes`` resident now,
    ``peak_bytes`` high-water mark, ``spill_events`` / ``reload_events``
    segment evictions and reloads, ``spilled_bytes`` total bytes written.
    """

    def __init__(self, budget_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self.budget_bytes = budget_bytes
        self._dir = spill_dir
        self._lock = threading.RLock()
        self._resident: "OrderedDict[int, SpillSegment]" = OrderedDict()
        self._sid = 0
        self.tracked_bytes = 0
        self.peak_bytes = 0
        self.spill_events = 0
        self.reload_events = 0
        self.spilled_bytes = 0

    def directory(self) -> str:
        with self._lock:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(prefix="repro-spill-")
            else:
                os.makedirs(self._dir, exist_ok=True)
            return self._dir

    def _next_sid(self) -> int:
        with self._lock:
            self._sid += 1
            return self._sid

    # -- segment protocol ----------------------------------------------
    def _admit(self, seg: SpillSegment) -> None:
        with self._lock:
            self._resident[seg.sid] = seg
            self.tracked_bytes += seg.nbytes
            self.peak_bytes = max(self.peak_bytes, self.tracked_bytes)
            self._evict_over_budget(exempt=seg)

    def _access(self, seg: SpillSegment) -> Dict[str, np.ndarray]:
        with self._lock:
            if seg._arrays is None:
                seg._load()
                self.reload_events += 1
                active_tracer().event("storage.reload", sid=seg.sid,
                                      bytes=seg.nbytes)
                self._resident[seg.sid] = seg
                self.tracked_bytes += seg.nbytes
                self.peak_bytes = max(self.peak_bytes, self.tracked_bytes)
            else:
                self._resident.move_to_end(seg.sid)
            self._evict_over_budget(exempt=seg)
            return seg._arrays

    def _seal(self, seg: SpillSegment) -> None:
        with self._lock:
            if not seg.sealed:
                seg.sealed = True
                if seg._arrays is not None:
                    delta = -seg.nbytes
                    seg._recount()
                    self.tracked_bytes += seg.nbytes + delta
                    self.peak_bytes = max(self.peak_bytes,
                                          self.tracked_bytes)
                self._evict_over_budget(exempt=None)

    def _evict_over_budget(self, exempt: Optional[SpillSegment]) -> None:
        if self.budget_bytes is None:
            return
        while self.tracked_bytes > self.budget_bytes:
            victim = next(
                (s for s in self._resident.values()
                 if s.sealed and s is not exempt), None)
            if victim is None:
                return
            victim._write()
            victim._drop()
            del self._resident[victim.sid]
            self.tracked_bytes -= victim.nbytes
            self.spill_events += 1
            self.spilled_bytes += victim.nbytes
            active_tracer().event("storage.spill", sid=victim.sid,
                                  bytes=victim.nbytes)

    # -- reporting ------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "tracked_bytes": self.tracked_bytes,
                "peak_bytes": self.peak_bytes,
                "spill_events": self.spill_events,
                "reload_events": self.reload_events,
                "spilled_bytes": self.spilled_bytes,
                "resident_segments": len(self._resident),
                "budget_bytes": self.budget_bytes or 0,
            }
