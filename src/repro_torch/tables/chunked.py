"""Chunk-backed columnar table.

`ChunkedTable` stores each column as a sequence of fixed-size row
segments (`SpillSegment`s owned by a `SpillManager`), instead of one
monolithic numpy allocation per column.  The executor's partitioned
pull loop consumes it through two primitives:

* `segment_bounds()` — the chunk row ranges, so partitions can be
  aligned to never straddle a chunk;
* `morsel(i)` — a plain `Table` whose columns *are* the segment's
  arrays (adopted via `Table._from_arrays`, zero copy).

Everything else a `Table` can do still works: point lookups and row
subsets go through `gather` (segment-wise, touching only the chunks
that hold the requested rows), and any operation that genuinely needs
a whole column assembles it on demand — counted in
``materializations`` so benchmarks can assert the big table was never
materialized.

`take` on more rows than one chunk returns another `ChunkedTable`
registered with the same spill manager, which is how wide intermediate
results participate in the byte budget.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .spill import SpillManager, SpillSegment
from .table import (Table, _COLUMN_TYPES, _infer_type, _typed_column)

DEFAULT_CHUNK_ROWS = 65536

_EMPTY_DTYPE = {"int": np.int64, "float": np.float64, "bool": bool}


def _empty_typed(t: str) -> np.ndarray:
    return np.empty(0, dtype=_EMPTY_DTYPE.get(t, object))


class ChunkedTable(Table):
    """Columnar table backed by fixed-size row chunks with disk spill."""

    def __init__(self, columns: Dict[str, Sequence[Any]],
                 types: Optional[Dict[str, str]] = None,
                 name: str = "", *,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 spill: Optional[SpillManager] = None):
        if not columns:
            raise ValueError("empty table")
        lens = {len(v) for v in columns.values()}
        if len(lens) != 1:
            raise ValueError(
                f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self._init_store(name, chunk_rows, spill)
        typed: Dict[str, np.ndarray] = {}
        for k, v in columns.items():
            t = (types or {}).get(k) or _infer_type(v)
            if t not in _COLUMN_TYPES:
                raise ValueError(
                    f"column {k!r}: unknown type {t!r}"
                    f" (expected one of {_COLUMN_TYPES})")
            self.types[k] = t
            typed[k] = _typed_column(v, t)
        self._colmap = {k: k for k in typed}
        n = lens.pop()
        for lo in range(0, n, self._chunk_rows):
            hi = min(lo + self._chunk_rows, n)
            self._append_segment(
                {k: (a[lo:hi].copy() if hi - lo < len(a) else a)
                 for k, a in typed.items()}, hi - lo)
        self._finalize()

    # -- construction helpers ------------------------------------------
    def _init_store(self, name: str, chunk_rows: int,
                    spill: Optional[SpillManager]) -> None:
        self.name = name
        self.types: Dict[str, str] = {}
        self._chunk_rows = max(int(chunk_rows), 1)
        self._spill = spill if spill is not None else SpillManager()
        self._segments: List[SpillSegment] = []
        self._bounds: List[Tuple[int, int]] = []
        self._nrows = 0
        self._colmap: Dict[str, str] = {}
        self._colcache: Dict[str, np.ndarray] = {}
        self.materializations = 0

    def _append_segment(self, arrays: Dict[str, np.ndarray],
                        nrows: int) -> None:
        self._segments.append(SpillSegment(self._spill, arrays))
        self._bounds.append((self._nrows, self._nrows + nrows))
        self._nrows += nrows

    def _finalize(self) -> None:
        self._starts = np.asarray([lo for lo, _ in self._bounds],
                                  dtype=np.int64)

    @classmethod
    def from_batches(cls, batches: Iterable[Dict[str, Sequence[Any]]], *,
                     types: Optional[Dict[str, str]] = None,
                     name: str = "",
                     chunk_rows: int = DEFAULT_CHUNK_ROWS,
                     spill: Optional[SpillManager] = None) -> "ChunkedTable":
        """Build incrementally from an iterable of column-dict batches.

        The generator is the only holder of unchunked data, so peak
        resident bytes stay near the spill budget even for tables far
        larger than memory.  Types are inferred from the first batch
        unless given.
        """
        self = cls.__new__(cls)
        self._init_store(name, chunk_rows, spill)
        for batch in batches:
            if not self._colmap:
                for k, v in batch.items():
                    t = (types or {}).get(k) or _infer_type(v)
                    if t not in _COLUMN_TYPES:
                        raise ValueError(
                            f"column {k!r}: unknown type {t!r}"
                            f" (expected one of {_COLUMN_TYPES})")
                    self.types[k] = t
                self._colmap = {k: k for k in batch}
            elif set(batch) != set(self._colmap):
                raise ValueError(f"batch columns {sorted(batch)} != "
                                 f"{sorted(self._colmap)}")
            typed = {k: _typed_column(v, self.types[k])
                     for k, v in batch.items()}
            bn = len(next(iter(typed.values())))
            for lo in range(0, bn, self._chunk_rows):
                hi = min(lo + self._chunk_rows, bn)
                self._append_segment(
                    {k: (a[lo:hi].copy() if hi - lo < bn else a)
                     for k, a in typed.items()}, hi - lo)
        if not self._colmap:
            raise ValueError("empty table")
        self._finalize()
        return self

    def _shallow(self, colmap: Dict[str, str], types: Dict[str, str],
                 name: str) -> "ChunkedTable":
        """Column-level view sharing this table's segments (rename /
        select are O(1) on a chunked table)."""
        t = ChunkedTable.__new__(ChunkedTable)
        t.name = name
        t.types = dict(types)
        t._chunk_rows = self._chunk_rows
        t._spill = self._spill
        t._segments = self._segments
        t._bounds = self._bounds
        t._starts = self._starts
        t._nrows = self._nrows
        t._colmap = dict(colmap)
        t._colcache = {}
        t.materializations = 0
        return t

    # -- chunk protocol (consumed by the executor) ---------------------
    @property
    def spill(self) -> SpillManager:
        return self._spill

    @property
    def chunk_rows(self) -> int:
        return self._chunk_rows

    def segment_bounds(self) -> List[Tuple[int, int]]:
        """Global row range ``[lo, hi)`` of each chunk."""
        return list(self._bounds)

    def morsel(self, i: int) -> Table:
        """Zero-copy `Table` view of chunk ``i`` (rows are local to the
        chunk; add ``segment_bounds()[i][0]`` to go global)."""
        arrs = self._segments[i].arrays()
        return Table._from_arrays(
            {pub: arrs[itl] for pub, itl in self._colmap.items()},
            self.types, self.name)

    # -- basics ---------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._nrows

    @property
    def column_names(self) -> List[str]:
        return list(self._colmap)

    def __contains__(self, name: str) -> bool:
        return name in self._colmap

    def column(self, name: str) -> np.ndarray:
        """Assemble (and cache) one full column.  This is the
        materialization escape hatch — counted so scale benchmarks can
        assert it never fires on the big table."""
        arr = self._colcache.get(name)
        if arr is None:
            arr = self.gather(name, np.arange(self._nrows, dtype=np.int64))
            self._colcache[name] = arr
            self.materializations += 1
        return arr

    def __getitem__(self, name: str) -> np.ndarray:
        return self.column(name)

    @property
    def _cols(self) -> Dict[str, np.ndarray]:
        # base-class ops (hash_join, concat_rows, with_column, ...) fall
        # back to full materialization through this property
        return {n: self.column(n) for n in self._colmap}

    def gather(self, name: str, rows) -> np.ndarray:
        internal = self._colmap[name]
        t = self.types[name]
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return _empty_typed(t)
        seg_ids = np.searchsorted(self._starts, rows, side="right") - 1
        out = np.empty(rows.size, dtype=_EMPTY_DTYPE.get(t, object))
        for sid in np.unique(seg_ids):
            m = seg_ids == sid
            col = self._segments[sid].arrays()[internal]
            out[m] = col[rows[m] - self._bounds[sid][0]]
        return out

    def row(self, i: int) -> Dict[str, Any]:
        sid = int(np.searchsorted(self._starts, i, side="right")) - 1
        local = i - self._bounds[sid][0]
        arrs = self._segments[sid].arrays()
        return {pub: arrs[itl][local] for pub, itl in self._colmap.items()}

    def rows(self) -> Iterable[Dict[str, Any]]:
        for si in range(len(self._segments)):
            m = self.morsel(si)
            for i in range(m.num_rows):
                yield m.row(i)

    # -- relational ops -------------------------------------------------
    def select(self, names: Sequence[str]) -> "ChunkedTable":
        return self._shallow({n: self._colmap[n] for n in names},
                             {n: self.types[n] for n in names}, self.name)

    def rename(self, mapping: Dict[str, str]) -> "ChunkedTable":
        return self._shallow(
            {mapping.get(k, k): i for k, i in self._colmap.items()},
            {mapping.get(k, k): t for k, t in self.types.items()},
            self.name)

    def take(self, idx: np.ndarray) -> Table:
        idx = np.asarray(idx, dtype=np.int64)
        if idx.size > self._chunk_rows:
            # wide intermediate: keep it chunked under the same spill
            # manager so it participates in the byte budget
            step = self._chunk_rows
            return ChunkedTable.from_batches(
                ({n: self.gather(n, idx[lo:lo + step])
                  for n in self._colmap}
                 for lo in range(0, idx.size, step)),
                types=self.types, name=self.name,
                chunk_rows=step, spill=self._spill)
        return Table._from_arrays(
            {n: self.gather(n, idx) for n in self._colmap},
            self.types, self.name)

    def group_indices(self, key: str) -> Dict[Any, np.ndarray]:
        groups: Dict[Any, List[int]] = {}
        for i, k in enumerate(self.column(key)):
            groups.setdefault(k, []).append(i)
        return {k: np.asarray(v) for k, v in groups.items()}

    # -- statistics for the optimizer -----------------------------------
    NDV_EXACT_ROWS = 1 << 17

    def ndv(self, name: str) -> int:
        """Exact distinct count up to `NDV_EXACT_ROWS` rows (identical
        to the monolithic store); a linear-extrapolated sample-based
        estimate beyond that, so catalog statistics never require a
        full materialization of a million-row column."""
        internal = self._colmap[name]
        vals: set = set()
        sampled = 0
        for sid, (lo, hi) in enumerate(self._bounds):
            col = self._segments[sid].arrays()[internal]
            try:
                vals.update(col.tolist())
            except TypeError:
                vals.update(str(x) for x in col)
            sampled = hi
            if self._nrows > self.NDV_EXACT_ROWS and \
                    sampled >= self.NDV_EXACT_ROWS:
                break
        if sampled >= self._nrows:
            return len(vals)
        return int(min(self._nrows,
                       round(len(vals) * self._nrows / max(sampled, 1))))

    def avg_len(self, name: str) -> float:
        if self.types[name] != "str":
            return 8.0
        if self._nrows == 0:
            return 0.0
        sample = self.gather(
            name, np.arange(min(256, self._nrows), dtype=np.int64))
        return float(np.mean([len(str(x)) for x in sample]))

    def sample_values(self, name: str, n: int = 5) -> List[Any]:
        return list(self.gather(
            name, np.arange(min(n, self._nrows), dtype=np.int64)))

    def __repr__(self) -> str:
        return (f"ChunkedTable({self.name or '?'}, rows={self._nrows}, "
                f"cols={self.column_names}, chunks={len(self._segments)})")
