"""Columnar relational substrate for the AISQL engine.

A deliberately small but real column-store: typed columns (including the
paper's FILE type for multimodal references, §3.6), vectorised filters,
hash joins, group-by, and statistics (NDV, avg token length) used by the
AI-aware optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FileRef:
    """The FILE data type (§3.6): URI + metadata for an object in storage."""
    uri: str
    mime_type: str = "application/octet-stream"
    size: int = 0
    created_at: str = ""

    def is_image(self) -> bool:
        return self.mime_type.startswith("image/")

    def is_audio(self) -> bool:
        return self.mime_type.startswith("audio/")

    def __str__(self) -> str:  # used when spliced into prompts
        return self.uri


def fl_is_image(f: Any) -> bool:
    return isinstance(f, FileRef) and f.is_image()


def fl_is_audio(f: Any) -> bool:
    return isinstance(f, FileRef) and f.is_audio()


_COLUMN_TYPES = ("int", "float", "str", "bool", "file")


def _typed_column(values, t: str) -> np.ndarray:
    """Convert ``values`` to the canonical numpy representation of type
    ``t`` (int64 / float64 / bool, object array for str/file)."""
    if t == "int":
        return np.asarray(values, dtype=np.int64)
    if t == "float":
        return np.asarray(values, dtype=np.float64)
    if t == "bool":
        return np.asarray(values, dtype=bool)
    vals = list(values)
    arr = np.empty(len(vals), dtype=object)
    for i, x in enumerate(vals):   # keeps tuple cells 1-D
        arr[i] = x
    return arr


def _infer_type(values) -> str:
    for v in values:
        if v is None:
            continue
        if isinstance(v, FileRef):
            return "file"
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, (int, np.integer)):
            return "int"
        if isinstance(v, (float, np.floating)):
            return "float"
        return "str"
    return "str"


class Table:
    """Immutable columnar table."""

    def __init__(self, columns: Dict[str, Sequence[Any]],
                 types: Optional[Dict[str, str]] = None,
                 name: str = ""):
        if not columns:
            raise ValueError("empty table")
        lens = {len(v) for v in columns.values()}
        if len(lens) != 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self.name = name
        self._cols: Dict[str, np.ndarray] = {}
        self.types: Dict[str, str] = {}
        for k, v in columns.items():
            t = (types or {}).get(k) or _infer_type(v)
            if t not in _COLUMN_TYPES:
                raise ValueError(
                    f"column {k!r}: unknown type {t!r}"
                    f" (expected one of {_COLUMN_TYPES})")
            self.types[k] = t
            self._cols[k] = _typed_column(v, t)

    @classmethod
    def _from_arrays(cls, cols: Dict[str, np.ndarray],
                     types: Dict[str, str], name: str = "") -> "Table":
        """Adopt already-typed arrays without copying.

        Trusted internal constructor: callers guarantee the arrays are in
        the canonical representation (`_typed_column` output) and equal
        length.  `ChunkedTable.morsel` relies on this to hand the
        executor zero-copy views of a chunk's columns.
        """
        t = cls.__new__(Table)
        t.name = name
        t._cols = dict(cols)
        t.types = dict(types)
        return t

    # ---- basics ----
    @property
    def num_rows(self) -> int:
        return len(next(iter(self._cols.values())))

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def gather(self, name: str, rows) -> np.ndarray:
        """Values of column ``name`` at row indices ``rows``.

        On a monolithic table this is fancy indexing; `ChunkedTable`
        overrides it to gather segment-wise, so expression evaluation
        over a row subset never materializes the full column.
        """
        return self.column(name)[np.asarray(rows, dtype=np.int64)]

    def row(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self._cols.items()}

    def rows(self) -> Iterable[Dict[str, Any]]:
        for i in range(self.num_rows):
            yield self.row(i)

    def with_column(self, name: str, values, type_: Optional[str] = None
                    ) -> "Table":
        cols = dict(self._cols)
        cols[name] = values
        types = dict(self.types)
        if type_:
            types[name] = type_
        else:
            types.pop(name, None)
        return Table(cols, types, name=self.name)

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self._cols[n] for n in names},
                     {n: self.types[n] for n in names}, name=self.name)

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()},
                     {mapping.get(k, k): t for k, t in self.types.items()},
                     name=self.name)

    def prefixed(self, prefix: str) -> "Table":
        return self.rename({c: f"{prefix}.{c}" for c in self.column_names})

    # ---- relational ops ----
    def take(self, idx: np.ndarray) -> "Table":
        return Table({k: v[idx] for k, v in self._cols.items()}, self.types,
                     name=self.name)

    def filter_mask(self, mask: np.ndarray) -> "Table":
        return self.take(np.nonzero(np.asarray(mask, bool))[0])

    def head(self, n: int) -> "Table":
        return self.take(np.arange(min(n, self.num_rows)))

    def concat_rows(self, other: "Table") -> "Table":
        return Table({k: np.concatenate([self._cols[k], other._cols[k]])
                      for k in self._cols}, self.types, name=self.name)

    def hash_join(self, other: "Table", left_on: str, right_on: str
                  ) -> "Table":
        """Equi inner join (build on the smaller side)."""
        lidx, ridx = _hash_join_indices(self._cols[left_on],
                                        other._cols[right_on])
        out = {k: v[lidx] for k, v in self._cols.items()}
        for k, v in other._cols.items():
            key = k if k not in out else f"{other.name or 'r'}.{k}"
            out[key] = v[ridx]
        return Table(out, name=self.name)

    def cross_join_indices(self, other: "Table"):
        li = np.repeat(np.arange(self.num_rows), other.num_rows)
        ri = np.tile(np.arange(other.num_rows), self.num_rows)
        return li, ri

    def group_indices(self, key: str) -> Dict[Any, np.ndarray]:
        groups: Dict[Any, List[int]] = {}
        for i, k in enumerate(self._cols[key]):
            groups.setdefault(k, []).append(i)
        return {k: np.asarray(v) for k, v in groups.items()}

    # ---- statistics for the optimizer ----
    def ndv(self, name: str) -> int:
        col = self._cols[name]
        try:
            return len(set(col.tolist()))
        except TypeError:
            return len({str(x) for x in col})

    def avg_len(self, name: str) -> float:
        col = self._cols[name]
        if self.types[name] != "str":
            return 8.0
        if self.num_rows == 0:
            return 0.0
        sample = col[:256]
        return float(np.mean([len(str(x)) for x in sample]))

    def sample_values(self, name: str, n: int = 5) -> List[Any]:
        return list(self._cols[name][:n])

    def __repr__(self) -> str:
        return (f"Table({self.name or '?'}, rows={self.num_rows}, "
                f"cols={self.column_names})")


def _hash_join_indices(left: np.ndarray, right: np.ndarray):
    table: Dict[Any, List[int]] = {}
    for j, key in enumerate(right):
        table.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(left):
        for j in table.get(key, ()):
            li.append(i)
            ri.append(j)
    return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)
