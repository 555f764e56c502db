"""EmbeddingStore — content-hash-keyed persistent embedding cache.

The semantic index's storage layer, designed like the `StatsStore`: one
instance shared by every query (and, under the serving runtime, every
tenant session), persisted alongside it.  Two ideas:

  * **content addressing** — a vector is keyed by
    ``sha256(model ‖ text)``, so re-embedding the same text is a cache
    hit regardless of which table, column, row or query produced it; an
    UPDATE that rewrites 1% of a column re-embeds exactly that 1%.
  * **per-column registries** — an index build needs *the column's
    vectors in row order*; `register_column` records the ordered content
    keys of a column snapshot so `column_matrix` can materialize the
    [N, D] matrix (and detect staleness via the snapshot signature).

Persistence is a JSON sidecar (keys, column registries, model/dim
metadata) plus an ``.npz`` holding one vector matrix — human-inspectable
like the stats JSON, binary where it matters.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _VectorPage:
    """A fixed-capacity [page_rows, D] float32 slab of vectors, held as
    one spillable segment.  Open (appendable) pages are pinned in
    memory; once full they seal and become LRU-evictable like any table
    chunk."""

    def __init__(self, spill, dim: int, capacity: int):
        from repro_torch.tables.spill import SpillSegment
        self.capacity = capacity
        self.count = 0
        self.seg = SpillSegment(
            spill, {"v": np.zeros((capacity, dim), np.float32)},
            sealed=False)

    def append(self, vec: np.ndarray) -> int:
        slot = self.count
        self.seg.arrays()["v"][slot] = vec
        self.count += 1
        if self.count == self.capacity:
            self.seg.seal()
        return slot

    def vector(self, slot: int) -> np.ndarray:
        return self.seg.arrays()["v"][slot]


class _PagedVectorMap:
    """dict-of-vectors facade over spillable `_VectorPage`s.

    Vectors are content-addressed and therefore write-once: a repeated
    ``[key] = vec`` always carries the same value, so sealed pages never
    need rewriting on disk.  One open page per dimensionality."""

    def __init__(self, spill, page_rows: int = 1024):
        self._spill = spill
        self._page_rows = max(int(page_rows), 1)
        self._loc: Dict[str, Tuple[_VectorPage, int]] = {}
        self._open: Dict[int, _VectorPage] = {}

    def get(self, key: str, default=None):
        loc = self._loc.get(key)
        if loc is None:
            return default
        return loc[0].vector(loc[1])

    def __getitem__(self, key: str) -> np.ndarray:
        page, slot = self._loc[key]
        return page.vector(slot)

    def __setitem__(self, key: str, vec) -> None:
        vec = np.asarray(vec, np.float32)
        loc = self._loc.get(key)
        if loc is not None:          # content-addressed: same value
            loc[0].seg.arrays()["v"][loc[1]] = vec
            return
        d = int(vec.shape[-1])
        page = self._open.get(d)
        if page is None or page.count >= page.capacity:
            page = _VectorPage(self._spill, d, self._page_rows)
            self._open[d] = page
        self._loc[key] = (page, page.append(vec))

    def setdefault(self, key: str, vec) -> np.ndarray:
        got = self.get(key)
        if got is not None:
            return got
        self[key] = vec
        return self[key]

    def __contains__(self, key: str) -> bool:
        return key in self._loc

    def __len__(self) -> int:
        return len(self._loc)

    def __iter__(self):
        return iter(self._loc)

    def clear(self) -> None:
        self._loc.clear()
        self._open.clear()


def content_key(model: str, text: str, dim: Optional[int] = None) -> str:
    """Content-hash identity of one (model, text, dim) embedding.  The
    dimensionality is part of the key: the same text embedded at two
    configured dims yields two distinct (and differently-shaped)
    vectors, which must never collide in the store."""
    h = hashlib.sha256()
    h.update(model.encode())
    if dim is not None:
        h.update(f"@{int(dim)}".encode())
    h.update(b"\x00")
    h.update(str(text).encode())
    return h.hexdigest()[:32]


class EmbeddingStore:
    """Thread-safe map ``content key -> unit vector`` with per-column
    row-order registries and JSON+npz persistence.

    ``path`` is a *prefix*: ``save`` writes ``<path>.json`` and
    ``<path>.npz``; construction loads them when present (merge-on-load,
    like `StatsStore`).

    With ``spill`` set (a `repro_torch.tables.spill.SpillManager`), vectors
    live in fixed-size spillable pages under that manager's byte budget
    instead of one resident dict — same observable behaviour, bounded
    memory.
    """

    def __init__(self, path: Optional[str] = None, *,
                 spill=None, page_rows: int = 1024):
        self.path = path
        self.spill = spill
        self._lock = threading.RLock()
        self._vecs = (_PagedVectorMap(spill, page_rows)
                      if spill is not None
                      else {})  # type: Dict[str, np.ndarray]
        # column name -> {"model", "keys" (row order), "signature"}
        self._columns: Dict[str, Dict] = {}
        if path is not None and os.path.exists(path + ".json"):
            self.load(path)

    def spill_stats(self) -> Optional[Dict[str, int]]:
        return self.spill.stats() if self.spill is not None else None

    # -- access --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._vecs)

    def __contains__(self, key: str) -> bool:
        return key in self._vecs

    def get(self, model: str, texts: Sequence[str],
            dim: Optional[int] = None) -> List[Optional[np.ndarray]]:
        """Per-text cached vectors (None for misses), in input order."""
        with self._lock:
            return [self._vecs.get(content_key(model, t, dim))
                    for t in texts]

    def put(self, model: str, texts: Sequence[str],
            vectors: Sequence[np.ndarray],
            dim: Optional[int] = None) -> None:
        with self._lock:
            for t, v in zip(texts, vectors):
                self._vecs[content_key(model, t, dim)] = \
                    np.asarray(v, np.float32)

    def coverage(self, model: str, texts: Sequence[str],
                 dim: Optional[int] = None) -> float:
        """Fraction of ``texts`` already embedded (cost-model input:
        the expected per-row embed spend is ``1 - coverage`` misses)."""
        if not len(texts):
            return 1.0
        with self._lock:
            hits = sum(content_key(model, t, dim) in self._vecs
                       for t in texts)
        return hits / len(texts)

    # -- per-column registries -----------------------------------------
    @staticmethod
    def column_signature(model: str, texts: Sequence[str],
                         dim: Optional[int] = None) -> str:
        h = hashlib.sha256()
        h.update(model.encode())
        if dim is not None:
            h.update(f"@{int(dim)}".encode())
        for t in texts:
            h.update(b"\x00")
            h.update(str(t).encode())
        return h.hexdigest()[:32]

    def register_column(self, column: str, model: str,
                        texts: Sequence[str],
                        dim: Optional[int] = None) -> str:
        """Record a column snapshot's ordered content keys; returns the
        snapshot signature (index staleness check)."""
        sig = self.column_signature(model, texts, dim)
        with self._lock:
            self._columns[column] = {
                "model": model,
                "keys": [content_key(model, t, dim) for t in texts],
                "signature": sig,
            }
        return sig

    def column_entry(self, column: str) -> Optional[Dict]:
        return self._columns.get(column)

    def column_matrix(self, column: str) -> Tuple[np.ndarray, List[str]]:
        """The registered column's [N, D] matrix in row order (raises
        ``KeyError`` when unregistered or vectors are missing)."""
        with self._lock:
            entry = self._columns[column]
            vecs = [self._vecs[k] for k in entry["keys"]]
        return np.stack(vecs).astype(np.float32), list(entry["keys"])

    # -- persistence ---------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("EmbeddingStore.save: no path configured")
        with self._lock:
            keys = sorted(self._vecs)
            mat = (np.stack([self._vecs[k] for k in keys])
                   if keys else np.zeros((0, 0), np.float32))
            meta = {"keys": keys, "columns": self._columns}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # temp-file + os.replace, like StatsStore.save: a crash mid-write
        # leaves the previous complete sidecar/matrix pair, never a
        # truncated file that poisons the next load.  The npz temp name
        # must already end in ".npz" or numpy appends the suffix itself.
        tmp_json = f"{path}.json.tmp.{os.getpid()}"
        tmp_npz = f"{path}.tmp.{os.getpid()}.npz"
        try:
            with open(tmp_json, "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            np.savez_compressed(tmp_npz, vectors=mat)
            os.replace(tmp_npz, path + ".npz")
            os.replace(tmp_json, path + ".json")
        finally:
            for tmp in (tmp_json, tmp_npz):
                if os.path.exists(tmp):
                    os.remove(tmp)
        return path

    def load(self, path: Optional[str] = None) -> None:
        """Merge a persisted store into this one.  Corrupt or partial
        files (the pre-atomic-save failure mode) warn and contribute
        nothing instead of raising — cached embeddings are recomputable,
        never a reason the store fails to construct."""
        path = path or self.path
        try:
            with open(path + ".json") as f:
                meta = json.load(f)
            mat = np.load(path + ".npz")["vectors"]
            keys = meta["keys"]
            if len(keys) != len(mat):
                raise ValueError(
                    f"sidecar lists {len(keys)} keys but matrix has "
                    f"{len(mat)} rows")
        except (json.JSONDecodeError, ValueError, KeyError, OSError,
                zipfile.BadZipFile) as exc:
            warnings.warn(
                f"EmbeddingStore: ignoring unreadable store at {path!r} "
                f"({exc}); starting from an empty cache", stacklevel=2)
            return
        with self._lock:
            for i, k in enumerate(keys):
                self._vecs.setdefault(k, mat[i].astype(np.float32))
            for col, entry in meta.get("columns", {}).items():
                self._columns.setdefault(col, entry)

    def clear(self) -> None:
        with self._lock:
            self._vecs.clear()
            self._columns.clear()
