"""SemanticIndexManager — the glue between SQL and the vector layer.

One manager instance is shared by the cost model (coverage estimates),
the executor (candidate generation, top-k pruning) and — under the
serving runtime — every tenant session (one lock, one store, one set of
indexes; an index built for tenant A's query serves tenant B's for
free).  It owns:

  * an `EmbeddingStore` (content-hash cache, JSON+npz persisted),
  * per-column `IvfFlatIndex` instances on the manager's device,
    rebuilt automatically when the column snapshot's content signature
    changes (refresh-on-drift),
  * the EMBED traffic itself: cache misses are batched through the
    shared `CortexClient` — coalesced, deduplicated and billed by the
    `RequestPipeline` like every other request kind.

The manager runs its searches on a CUDA device unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.similarity_topk.ops import similarity_topk
from repro_torch.semindex.index import (IMPLS, IvfConfig, IvfFlatIndex,
                                        check_device)
from repro_torch.semindex.store import EmbeddingStore


@dataclasses.dataclass
class SemIndexConfig:
    """Semantic-index policy knobs.

    Args:
        model: embedding model; None uses the client's ``embed_model``.
        dim: embedding dimensionality requested from the backend
            (forwarded as ``embed_dim`` metadata).
        nlist / nprobe / kmeans_iters / impl: `IvfConfig` passthrough —
            coarse-cell count, cells probed per query (the recall knob),
            Lloyd iterations, kernel implementation ("auto" or
            "reference", as in `IvfConfig`).
        min_index_rows: columns smaller than this are scanned flat (an
            IVF level cannot pay for itself).
        join_k: kNN candidates generated per probe row for
            index-assisted semantic-join blocking.
        join_min_sim: optional cosine floor on join candidates (prunes
            the candidate list below ``join_k`` when the tail is noise).
        exact_topk: when True (default) index searches — ORDER BY
            pruning and join blocking alike — use the exact flat scan,
            guaranteeing index-on == index-off rows; False trades that
            for IVF probing at ``nprobe`` cells per query.
        embed_budget_bytes: when set, the `EmbeddingStore` pages its
            vectors through a byte-budgeted `SpillManager` (LRU page
            eviction to disk) instead of holding every vector resident.
        embed_page_rows: vectors per spillable page (the store's
            eviction granularity).
    """
    model: Optional[str] = None
    dim: int = 64
    nlist: int = 16
    nprobe: int = 4
    kmeans_iters: int = 5
    impl: str = "auto"
    min_index_rows: int = 64
    join_k: int = 8
    join_min_sim: Optional[float] = None
    exact_topk: bool = True
    embed_budget_bytes: Optional[int] = None
    embed_page_rows: int = 1024


class SemanticIndexManager:
    """Thread-safe store + index registry + embed-traffic front end."""

    def __init__(self, cfg: Optional[SemIndexConfig] = None, *,
                 store: Optional[EmbeddingStore] = None,
                 path: Optional[str] = None, device="cuda"):
        self.cfg = cfg or SemIndexConfig()
        if self.cfg.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.cfg.impl!r}")
        self.device = check_device(device, "SemanticIndexManager")
        if store is not None:
            self.store = store
        elif self.cfg.embed_budget_bytes is not None:
            from repro_torch.tables.spill import SpillManager
            self.store = EmbeddingStore(
                path, spill=SpillManager(
                    budget_bytes=self.cfg.embed_budget_bytes),
                page_rows=self.cfg.embed_page_rows)
        else:
            self.store = EmbeddingStore(path)
        self._lock = threading.RLock()
        # column key -> (signature, IvfFlatIndex)
        self._indexes: Dict[str, Tuple[str, IvfFlatIndex]] = {}
        # telemetry (reset never; engines snapshot-delta it per query)
        self.embed_requests = 0
        self.embed_cache_hits = 0
        self.embed_llm_calls = 0
        self.index_builds = 0
        self.index_searches = 0

    # ------------------------------------------------------------------
    def model_for(self, client) -> str:
        return self.cfg.model or client.embed_model

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "embed_requests": self.embed_requests,
                "embed_cache_hits": self.embed_cache_hits,
                "embed_llm_calls": self.embed_llm_calls,
                "index_builds": self.index_builds,
                "index_searches": self.index_searches,
                "stored_vectors": len(self.store),
                "indexed_columns": len(self._indexes),
            }

    # ------------------------------------------------------------------
    # embedding traffic (store-first, misses through the client)
    # ------------------------------------------------------------------

    def embed_texts(self, client, texts: Sequence[str], *,
                    metadata: Optional[Sequence[Dict[str, Any]]] = None,
                    model: Optional[str] = None) -> np.ndarray:
        """Vectors for ``texts`` in order: store hits are free, misses
        are embedded through ``client`` (one coalesced batch — the
        pipeline dedups identical texts) and written back to the store."""
        model = model or self.model_for(client)
        texts = [str(t) for t in texts]
        if not texts:
            return np.zeros((0, 1), np.float32)
        with self._lock:
            cached = self.store.get(model, texts, dim=self.cfg.dim)
            self.embed_requests += len(texts)
            self.embed_cache_hits += sum(v is not None for v in cached)
            miss = [i for i, v in enumerate(cached) if v is None]
        if miss:
            # dispatch OUTSIDE the manager lock: under the serving
            # runtime every tenant session shares this manager, and an
            # EMBED dispatch is the slow part of the path — holding the
            # lock across it would serialize all embedding traffic.
            # Two sessions racing on the same text at worst both
            # dispatch (the shared pipeline dedups them to one engine
            # execution) and the content-keyed put is idempotent.
            md = [dict(metadata[i]) if metadata else {} for i in miss]
            for m in md:
                m.setdefault("embed_dim", self.cfg.dim)
            vecs = client.embed([texts[i] for i in miss], model=model,
                                metadata=md)
            with self._lock:
                self.embed_llm_calls += len(miss)
                self.store.put(model, [texts[i] for i in miss], vecs,
                               dim=self.cfg.dim)
            for i, v in zip(miss, vecs):
                cached[i] = np.asarray(v, np.float32)
        return np.stack(cached).astype(np.float32)

    def coverage(self, client, texts: Sequence[str],
                 model: Optional[str] = None) -> float:
        """Fraction of ``texts`` already embedded — the cost model's
        expected miss rate for pricing an index-assisted plan."""
        return self.store.coverage(model or self.model_for(client),
                                   [str(t) for t in texts],
                                   dim=self.cfg.dim)

    # ------------------------------------------------------------------
    # index lifecycle
    # ------------------------------------------------------------------

    def ensure_index(self, client, column: str, texts: Sequence[str], *,
                     metadata: Optional[Sequence[Dict[str, Any]]] = None,
                     model: Optional[str] = None) -> IvfFlatIndex:
        """The column's index, building (or refreshing) it when the
        snapshot signature changed since the last build.  Embeddings go
        through the store, so a refresh re-embeds only new rows."""
        model = model or self.model_for(client)
        texts = [str(t) for t in texts]
        sig = EmbeddingStore.column_signature(model, texts, self.cfg.dim)
        with self._lock:
            entry = self._indexes.get(column)
            if entry is not None and entry[0] == sig:
                return entry[1]
        # embed outside the lock (see embed_texts); racing builders at
        # worst both construct the same index and the second registration
        # wins — deterministic inputs make the two identical
        vecs = self.embed_texts(client, texts, metadata=metadata,
                                model=model)
        with self._lock:
            entry = self._indexes.get(column)
            if entry is not None and entry[0] == sig:
                return entry[1]
            self.store.register_column(column, model, texts,
                                       dim=self.cfg.dim)
            nlist = (1 if len(texts) < self.cfg.min_index_rows
                     else self.cfg.nlist)
            index = IvfFlatIndex(vecs, IvfConfig(
                nlist=nlist, nprobe=self.cfg.nprobe,
                kmeans_iters=self.cfg.kmeans_iters, impl=self.cfg.impl),
                device=self.device)
            self._indexes[column] = (sig, index)
            self.index_builds += 1
            return index

    def index_for(self, column: str) -> Optional[IvfFlatIndex]:
        with self._lock:
            entry = self._indexes.get(column)
            return entry[1] if entry else None

    def has_index(self, column: str) -> bool:
        return self.index_for(column) is not None

    # ------------------------------------------------------------------
    # search fronts
    # ------------------------------------------------------------------

    def search(self, column: str, queries: np.ndarray, k: int, *,
               exact: Optional[bool] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over an indexed column; ``exact`` forces the flat scan
        (defaults to ``cfg.exact_topk``)."""
        index = self.index_for(column)
        if index is None:
            raise KeyError(f"no index for column {column!r}")
        with self._lock:
            self.index_searches += 1
        exact = self.cfg.exact_topk if exact is None else exact
        if exact:
            return index.search_flat(queries, k)
        return index.search(queries, k)

    def topk_candidates(self, queries: np.ndarray, corpus: np.ndarray,
                        k: int) -> Tuple[np.ndarray, np.ndarray]:
        """One-shot kernel top-k for ad-hoc (unindexed) vector sets —
        the flat path the filtered-scan pruning uses."""
        with self._lock:
            self.index_searches += 1
        q, c = (torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(x), dtype=np.float32)).to(self.device)
            for x in (queries, corpus))
        vals, idx = similarity_topk(q, c, k, impl=self.cfg.impl)
        return vals.cpu().numpy(), idx.cpu().numpy()

    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        return self.store.save(path)
