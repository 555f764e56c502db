"""IVF-flat approximate-nearest-neighbour index over unit vectors.

The classical two-level design: a seeded k-means partitions the corpus
into ``nlist`` coarse cells; a query probes the ``nprobe`` nearest cells
and scores only their members.  Every scoring path — centroid ranking,
cell scans, and the exact flat fallback — runs through the
`similarity_topk` kernel (K3), on the card where the index lives.

The corpus is kept as a tensor on the index's device, so a search reads
it from device memory with no host copy.  The k-means build runs on a
host copy in numpy, exactly as the JAX package's index does, so the
centroids, assignments and cells are bitwise those of that index.

With ``nprobe >= nlist`` the search degenerates to an exact flat scan
(same results as `search_flat`), which is how callers that need
bit-identical answers to the index-off path configure it.  Recall below
that is the classical IVF trade-off; `measure_recall` quantifies it
against the flat scan so the knob is tunable from evidence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.similarity_topk.ops import similarity_topk

IMPLS = ("auto", "reference")


@dataclasses.dataclass
class IvfConfig:
    """Index-build and search policy.

    Args:
        nlist: number of coarse k-means cells; 0/1 disables the coarse
            level (pure flat index).  Sized ~sqrt(N) classically.
        nprobe: cells scanned per query; recall knob (nprobe == nlist is
            an exact search).
        kmeans_iters: Lloyd iterations at build time (seeded, few).
        seed: determinism for centroid init.
        impl: kernel implementation — "auto" (the kernel on a CUDA
            device, the plain version on the CPU) or "reference" (the
            plain version on any device, for comparisons only).
    """
    nlist: int = 16
    nprobe: int = 4
    kmeans_iters: int = 5
    seed: int = 0
    impl: str = "auto"


def check_device(device, owner: str) -> torch.device:
    """``device`` as a torch device; raises for CUDA on a host without it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    return device


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


class IvfFlatIndex:
    """Build once over a column's vectors, search many times."""

    def __init__(self, vectors: np.ndarray,
                 cfg: Optional[IvfConfig] = None, *, device="cuda"):
        self.cfg = cfg or IvfConfig()
        if self.cfg.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.cfg.impl!r}")
        self.device = check_device(device, "IvfFlatIndex")
        host = _normalize(vectors)
        n = host.shape[0]
        self.nlist = max(1, min(self.cfg.nlist, n))
        self.centroids, self.assign = self._kmeans(host)
        # cell id -> member row ids (ascending, so ties keep flat order)
        self.cells = [np.nonzero(self.assign == c)[0]
                      for c in range(self.nlist)]
        self.vectors = self._tensor(host)
        self._centroids = self._tensor(self.centroids)
        self._cell_vectors = [self.vectors[self._tensor(m)]
                              for m in self.cells]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @property
    def num_vectors(self) -> int:
        return int(self.vectors.shape[0])

    # -- build ---------------------------------------------------------
    def _kmeans(self, v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Seeded spherical k-means (cosine Lloyd iterations), on the
        host."""
        n = v.shape[0]
        rng = np.random.default_rng(self.cfg.seed)
        cent = _normalize(v[rng.permutation(n)[:self.nlist]].copy())
        assign = np.zeros(n, np.int64)
        for _ in range(max(self.cfg.kmeans_iters, 1)):
            sims = v @ cent.T                       # [n, nlist]
            assign = np.argmax(sims, axis=1)
            for c in range(self.nlist):
                members = v[assign == c]
                if len(members):
                    cent[c] = members.mean(axis=0)
            cent = _normalize(cent)
        return cent, assign

    # -- search --------------------------------------------------------
    def _topk(self, q: torch.Tensor, corpus: torch.Tensor, k: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        vals, idx = similarity_topk(q, corpus, k, impl=self.cfg.impl)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_flat(self, queries: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over the whole corpus (kernel-scored).  Returns
        ``(vals [Q, k] fp32 descending, ids [Q, k] int32)``."""
        q = _normalize(np.atleast_2d(queries))
        return self._topk(self._tensor(q), self.vectors, k)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """IVF search: probe the ``nprobe`` best cells per query, scan
        their members through the kernel, merge per query.  Returns
        ``(vals [Q, k] descending, ids [Q, k] int64; -1 padding when a
        probe set holds fewer than k vectors)``."""
        nprobe = min(nprobe or self.cfg.nprobe, self.nlist)
        q = _normalize(np.atleast_2d(queries))
        if nprobe >= self.nlist:
            return self.search_flat(q, k)
        qt = self._tensor(q)
        _, probe = self._topk(qt, self._centroids, nprobe)   # [Q, nprobe]
        Q = q.shape[0]
        cand_v = [[] for _ in range(Q)]
        cand_i = [[] for _ in range(Q)]
        # scan cell by cell so each kernel call is one dense batch of
        # every query probing that cell
        for c in range(self.nlist):
            rows = np.nonzero((probe == c).any(axis=1))[0]
            members = self.cells[c]
            if not len(rows) or not len(members):
                continue
            kk = min(k, len(members))
            vals, idx = self._topk(qt[self._tensor(rows)],
                                   self._cell_vectors[c], kk)
            gids = members[idx]
            for j, qi in enumerate(rows):
                cand_v[qi].append(vals[j])
                cand_i[qi].append(gids[j])
        out_v = np.full((Q, k), -np.inf, np.float32)
        out_i = np.full((Q, k), -1, np.int64)
        for qi in range(Q):
            if not cand_v[qi]:
                continue
            v = np.concatenate(cand_v[qi])
            i = np.concatenate(cand_i[qi])
            # descending value, ascending id on ties — flat-scan order
            order = np.lexsort((i, -v))[:k]
            out_v[qi, :len(order)] = v[order]
            out_i[qi, :len(order)] = i[order]
        return out_v, out_i

    def measure_recall(self, queries: np.ndarray, k: int,
                       nprobe: Optional[int] = None) -> float:
        """Observed recall@k of the IVF search vs the exact flat scan —
        the evidence behind the ``nprobe`` knob."""
        q = np.atleast_2d(queries)
        _, exact = self.search_flat(q, k)
        _, approx = self.search(q, k, nprobe=nprobe)
        hits = total = 0
        for e, a in zip(np.asarray(exact), np.asarray(approx)):
            want = set(int(x) for x in e if x >= 0)
            got = set(int(x) for x in a if x >= 0)
            hits += len(want & got)
            total += len(want)
        return hits / total if total else 1.0
