"""Semantic index subsystem: embedding store + IVF-flat ANN index.

Connects the SQL layer to the kernel library: `EmbeddingStore` caches
content-addressed vectors, `IvfFlatIndex` keeps a column's unit vectors
on the card and retrieves top-k neighbours through the
``similarity_topk`` kernel (K3), and `SemanticIndexManager` ties both to
catalog columns, the inference client (EMBED requests) and the
optimizer's cost race.  See ``docs/semantic-index.md``.
"""
from repro_torch.semindex.store import EmbeddingStore, content_key  # noqa: F401
from repro_torch.semindex.index import IvfConfig, IvfFlatIndex      # noqa: F401
from repro_torch.semindex.manager import (SemanticIndexManager,     # noqa: F401
                                          SemIndexConfig)
