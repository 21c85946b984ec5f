"""VectorStore interface and factory (a copy of the reference package's
``retrieval/store.py``; the on-device store is ``exact-cuda``).

Every backend implements one small interface, so the chain server and
the ingest path are store-agnostic.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class SearchHit:
    """One nearest-neighbor result: integer id + similarity score
    (higher = more similar for ip/cosine; negative squared distance for l2)."""
    id: int
    score: float


class VectorStore(abc.ABC):
    """Append-only vector index with top-k search.

    Embeddings are float32 row vectors. Ids are assigned sequentially by
    ``add`` and stay stable across save/load; ``delete`` tombstones.
    """

    metric: str  # "ip" | "l2"  (cosine == ip on normalized vectors)

    @property
    @abc.abstractmethod
    def dim(self) -> int: ...

    @abc.abstractmethod
    def __len__(self) -> int:
        """Number of live (non-deleted) vectors."""

    @abc.abstractmethod
    def add(self, embeddings: np.ndarray) -> list[int]:
        """Insert rows; returns their new ids."""

    @abc.abstractmethod
    def search(self, queries: np.ndarray, k: int = 4,
               ) -> list[list[SearchHit]]:
        """Top-k per query row. ``queries`` may be (D,) or (Q, D)."""

    @abc.abstractmethod
    def delete(self, ids: Sequence[int]) -> None: ...

    @abc.abstractmethod
    def save(self, path: str) -> None: ...

    @classmethod
    @abc.abstractmethod
    def load(cls, path: str) -> "VectorStore": ...


def _as_2d(queries: np.ndarray) -> np.ndarray:
    q = np.asarray(queries, np.float32)
    return q[None, :] if q.ndim == 1 else q


def score_matrix(base: np.ndarray, queries: np.ndarray, metric: str,
                 base_sqnorm: Optional[np.ndarray] = None) -> np.ndarray:
    """(Q, N) similarity scores. l2 is returned as negated squared distance
    so that argmax == nearest for every metric."""
    dots = queries @ base.T
    if metric == "ip":
        return dots
    if metric == "l2":
        if base_sqnorm is None:
            base_sqnorm = np.einsum("nd,nd->n", base, base)
        q_sq = np.einsum("qd,qd->q", queries, queries)
        return 2.0 * dots - base_sqnorm[None, :] - q_sq[:, None]
    raise ValueError(f"unknown metric {metric!r}")


def get_vector_store(name: str = "exact", dim: int = 1024, **kwargs,
                     ) -> VectorStore:
    """Backend factory, parity with the reference's name-switched selection
    (reference: common/utils.py:150-189). Names: ``exact`` (numpy/native),
    ``exact-cuda`` (on-device matmul top-k), ``ivfflat`` (first-party ANN),
    ``milvus`` / ``pgvector`` (external engines, gated on their client libs).
    The reference's ``exact-tpu`` raises ``ConfigError`` naming
    ``exact-cuda``.
    """
    from ..utils.app_config import refuse_tpu_name
    name = name.lower()
    refuse_tpu_name("vector_store.name", name)
    if name == "exact":
        from .exact import ExactStore
        return ExactStore(dim=dim, **kwargs)
    if name == "exact-cuda":
        from .exact import ExactStore
        return ExactStore(dim=dim, backend="cuda", **kwargs)
    if name == "ivfflat":
        from .ivf import IVFFlatStore
        return IVFFlatStore(dim=dim, **kwargs)
    if name == "milvus":
        from .connectors import MilvusStore
        return MilvusStore(dim=dim, **kwargs)
    if name == "pgvector":
        from .connectors import PgvectorStore
        return PgvectorStore(dim=dim, **kwargs)
    raise ValueError(f"unknown vector store {name!r}")


def store_from_config(cfg, dim: int) -> VectorStore:
    """Build a store from a ``VectorStoreConfig`` section, forwarding the
    backend-relevant knobs (url for remote engines, nlist/nprobe for ANN) —
    the wiring the reference does inline in ``get_vector_index``
    (reference: common/utils.py:150-189)."""
    name = cfg.name.lower()
    kwargs: dict = {}
    if name == "ivfflat":
        kwargs.update(nlist=cfg.nlist, nprobe=cfg.nprobe)
    elif name in ("milvus", "pgvector"):
        if cfg.url:
            kwargs["url"] = cfg.url
        if name == "milvus":
            kwargs.update(nlist=cfg.nlist, nprobe=cfg.nprobe)
    return get_vector_store(name, dim=dim, **kwargs)
