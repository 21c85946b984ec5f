"""External vector-engine connectors (Milvus, pgvector), import-gated (a
copy of the reference package's ``retrieval/connectors.py``).

Parity with the reference's external stores (reference:
common/utils.py:143-225 — Milvus via llama-index/langchain wrappers with a
GPU_IVF_FLAT index, pgvector with DB auto-create at utils.py:157-164).
The client libraries (pymilvus, psycopg2) are not baked into this image, so
both classes import lazily and raise a clear error; the interface matches
``VectorStore`` exactly, so swapping engines is a config change
(``get_vector_store("milvus", url=...)``).
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

from ..utils.errors import ConfigError
from .store import SearchHit, VectorStore, _as_2d


class MilvusStore(VectorStore):
    """Milvus collection with IVF_FLAT (nlist/nprobe parity).

    reference: common/utils.py:181-186 builds GPU_IVF_FLAT nlist=64 and
    searches nprobe=16; CPU IVF_FLAT here — the accelerated path is the
    first-party ``exact-cuda`` store instead.
    """

    def __init__(self, dim: int, url: str = "http://localhost:19530",
                 collection: str = "rag", metric: str = "ip",
                 nlist: int = 64, nprobe: int = 16):
        try:
            from pymilvus import MilvusClient  # noqa: F401
        except ImportError as exc:
            raise ConfigError(
                "MilvusStore requires the 'pymilvus' package (not installed "
                "in this image). Use get_vector_store('exact'|'ivfflat') or "
                "install pymilvus.") from exc
        self._dim = dim
        self.metric = metric
        self.nprobe = nprobe
        self._client = MilvusClient(uri=url)
        self._collection = collection
        if not self._client.has_collection(collection):
            # auto_id: Milvus assigns primary keys, so reconnecting to an
            # existing collection can never collide with prior inserts.
            self._client.create_collection(
                collection_name=collection, dimension=dim, auto_id=True,
                metric_type="IP" if metric == "ip" else "L2",
                index_params={"index_type": "IVF_FLAT",
                              "params": {"nlist": nlist}})

    @property
    def dim(self) -> int:
        return self._dim

    def __len__(self) -> int:
        stats = self._client.get_collection_stats(self._collection)
        return int(stats["row_count"])

    def add(self, embeddings: np.ndarray) -> list[int]:
        emb = _as_2d(embeddings)
        res = self._client.insert(self._collection, [
            {"vector": row.tolist()} for row in emb])
        return [int(i) for i in res["ids"]]

    def search(self, queries: np.ndarray, k: int = 4) -> list[list[SearchHit]]:
        q = _as_2d(queries)
        res = self._client.search(
            self._collection, data=q.tolist(), limit=k,
            search_params={"params": {"nprobe": self.nprobe}})
        return [[SearchHit(int(h["id"]), float(h["distance"])) for h in row]
                for row in res]

    def delete(self, ids: Sequence[int]) -> None:
        self._client.delete(self._collection, ids=list(ids))

    def save(self, path: str) -> None:  # server-side persistence
        self._client.flush(self._collection)

    @classmethod
    def load(cls, path: str) -> "MilvusStore":
        raise NotImplementedError("MilvusStore persists server-side")


class PgvectorStore(VectorStore):
    """Postgres + pgvector table. Auto-creates the database and table the
    way the reference does (reference: common/utils.py:157-164)."""

    def __init__(self, dim: int, url: str = "postgresql://localhost:5432",
                 table: str = "rag_vectors", metric: str = "ip"):
        try:
            import psycopg2  # noqa: F401
        except ImportError as exc:
            raise ConfigError(
                "PgvectorStore requires 'psycopg2' (not installed in this "
                "image). Use get_vector_store('exact'|'ivfflat') or install "
                "psycopg2.") from exc
        import psycopg2
        if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", table):
            # the table name is interpolated into SQL below — reject
            # anything that isn't a plain identifier (injection guard)
            raise ConfigError(f"invalid pgvector table name {table!r}")
        self._dim = dim
        self.metric = metric
        self._table = table
        self._conn = psycopg2.connect(url)
        self._conn.autocommit = True
        with self._conn.cursor() as cur:
            cur.execute("CREATE EXTENSION IF NOT EXISTS vector")
            cur.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                f"(id BIGSERIAL PRIMARY KEY, embedding vector({dim}))")

    @property
    def dim(self) -> int:
        return self._dim

    def __len__(self) -> int:
        with self._conn.cursor() as cur:
            cur.execute(f"SELECT COUNT(*) FROM {self._table}")
            return int(cur.fetchone()[0])

    def add(self, embeddings: np.ndarray) -> list[int]:
        emb = _as_2d(embeddings)
        ids = []
        with self._conn.cursor() as cur:
            for row in emb:
                cur.execute(
                    f"INSERT INTO {self._table} (embedding) VALUES (%s) "
                    f"RETURNING id", (row.tolist(),))
                ids.append(int(cur.fetchone()[0]))
        return ids

    def search(self, queries: np.ndarray, k: int = 4) -> list[list[SearchHit]]:
        q = _as_2d(queries)
        op = "<#>" if self.metric == "ip" else "<->"  # negative ip / l2 dist
        out = []
        with self._conn.cursor() as cur:
            for row in q:
                cur.execute(
                    f"SELECT id, embedding {op} %s::vector AS d "
                    f"FROM {self._table} ORDER BY d LIMIT %s",
                    (row.tolist(), k))
                # Match the VectorStore score contract: ip → inner product
                # (pgvector's <#> is its negation), l2 → negated *squared*
                # distance (<-> is euclidean), so scores are comparable
                # across every backend.
                if self.metric == "ip":
                    hits = [SearchHit(int(i), -float(d))
                            for i, d in cur.fetchall()]
                else:
                    hits = [SearchHit(int(i), -float(d) ** 2)
                            for i, d in cur.fetchall()]
                out.append(hits)
        return out

    def delete(self, ids: Sequence[int]) -> None:
        with self._conn.cursor() as cur:
            cur.execute(f"DELETE FROM {self._table} WHERE id = ANY(%s)",
                        (list(ids),))

    def save(self, path: str) -> None:  # server-side persistence
        pass

    @classmethod
    def load(cls, path: str) -> "PgvectorStore":
        raise NotImplementedError("PgvectorStore persists server-side")
