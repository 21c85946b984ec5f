"""DocumentIndex: embedder + vector store + text/metadata in one object (a
copy of the reference package's ``retrieval/docstore.py``).

The working unit the chain server ingests into and retrieves from — the
role LlamaIndex's ``VectorStoreIndex`` / LangChain's vectorstore wrappers
play in the reference (reference: common/utils.py:143-229,
examples/developer_rag/chains.py:77-80 ``insert_nodes``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

from ..utils import faults
from ..utils.errors import RetrievalError
from ..utils.resilience import get_breaker
from .store import VectorStore, get_vector_store


@dataclass
class Document:
    """A retrievable chunk: text + metadata (+ score when returned)."""
    text: str
    metadata: dict[str, Any] = field(default_factory=dict)
    id: Optional[int] = None
    score: Optional[float] = None


class DocumentIndex:
    def __init__(self, embedder, store: Optional[VectorStore] = None,
                 store_name: str = "exact"):
        self.embedder = embedder
        # ``is not None``: an empty store is falsy (it has a length), and
        # must not be swapped for the default one.
        self.store = (store if store is not None
                      else get_vector_store(store_name, dim=embedder.dim))
        self._docs: dict[int, Document] = {}

    def __len__(self) -> int:
        return len(self.store)

    def add_documents(self, docs: Sequence[Document]) -> list[int]:
        if not docs:
            return []
        emb = self.embedder.embed_documents([d.text for d in docs])
        ids = self.store.add(np.asarray(emb, np.float32))
        for i, doc in zip(ids, docs):
            doc.id = i
            self._docs[i] = doc
        return ids

    def add_texts(self, texts: Sequence[str],
                  metadatas: Optional[Sequence[dict]] = None) -> list[int]:
        metadatas = metadatas or [{} for _ in texts]
        return self.add_documents(
            [Document(text=t, metadata=dict(m))
             for t, m in zip(texts, metadatas)])

    def similarity_search(self, query: str, k: int = 4) -> list[Document]:
        """Top-k documents for a text query (embedder's query mode).

        Both external dependencies — the embedder and the vector store —
        run under named circuit breakers (utils/resilience.py): after
        repeated failures the breaker opens and this raises
        ``BreakerOpenError`` in microseconds instead of stalling on a
        dead backend. Raw backend exceptions (a down Milvus, a pgvector
        connection reset, an injected fault) are wrapped in
        ``RetrievalError`` with ``reason`` set to the failing dependency,
        so chains can degrade to their LLM-only path and label the
        fallback. ``BreakerOpenError`` passes through untouched (it
        already carries the breaker name)."""
        from ..obs.tracing import event_span
        from ..utils.errors import BreakerOpenError

        def _embed():
            faults.inject("embed")
            return np.asarray(self.embedder.embed_query(query), np.float32)

        def _search(q):
            faults.inject("retrieval.search")
            return self.store.search(q, k=k)

        if len(self.store) == 0:
            return []
        try:
            with event_span("embedding", mode="query", chars=len(query)):
                q = get_breaker("embed").call(_embed)
        except BreakerOpenError:
            raise
        except Exception as exc:  # noqa: BLE001 — typed for degradation
            raise RetrievalError(f"query embedding failed: {exc}",
                                 reason="embed") from exc
        try:
            hits = get_breaker("retrieval").call(_search, q)[0]
        except BreakerOpenError:
            raise
        except Exception as exc:  # noqa: BLE001 — typed for degradation
            raise RetrievalError(f"vector search failed: {exc}",
                                 reason="retrieval") from exc
        out = []
        for hit in hits:
            doc = self._docs.get(hit.id)
            if doc is not None:
                out.append(Document(text=doc.text, metadata=doc.metadata,
                                    id=hit.id, score=hit.score))
        return out

    def get(self, doc_id: int):
        """The stored Document for an id, or None."""
        return self._docs.get(doc_id)

    def export_corpus(self):
        """(ids, embeddings (N, D), texts) of every live document — the
        feed for the engine's device-resident fused-RAG corpus. None when
        the backing store can't expose raw vectors (external servers)."""
        export = getattr(self.store, "export_vectors", None)
        if export is None:
            return None
        ids, emb = export()
        keep = [(i, row) for i, row in zip(ids, emb) if i in self._docs]
        if not keep:
            return [], np.zeros((0, self.embedder.dim), np.float32), []
        ids = [i for i, _ in keep]
        emb = np.stack([row for _, row in keep])
        return ids, emb, [self._docs[i].text for i in ids]

    def delete(self, ids: Sequence[int]) -> None:
        self.store.delete(ids)
        for i in ids:
            self._docs.pop(i, None)

    def sources(self) -> list[str]:
        """Distinct source filenames across the index (for the KB page;
        reference: frontend kb.py file table)."""
        names = {d.metadata.get("source", "") for d in self._docs.values()}
        return sorted(n for n in names if n)

    # ---------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.store.save(os.path.join(path, "store"))
        with open(os.path.join(path, "docs.jsonl"), "w") as f:
            for i, doc in sorted(self._docs.items()):
                f.write(json.dumps(
                    {"id": i, "text": doc.text, "metadata": doc.metadata}) + "\n")

    def load_docs(self, path: str) -> None:
        """Restore texts/metadata; the store is reloaded by its own class."""
        with open(os.path.join(path, "docs.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                self._docs[rec["id"]] = Document(
                    text=rec["text"], metadata=rec["metadata"], id=rec["id"])
