"""The pluggable-example contract (a copy of the reference package's
``chains/base.py``).

Exact parity with the reference's ABC (reference: common/base.py:21-33):
``llm_chain`` / ``rag_chain`` stream answer text, ``ingest_docs`` loads a
file into the knowledge base; ``document_search`` is optional and duck-typed
by the server (reference: common/server.py:152).

Request identity: examples do NOT thread a request ID through these
signatures. The chain server binds the inbound request's flight-recorder
timeline (adopted ``X-Request-ID``/traceparent, ``obs/flight.py``) on the
context the chain generator runs under, so anything an example calls —
``event_span`` stages, the embedder, ``Engine.submit`` via EngineLLM —
lands on the right per-request timeline automatically. An example that
wants the ID (e.g. to tag its own logs) reads
``current_request_id()`` below.
"""

from __future__ import annotations

import abc
from typing import Generator

from ..obs.flight import current_request_id  # noqa: F401  (re-export)


class BaseExample(abc.ABC):
    """Base class for all chain-server examples."""

    @abc.abstractmethod
    def llm_chain(self, context: str, question: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        """Answer ``question`` with the LLM alone (no knowledge base);
        ``context`` is caller-supplied free text."""

    @abc.abstractmethod
    def rag_chain(self, prompt: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        """Answer using retrieval over the ingested knowledge base."""

    @abc.abstractmethod
    def ingest_docs(self, data_dir: str, filename: str) -> None:
        """Load a document file into the knowledge base."""

    # Optional (duck-typed by the server, like the reference):
    # def document_search(self, content: str, num_docs: int) -> list[dict]
