"""The canonical QA chatbot: ingest → retrieve → prompt → stream — port of
the reference package's ``chains/examples/developer_rag.py``.

``ingest_docs`` reads a file, splits it (510/200 tokens by default) and
indexes the chunks; ``llm_chain`` answers without retrieval;
``rag_chain`` retrieves the top k (4), caps the context (1500 tokens),
fills the RAG template and streams the answer; ``document_search``
exposes raw retrieval. When retrieval fails the answer comes from the
model alone, behind a notice (``degrade_to_llm``).

This is the reference's host path. Its fused path (retrieval and prompt
assembly inside the engine's admission program) is not ported yet:
``fused_rag=True`` raises ``ConfigError``, and the default (``None``,
which auto-enables fused RAG in the reference) takes the host path.
"""

from __future__ import annotations

import base64
from typing import Generator, Optional

from ...embed.encoder import get_embedder
from ...obs import flight as obs_flight
from ...obs import metrics as obs_metrics
from ...obs.tracing import event_span
from ...retrieval.docstore import Document, DocumentIndex
from ...utils.app_config import get_config
from ...utils.errors import BreakerOpenError, ConfigError, RetrievalError
from ...utils.logging import get_logger
from ..base import BaseExample
from ..llm import get_llm
from ..readers import read_document
from ..splitter import TokenTextSplitter, cap_context

logger = get_logger(__name__)

#: User-visible preamble when retrieval is down and the answer comes from
#: the model alone.
DEGRADED_NOTICE = ("[notice] the knowledge base is temporarily "
                   "unavailable; answering from the model alone.\n\n")


def record_degraded(reason: str) -> None:
    """Count a degraded answer and stamp the request's flight timeline —
    the signal that separates 'quality dip' from 'outage' on /metrics."""
    obs_metrics.REGISTRY.counter(
        "degraded_total", "requests served degraded, by failed dependency",
        labelnames=("reason",)).labels(reason).inc()
    tl = obs_flight.current()
    if tl is not None:
        tl.annotate(degraded=reason)


def degrade_to_llm(chatbot, exc, prompt: str, num_tokens: int,
                   ) -> Generator[str, None, None]:
    """Retrieval-down fallback: notice + LLM-only answer. The fallback's
    FIRST chunk is pulled before anything is yielded — if the LLM is down
    too, its typed error propagates with nothing emitted, so the chain
    server still maps it to a real pre-stream HTTP status. The degraded
    counter likewise only moves once the fallback is serving."""
    reason = (getattr(exc, "reason", "") or
              getattr(exc, "breaker", "") or "retrieval")
    logger.warning("rag chain degrading to llm_chain (%s): %s", reason, exc)
    fallback = chatbot.llm_chain("", prompt, num_tokens)
    try:
        first = next(fallback)
    except StopIteration:
        first = None
    record_degraded(reason)
    yield DEGRADED_NOTICE
    if first is not None:
        yield first
    yield from fallback


class QAChatbot(BaseExample):
    """Canonical developer RAG chatbot (the host path)."""

    def __init__(self, llm=None, embedder=None,
                 index: Optional[DocumentIndex] = None,
                 config=None, engine=None, fused_rag: Optional[bool] = None):
        if fused_rag:
            raise ConfigError(
                "fused RAG (retrieval inside the engine's admission "
                "program) is not ported yet (ROADMAP: fused RAG); pass "
                "fused_rag=None or False for the host path")
        if fused_rag is None:
            logger.info("fused RAG is not ported; the chatbot takes the "
                        "host retrieval path")
        self.config = config or get_config()
        self.llm = llm or get_llm(self.config, engine=engine)
        # ``is not None``: an empty index is falsy (it has a length).
        embedder = embedder or (index.embedder if index is not None
                                else None) or \
            get_embedder(self.config.embeddings.model_engine,
                         self.config.embeddings.model_name,
                         dim=self.config.embeddings.dimensions)
        if index is None:
            from ...retrieval.store import store_from_config
            index = DocumentIndex(embedder, store=store_from_config(
                self.config.vector_store, embedder.dim))
        self.index = index
        self.splitter = TokenTextSplitter(
            chunk_size=self.config.text_splitter.chunk_size,
            chunk_overlap=self.config.text_splitter.chunk_overlap)

    # ----------------------------------------------------------- ingestion

    def ingest_docs(self, data_dir: str, filename: str) -> None:
        """Read, chunk, and index one document file. The filename is also
        kept base64-encoded in each chunk's metadata, to survive odd
        characters."""
        text = read_document(data_dir)
        chunks = self.splitter.split_text(text)
        encoded = base64.b64encode(filename.encode()).decode()
        docs = [Document(text=c, metadata={"source": filename,
                                           "source_b64": encoded,
                                           "chunk": i})
                for i, c in enumerate(chunks)]
        self.index.add_documents(docs)
        logger.info("ingested %s: %d chunks", filename, len(chunks))

    # -------------------------------------------------------------- chains

    def llm_chain(self, context: str, question: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        prompt = self.config.prompts.chat_template.format(
            context_str=context or "", query_str=question)
        with event_span("llm", num_tokens=num_tokens):
            yield from self.llm.stream(prompt, max_tokens=num_tokens,
                                       stop=["</s>", "[INST]"])

    def rag_prompt(self, docs: list[Document], question: str) -> str:
        """The prompt ``rag_chain`` sends for retrieved ``docs``: the
        leading documents within the context cap, joined, in the RAG
        template."""
        context_texts = cap_context(
            [d.text for d in docs],
            max_tokens=self.config.retriever.max_context_tokens,
            tokenizer=self.splitter.tok)
        return self.config.prompts.rag_template.format(
            context_str="\n\n".join(context_texts), query_str=question)

    def rag_chain(self, prompt: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        # Child spans per pipeline stage (retrieve, templating, llm).
        try:
            with event_span("retrieve",
                            top_k=self.config.retriever.top_k) as sp:
                docs = self.index.similarity_search(
                    prompt, k=self.config.retriever.top_k)
                if sp is not None:
                    for i, d in enumerate(docs):
                        sp.set_attribute(f"retrieval.score.{i}",
                                         float(d.score or 0.0))
        except (RetrievalError, BreakerOpenError) as exc:
            # Graceful degradation: a dead vector store or embedder costs
            # retrieval QUALITY, not the whole chatbot.
            yield from degrade_to_llm(self, exc, prompt, num_tokens)
            return
        with event_span("templating", n_docs=len(docs)):
            full_prompt = self.rag_prompt(docs, prompt)
        with event_span("llm", num_tokens=num_tokens,
                        prompt_chars=len(full_prompt)):
            yield from self.llm.stream(full_prompt, max_tokens=num_tokens,
                                       stop=["</s>", "[INST]"])

    # ------------------------------------------------------------- search

    def document_search(self, content: str, num_docs: int) -> list[dict]:
        """Raw retrieval results: [{score, source, content}]."""
        docs = self.index.similarity_search(content, k=num_docs)
        return [{"score": d.score,
                 "source": d.metadata.get("source", ""),
                 "content": d.text} for d in docs]


Example = QAChatbot
