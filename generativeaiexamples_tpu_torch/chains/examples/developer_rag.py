"""The canonical QA chatbot: ingest → retrieve → prompt → stream — port of
the reference package's ``chains/examples/developer_rag.py``.

``ingest_docs`` reads a file, splits it (510/200 tokens by default) and
indexes the chunks; ``llm_chain`` answers without retrieval;
``rag_chain`` retrieves the top k (4), caps the context (1500 tokens),
fills the RAG template and streams the answer; ``document_search``
exposes raw retrieval. When retrieval fails the answer comes from the
model alone, behind a notice (``degrade_to_llm``).

Fused RAG (``engine/rag_fusion.py``), the default when it can run: with an
in-process engine (``EngineLLM``), an embedder that runs on the device
(it has ``params`` and ``cfg``) and a store that exports its vectors,
``ingest_docs`` mirrors the corpus onto the engine, and ``rag_chain``
retrieves, assembles the prompt and prefills in one device program.
``GENAI_TPU_FUSED_RAG=0`` (or ``fused_rag=False``) keeps the host path;
questions longer than the spec's question bucket take it too.
"""

from __future__ import annotations

import base64
import os
from typing import Generator, Optional

from ...embed.encoder import get_embedder
from ...obs import flight as obs_flight
from ...obs import metrics as obs_metrics
from ...obs.tracing import event_span
from ...retrieval.docstore import Document, DocumentIndex
from ...utils.app_config import get_config
from ...utils.errors import BreakerOpenError, RetrievalError
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
    """Canonical developer RAG chatbot."""

    def __init__(self, llm=None, embedder=None,
                 index: Optional[DocumentIndex] = None,
                 config=None, engine=None, fused_rag: Optional[bool] = None):
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
        # Fused RAG: None turns it on where it can run (the reference's
        # switch, GENAI_TPU_FUSED_RAG, on unless "0").
        if fused_rag is None:
            fused_rag = os.environ.get("GENAI_TPU_FUSED_RAG", "1") != "0"
        self._fused_requested = fused_rag
        self._fused_ready = False
        self._fused_spec = None
        self._fused_doc_ids: list[int] = []
        self._fused_sources: list[int] = []

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
        self._sync_fused_corpus()

    def _sync_fused_corpus(self) -> None:
        """Mirror the corpus onto the device for fused-RAG admission.
        Best effort, as the reference's: a remote LLM, an embedder on the
        host or a store without raw vectors leaves the host path in
        charge, and a failure is logged with its traceback."""
        self._fused_ready = False
        if not self._fused_requested:
            return
        from ..llm import EngineLLM
        if not isinstance(self.llm, EngineLLM):
            return
        emb = self.index.embedder
        if not (hasattr(emb, "params") and hasattr(emb, "cfg")):
            return
        data = self.index.export_corpus()
        if data is None or not data[0]:
            return
        try:
            from ...engine.rag_fusion import (FusedRagSpec,
                                              build_prompt_parts,
                                              corpus_rows)
            engine = self.llm.engine
            parts = build_prompt_parts(
                self.config.prompts.rag_template, engine.tokenizer)
            C = self.config.text_splitter.chunk_size + 32
            K = self.config.retriever.top_k
            ids, vecs, texts = data
            toks, lens = corpus_rows(texts, engine.tokenizer, C)
            # The bucket comes from the configuration's worst case (k
            # chunks at the splitter's cap and their separators), not from
            # this corpus: a corpus-derived bucket would move as files
            # arrive and capture the program again on every ingest.
            q_bucket = 64
            budget = min(self.config.retriever.max_context_tokens,
                         K * (C + len(parts["sep_ids"])))
            overhead = (len(parts["prefix_ids"]) + len(parts["mid_ids"])
                        + len(parts["suffix_ids"]) + q_bucket)
            page = engine.cfg.page_size
            bucket = -(-(overhead + budget) // page) * page
            bucket = min(bucket, (engine.cfg.max_cache_len // page - 1)
                         * page)
            # A clamped bucket clamps the context budget with it, or the
            # question would land past the bucket's end and be dropped.
            budget = min(budget, bucket - overhead)
            if budget <= 0:
                logger.warning("fused RAG disabled: prompt bucket %d "
                               "cannot hold template+question", bucket)
                return
            spec = FusedRagSpec(**parts, top_k=K, ctx_budget=budget,
                                bucket=bucket, chunk_tokens=C,
                                q_bucket=q_bucket, enc_bucket=128)
            # The engine's spec, not one kept here: a rebuilt engine has
            # no fused program even if this chatbot enabled the same spec.
            if engine.fused_rag_spec != spec:
                engine.enable_fused_rag(emb.params, emb.cfg, spec)
            self._fused_spec = spec
            engine.set_rag_corpus(vecs, toks, lens)
            self._fused_doc_ids = ids
            self._fused_ready = True
        except Exception:  # noqa: BLE001 - fused RAG is an optimization
            logger.exception("fused-RAG corpus sync failed; "
                             "using the host retrieval path")

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
        # Attribution is per request: cleared before either path runs.
        self._fused_sources = []
        spec = self._fused_spec if self._fused_ready else None
        q_ids = (self.llm.engine.tokenizer.encode(prompt, add_bos=False)
                 if spec is not None else [])
        if spec is not None and len(q_ids) <= spec.q_bucket:
            # Retrieval, prompt assembly and prefill in the engine's
            # admission program: one device dispatch, one readback.
            enc_ids = self.index.embedder.tokenizer.encode(f"query: {prompt}")

            def keep_sources(rows: list[int]) -> None:
                # The corpus rows the device picked, as document ids.
                ids = self._fused_doc_ids
                self._fused_sources = [ids[r] for r in rows
                                       if 0 <= r < len(ids)]

            with event_span("llm", fused_rag=True, num_tokens=num_tokens):
                yield from self.llm.stream_rag(
                    prompt, enc_ids, max_tokens=num_tokens,
                    stop=["</s>", "[INST]"], on_sources=keep_sources,
                    q_ids=q_ids)
            return
        # Longer questions take the host path, which has no question
        # bucket. Child spans per pipeline stage (retrieve, templating,
        # llm).
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

    @property
    def last_sources(self) -> list[dict]:
        """Source attribution of the latest fused-RAG answer: the metadata
        of the chunks the device's retrieval picked. Empty when the host
        path served the latest request."""
        out = []
        for i in self._fused_sources:
            doc = self.index.get(i)
            if doc is not None:
                out.append({"source": doc.metadata.get("source", ""),
                            "chunk": doc.metadata.get("chunk")})
        return out

    # ------------------------------------------------------------- search

    def document_search(self, content: str, num_docs: int) -> list[dict]:
        """Raw retrieval results: [{score, source, content}]."""
        docs = self.index.similarity_search(content, k=num_docs)
        return [{"score": d.score,
                 "source": d.metadata.get("source", ""),
                 "content": d.text} for d in docs]


Example = QAChatbot
