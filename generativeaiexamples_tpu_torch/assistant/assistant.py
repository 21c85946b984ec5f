"""The multimodal assistant example: office-document RAG with memory and
a guardrail (a port of the reference package's ``assistant/assistant.py``).

A ``BaseExample``, so the port's chain server and web frontend serve it
unchanged:

    python -m generativeaiexamples_tpu_torch.chains.server --example \
        generativeaiexamples_tpu_torch.assistant.assistant

Beside the developer RAG example: PPTX/DOCX ingestion with slide-aware
chunk metadata, conversation memory folded into the prompt, an LLM fact
check appended to grounded answers, and feedback capture. Its LLM is
``chains.llm.get_llm`` (``torch-cuda`` over an in-process ``Engine``
passed as ``engine=``), its index a ``DocumentIndex`` over the
configured embedder and store.
"""

from __future__ import annotations

import os
from typing import Generator, Optional

from ..chains.base import BaseExample
from ..chains.llm import get_llm
from ..chains.readers import read_document
from ..chains.splitter import TokenTextSplitter, cap_context
from ..embed.encoder import get_embedder
from ..retrieval.docstore import Document, DocumentIndex
from ..utils.app_config import get_config
from ..utils.logging import get_logger
from .feedback import FeedbackStore
from .guardrails import fact_check
from .memory import ConversationMemory
from .parsers import parse_pptx, read_docx, read_pptx

logger = get_logger(__name__)

PROMPT = (
    "You are a helpful assistant answering questions about the user's "
    "documents.\n"
    "{history_block}"
    "Context from the documents:\n{context}\n\n"
    "Question: {question}\nAnswer:"
)


class MultimodalAssistant(BaseExample):
    """Office-document assistant with memory, guardrail, feedback."""

    def __init__(self, llm=None, embedder=None,
                 index: Optional[DocumentIndex] = None, config=None,
                 engine=None, check_facts: bool = True,
                 feedback_path: str = "./feedback.jsonl"):
        self.config = config or get_config()
        self.llm = llm or get_llm(self.config, engine=engine)
        # ``is not None``: an empty index is falsy (it has a length).
        embedder = embedder or (index.embedder if index is not None
                                else None) or \
            get_embedder(self.config.embeddings.model_engine,
                         self.config.embeddings.model_name,
                         dim=self.config.embeddings.dimensions)
        if index is None:
            from ..retrieval.store import store_from_config
            index = DocumentIndex(embedder, store=store_from_config(
                self.config.vector_store, embedder.dim))
        self.index = index
        self.splitter = TokenTextSplitter(
            chunk_size=self.config.text_splitter.chunk_size,
            chunk_overlap=self.config.text_splitter.chunk_overlap)
        self.memory = ConversationMemory()
        self.check_facts = check_facts
        self.feedback = FeedbackStore(feedback_path)

    # ----------------------------------------------------------- ingestion

    def ingest_docs(self, data_dir: str, filename: str) -> None:
        """PPTX decks keep per-slide provenance (the reference's parser
        attaches slide metadata for citations); DOCX and everything the
        base readers cover flatten to text first."""
        ext = os.path.splitext(filename)[1].lower()
        docs: list[Document] = []
        if ext == ".pptx":
            for slide in parse_pptx(data_dir):
                body = slide.text + (f"\n(notes: {slide.notes})"
                                     if slide.notes else "")
                for i, chunk in enumerate(self.splitter.split_text(body)):
                    docs.append(Document(text=chunk, metadata={
                        "source": filename, "slide": slide.index,
                        "chunk": i, "images": slide.images}))
        else:
            text = read_docx(data_dir) if ext == ".docx" \
                else read_document(data_dir)
            docs = [Document(text=c, metadata={"source": filename,
                                               "chunk": i})
                    for i, c in enumerate(self.splitter.split_text(text))]
        self.index.add_documents(docs)
        logger.info("assistant ingested %s: %d chunks", filename, len(docs))

    # -------------------------------------------------------------- chains

    def _prompt(self, context: str, question: str) -> str:
        history = self.memory.render()
        history_block = (f"Conversation so far:\n{history}\n\n"
                         if history else "")
        return PROMPT.format(history_block=history_block, context=context,
                             question=question)

    def llm_chain(self, context: str, question: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        answer_parts: list[str] = []
        for chunk in self.llm.stream(
                self._prompt(context or "(none)", question),
                max_tokens=num_tokens, stop=["</s>", "[INST]"]):
            answer_parts.append(chunk)
            yield chunk
        self.memory.add(question, "".join(answer_parts))

    def rag_chain(self, prompt: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        docs = self.index.similarity_search(
            prompt, k=self.config.retriever.top_k)
        context_texts = cap_context(
            [d.text for d in docs],
            max_tokens=self.config.retriever.max_context_tokens,
            tokenizer=self.splitter.tok)
        context = "\n\n".join(context_texts)
        answer_parts: list[str] = []
        for chunk in self.llm.stream(self._prompt(context, prompt),
                                     max_tokens=num_tokens,
                                     stop=["</s>", "[INST]"]):
            answer_parts.append(chunk)
            yield chunk
        answer = "".join(answer_parts)
        self.memory.add(prompt, answer)
        if self.check_facts and context:
            verdict = fact_check(self.llm, context, prompt, answer)
            if verdict.supported is True:
                yield "\n\n[fact check: supported by the documents]"
            elif verdict.supported is False:
                yield ("\n\n[fact check: NOT fully supported — "
                       f"{verdict.explanation[:200]}]")

    # ------------------------------------------------------------- search

    def document_search(self, content: str, num_docs: int) -> list[dict]:
        docs = self.index.similarity_search(content, k=num_docs)
        out = []
        for d in docs:
            label = d.metadata.get("source", "")
            if "slide" in d.metadata:
                label += f" (slide {d.metadata['slide']})"
            out.append({"score": d.score, "source": label,
                        "content": d.text})
        return out

    # ------------------------------------------------------------ feedback

    def record_feedback(self, question: str, answer: str, rating: int,
                        comment: str = "") -> dict:
        return self.feedback.record(question, answer, rating, comment)


Example = MultimodalAssistant
