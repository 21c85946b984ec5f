"""Remote-endpoints QA chatbot: RAG over an OpenAI-style LLM server — port
of the reference package's ``chains/examples/foundation_endpoints.py``.

The model sits behind any OpenAI-style ``/v1/completions`` server (this
package's model server included); retrieval keeps the chunks scoring at
least ``SCORE_THRESHOLD`` of the top k.
"""

from __future__ import annotations

import base64
from typing import Generator, Optional

from ...embed.encoder import get_embedder
from ...retrieval.docstore import Document, DocumentIndex
from ...utils.app_config import get_config
from ...utils.errors import ChainError
from ...utils.logging import get_logger
from ..base import BaseExample
from ..llm import OpenAICompatLLM, get_llm
from ..readers import read_document
from ..splitter import TokenTextSplitter

logger = get_logger(__name__)

# The similarity-score threshold of the retriever.
SCORE_THRESHOLD = 0.25


class RemoteEndpointsChatbot(BaseExample):
    def __init__(self, llm=None, embedder=None,
                 index: Optional[DocumentIndex] = None, config=None):
        self.config = config or get_config()
        if llm is None:
            if self.config.llm.server_url:
                llm = OpenAICompatLLM(self.config.llm.server_url,
                                      self.config.llm.model_name)
            else:
                llm = get_llm(self.config)
        self.llm = llm
        # ``is not None``: an empty index is falsy (it has a length).
        embedder = embedder or (index.embedder if index is not None
                                else None) or \
            get_embedder(self.config.embeddings.model_engine,
                         self.config.embeddings.model_name,
                         dim=self.config.embeddings.dimensions)
        self.index = index if index is not None else DocumentIndex(embedder)
        self.splitter = TokenTextSplitter(
            chunk_size=self.config.text_splitter.chunk_size,
            chunk_overlap=self.config.text_splitter.chunk_overlap)

    def ingest_docs(self, data_dir: str, filename: str) -> None:
        """Read, chunk and index one file (a file with no text raises)."""
        text = read_document(data_dir)
        if not text.strip():
            raise ChainError(f"no text extracted from {filename}")
        chunks = self.splitter.split_text(text)
        encoded = base64.b64encode(filename.encode()).decode()
        self.index.add_documents(
            [Document(text=c, metadata={"source": filename,
                                        "source_b64": encoded, "chunk": i})
             for i, c in enumerate(chunks)])
        logger.info("ingested %s: %d chunks", filename, len(chunks))

    def llm_chain(self, context: str, question: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        prompt = self.config.prompts.chat_template.format(
            context_str=context or "", query_str=question)
        yield from self.llm.stream(prompt, max_tokens=num_tokens,
                                   stop=["</s>", "[INST]"])

    def rag_chain(self, prompt: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        """The top k over the score threshold, joined into the RAG
        template."""
        docs = [d for d in self.index.similarity_search(
                    prompt, k=self.config.retriever.top_k)
                if d.score is None or d.score >= SCORE_THRESHOLD]
        context = "\n\n".join(d.text for d in docs)
        full = self.config.prompts.rag_template.format(
            context_str=context, query_str=prompt)
        yield from self.llm.stream(full, max_tokens=num_tokens,
                                   stop=["</s>", "[INST]"])

    def document_search(self, content: str, num_docs: int) -> list[dict]:
        docs = self.index.similarity_search(content, k=num_docs)
        return [{"score": d.score, "source": d.metadata.get("source", ""),
                 "content": d.text} for d in docs]


Example = RemoteEndpointsChatbot
