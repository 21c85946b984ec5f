"""Recursive query-decomposition agent — port of the reference package's
``chains/examples/query_decomposition.py``.

The LLM either asks for a tool, answering with JSON ``{"Tool_Request":
..., "Generated Sub Questions": [...]}``, or finishes with
``"Tool_Request": "Done"``. Tools: **Search** (retrieval, then the answer
to each sub-question extracted from the context) and **Math** (LLM
arithmetic). A ``Ledger`` accumulates the sub-questions and their
answers; search rounds are capped at ``MAX_SEARCH_ROUNDS``; the final
answer is written from the ledger."""

from __future__ import annotations

import base64
import json
import re
from dataclasses import dataclass, field
from typing import Generator, Optional

from ...embed.encoder import get_embedder
from ...retrieval.docstore import Document, DocumentIndex
from ...utils.app_config import get_config
from ...utils.errors import BreakerOpenError, RetrievalError
from ...utils.logging import get_logger
from .developer_rag import degrade_to_llm
from ..base import BaseExample
from ..llm import get_llm
from ..readers import read_document
from ..splitter import TokenTextSplitter

logger = get_logger(__name__)

MAX_SEARCH_ROUNDS = 3

DECOMPOSE_PROMPT = """\
You are an assistant that decomposes a complex question into simpler \
sub-questions and picks one tool per step.

Tools:
- "Search": look up facts in the knowledge base.
- "Math": perform an arithmetic computation.
- "Done": you have enough information to answer.

Question: {question}

Findings so far:
{ledger}

Reply with ONLY a JSON object of the form
{{"Tool_Request": "<Search|Math|Done>", "Generated Sub Questions": ["..."]}}
JSON:"""

ANSWER_EXTRACT_PROMPT = """\
Context: {context}
Question: {question}
Answer the question in one short sentence using only the context. \
If the context has no answer, say "unknown".
Answer:"""

MATH_PROMPT = """\
Compute the result for: {question}
Reply with only the numeric result.
Result:"""

FINAL_PROMPT = """\
Original question: {question}

Facts gathered:
{ledger}

Using only these facts, write the final answer to the original question.
Final answer:"""


@dataclass
class Ledger:
    """Accumulated sub-question/answer state."""
    question_trace: list[str] = field(default_factory=list)
    answer_trace: list[str] = field(default_factory=list)
    done: bool = False
    search_calls: int = 0

    def render(self) -> str:
        if not self.question_trace:
            return "(none yet)"
        return "\n".join(f"- Q: {q}\n  A: {a}" for q, a in
                         zip(self.question_trace, self.answer_trace))


def parse_tool_request(text: str) -> tuple[str, list[str]]:
    """Extract the JSON tool request from LLM output (tolerant of the
    prose around it)."""
    match = re.search(r"\{.*\}", text, re.DOTALL)
    if not match:
        return "Done", []
    try:
        obj = json.loads(match.group(0))
    except json.JSONDecodeError:
        return "Done", []
    tool = str(obj.get("Tool_Request", "Done")).strip()
    subs = obj.get("Generated Sub Questions") or obj.get("sub_questions") or []
    if isinstance(subs, str):
        subs = [subs]
    return tool, [str(s) for s in subs if s]


class QueryDecompositionChatbot(BaseExample):
    def __init__(self, llm=None, embedder=None,
                 index: Optional[DocumentIndex] = None, config=None,
                 engine=None):
        self.config = config or get_config()
        self.llm = llm or get_llm(self.config, engine=engine)
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

    # ---------------------------------------------------------- ingestion

    def ingest_docs(self, data_dir: str, filename: str) -> None:
        text = read_document(data_dir)
        chunks = self.splitter.split_text(text)
        encoded = base64.b64encode(filename.encode()).decode()
        self.index.add_documents(
            [Document(text=c, metadata={"source": filename,
                                        "source_b64": encoded, "chunk": i})
             for i, c in enumerate(chunks)])

    # -------------------------------------------------------------- tools

    def search(self, sub_question: str) -> str:
        """Retrieval, then the answer extracted from its context."""
        docs = self.index.similarity_search(
            sub_question, k=self.config.retriever.top_k)
        context = "\n".join(d.text for d in docs)
        return self.llm.complete(
            ANSWER_EXTRACT_PROMPT.format(context=context,
                                         question=sub_question),
            max_tokens=64, stop=["\n\n"]).strip()

    def math(self, sub_question: str) -> str:
        """LLM arithmetic."""
        return self.llm.complete(MATH_PROMPT.format(question=sub_question),
                                 max_tokens=32, stop=["\n"]).strip()

    # -------------------------------------------------------------- agent

    def run_agent(self, question: str, max_steps: int = 6) -> Ledger:
        """The decompose-and-solve loop."""
        ledger = Ledger()
        for _ in range(max_steps):
            out = self.llm.complete(
                DECOMPOSE_PROMPT.format(question=question,
                                        ledger=ledger.render()),
                max_tokens=256, stop=["\n\n\n"])
            tool, subs = parse_tool_request(out)
            if tool.lower() == "search":
                # The recursion guard.
                if ledger.search_calls >= MAX_SEARCH_ROUNDS:
                    break
                ledger.search_calls += 1
                for sub in subs or [question]:
                    answer = self.search(sub)
                    ledger.question_trace.append(sub)
                    ledger.answer_trace.append(answer)
            elif tool.lower() == "math":
                for sub in subs or [question]:
                    answer = self.math(sub)
                    ledger.question_trace.append(sub)
                    ledger.answer_trace.append(answer)
            else:  # Done (or unparseable → stop decomposing)
                ledger.done = True
                break
        return ledger

    # -------------------------------------------------------------- chains

    def llm_chain(self, context: str, question: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        prompt = self.config.prompts.chat_template.format(
            context_str=context or "", query_str=question)
        yield from self.llm.stream(prompt, max_tokens=num_tokens,
                                   stop=["</s>", "[INST]"])

    def rag_chain(self, prompt: str, num_tokens: int,
                  ) -> Generator[str, None, None]:
        try:
            ledger = self.run_agent(prompt)
        except (RetrievalError, BreakerOpenError) as exc:
            # Retrieval-layer failure inside the agent loop: degrade to
            # a direct LLM answer with a notice instead of erroring the
            # whole request (LLM failures still propagate — there is
            # nothing to degrade TO without a model).
            yield from degrade_to_llm(self, exc, prompt, num_tokens)
            return
        # The final answer, streamed.
        yield from self.llm.stream(
            FINAL_PROMPT.format(question=prompt, ledger=ledger.render()),
            max_tokens=num_tokens, stop=["</s>"])

    def document_search(self, content: str, num_docs: int) -> list[dict]:
        docs = self.index.similarity_search(content, k=num_docs)
        return [{"score": d.score, "source": d.metadata.get("source", ""),
                 "content": d.text} for d in docs]


Example = QueryDecompositionChatbot
