"""End-to-end evaluation harness: ingest -> synthesize -> fill -> score.

Orchestrates the four stages over a ``BaseExample`` chain (in-process) the
way the reference chains its eval notebooks over the HTTP stack
(reference: tools/evaluation/02_filling_RAG_outputs_for_Evaluation.ipynb
posts each synthetic question to /generate and /documentSearch). Running
in-process keeps the harness usable in CI with the dev (echo LLM + hash
embedder) stack; the same functions accept any LLM client, so a
live-server run just swaps in OpenAICompatLLM.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .judge import judge_answer, summarize_ratings
from .metrics import (context_precision, faithfulness, mean_of,
                      retrieval_metrics)
from .synthesize import QAPair, generate_qa_pairs


@dataclass
class EvalConfig:
    top_k: int = 4                  # retrieval depth (ref default top-4)
    num_tokens: int = 150           # answer budget (ref: common/utils.py:92)
    pairs_per_chunk: int = 2
    max_questions: int = 16
    max_chunks: int = 8
    judge: bool = True
    ragas: bool = True
    output_path: Optional[str] = None
    extractive_fallback: bool = True


@dataclass
class EvalReport:
    questions: list[QAPair] = field(default_factory=list)
    metrics: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"metrics": self.metrics,
                "questions": [q.to_dict() for q in self.questions]}


def chunks_from_example(example, max_chunks: int) -> list[tuple[str, dict]]:
    """Pull synthesis chunks straight from the example's document index —
    each carries its store id, which becomes the retrieval gold label.
    Stride-sampled across the whole corpus: taking the first N chunks
    would draw every gold label from one or two (alphabetically first)
    documents and leave the rest of the corpus unmeasured."""
    index = getattr(example, "index", None)
    if index is None or max_chunks <= 0:
        return []
    docs = sorted(index._docs.items())
    if not docs:
        return []
    stride = max(1, len(docs) // max_chunks)
    chunks = []
    for doc_id, doc in docs[::stride]:
        chunks.append((doc.text, {"doc_id": doc_id,
                                  "source": doc.metadata.get("source", "")}))
        if len(chunks) >= max_chunks:
            break
    return chunks


def fill_rag_outputs(example, qa: QAPair, cfg: EvalConfig) -> None:
    """Stage 2: run the RAG chain for one question (answer + contexts).

    Retrieval ids come from the index's own similarity_search (store ids
    attached to each hit) rather than reverse-matching returned text —
    duplicate chunk texts would otherwise collapse onto one id and
    silently zero the nDCG of questions from the other copies."""
    qa.answer = "".join(example.rag_chain(qa.question, cfg.num_tokens))
    index = getattr(example, "index", None)
    if index is not None:
        hits = index.similarity_search(qa.question, k=cfg.top_k)
        qa.contexts = [h.text for h in hits]
        qa.context_ids = [h.id if h.id is not None else -1 for h in hits]
    else:
        qa.contexts = [h["content"] for h in
                       example.document_search(qa.question, cfg.top_k)]
        qa.context_ids = []


def run_eval(example, judge_llm, cfg: EvalConfig = EvalConfig(),
             qa_pairs: Optional[Sequence[QAPair]] = None) -> EvalReport:
    """Full pipeline. ``judge_llm`` powers synthesis, RAGAS verdicts, and
    the Likert judge (the reference uses Llama-70B for all three)."""
    t0 = time.monotonic()
    if qa_pairs is None:
        chunks = chunks_from_example(example, cfg.max_chunks)
        qa_pairs = generate_qa_pairs(
            judge_llm, chunks, pairs_per_chunk=cfg.pairs_per_chunk,
            extractive_fallback=cfg.extractive_fallback)
    qa_pairs = list(qa_pairs)[:cfg.max_questions]

    faith_scores: list[Optional[float]] = []
    precision_scores: list[Optional[float]] = []
    retrieval_scores: list[tuple[str, dict]] = []
    ratings: list[Optional[int]] = []

    for qa in qa_pairs:
        fill_rag_outputs(example, qa, cfg)
        r = retrieval_metrics(qa.context_ids, qa.gt_doc_id, cfg.top_k)
        if r is not None:
            retrieval_scores.append((qa.synthetic_mode, r))
        if cfg.ragas:
            faith_scores.append(faithfulness(
                judge_llm, qa.question, qa.answer, qa.contexts))
            precision_scores.append(context_precision(
                judge_llm, qa.question, qa.gt_answer, qa.contexts))
        if cfg.judge:
            rating, _ = judge_answer(judge_llm, qa.question, qa.gt_context,
                                     qa.gt_answer, qa.answer)
            ratings.append(rating)

    modes: dict[str, int] = {}
    for q in qa_pairs:
        modes[q.synthetic_mode] = modes.get(q.synthetic_mode, 0) + 1
    metrics: dict = {
        "num_questions": len(qa_pairs),
        "synthetic_modes": modes,
        "top_k": cfg.top_k,
    }
    if retrieval_scores:
        def agg(scores: list[dict]) -> dict:
            out = {key: round(sum(s[key] for s in scores) / len(scores), 4)
                   for key in ("ndcg", "hit", "mrr")}
            out["scored"] = len(scores)
            return out

        metrics["retrieval"] = agg([s for _, s in retrieval_scores])
        # per-mode split: quote-back questions are near-trivial for a
        # lexical retriever; the keyword/llm modes carry the signal
        metrics["retrieval"]["by_mode"] = {
            mode: agg([s for m, s in retrieval_scores if m == mode])
            for mode in sorted({m for m, _ in retrieval_scores})}
    if cfg.ragas:
        metrics["faithfulness"] = _round(mean_of(faith_scores))
        metrics["faithfulness_scored"] = sum(
            1 for v in faith_scores if v is not None)
        metrics["context_precision"] = _round(mean_of(precision_scores))
        metrics["context_precision_scored"] = sum(
            1 for v in precision_scores if v is not None)
    if cfg.judge:
        metrics["judge"] = summarize_ratings(ratings)
    metrics["eval_seconds"] = round(time.monotonic() - t0, 1)

    report = EvalReport(questions=qa_pairs, metrics=metrics)
    if cfg.output_path:
        os.makedirs(os.path.dirname(cfg.output_path) or ".", exist_ok=True)
        with open(cfg.output_path, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
    return report


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 4)
