"""RAGAS-style LLM-graded metrics + deterministic retrieval metrics.

LLM-graded (reference: tools/evaluation/03_eval_ragas.ipynb wires RAGAS
``faithfulness`` and ``context_precision`` to a Llama-70B judge):

- **faithfulness**: decompose the answer into atomic statements, ask the
  verdict LLM whether each can be inferred from the retrieved contexts;
  score = supported / total.
- **context precision**: ask, per retrieved context, whether it was useful
  for arriving at the ground-truth answer; score = rank-weighted mean of
  precision@k at each relevant position (the RAGAS formulation).

Deterministic (BASELINE.md north star "retrieval nDCG parity"): binary-
relevance nDCG@k, hit-rate@k, and MRR of the gold chunk's rank — these
need no judge, so they are meaningful even on the dev (echo/hash) stack.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Sequence

STATEMENT_PROMPT = (
    "Question: {question}\n"
    "Answer: {answer}\n\n"
    "Break the answer above into simple, self-contained factual "
    "statements, one per line. Output only the statements."
)

FAITHFULNESS_VERDICT_PROMPT = (
    "Context:\n{context}\n\n"
    "Statement: {statement}\n\n"
    "Can the statement be directly inferred from the context above? "
    "Answer with a single word: Yes or No."
)

CONTEXT_PRECISION_PROMPT = (
    "Question: {question}\n"
    "Reference answer: {answer}\n\n"
    "Candidate context:\n{context}\n\n"
    "Was the candidate context useful in arriving at the reference "
    "answer? Answer with a single word: Yes or No."
)

_YES = re.compile(r"\b(yes|true)\b", re.IGNORECASE)
_NO = re.compile(r"\b(no|false)\b", re.IGNORECASE)


def parse_verdict(text: str) -> Optional[bool]:
    """First clear yes/no wins; None when the output has neither (the
    caller counts it as unparsed rather than guessing)."""
    yes = _YES.search(text)
    no = _NO.search(text)
    if yes and (not no or yes.start() < no.start()):
        return True
    if no:
        return False
    return None


def extract_statements(llm, question: str, answer: str,
                       max_statements: int = 8) -> list[str]:
    text = llm.complete(STATEMENT_PROMPT.format(question=question,
                                                answer=answer),
                        max_tokens=300, temperature=0.2, top_k=4)
    lines = [re.sub(r"^[\s\-\*\d\.\)]+", "", ln).strip()
             for ln in text.splitlines()]
    stmts = [ln for ln in lines if len(ln.split()) >= 3]
    return stmts[:max_statements] or [answer]


def faithfulness(llm, question: str, answer: str,
                 contexts: Sequence[str]) -> Optional[float]:
    """Fraction of answer statements supported by the contexts; None when
    no verdict parsed (dev-stack LLM doubles answer neither yes nor no)."""
    if not answer.strip() or not contexts:
        return None
    context = "\n\n".join(contexts)
    verdicts = []
    for stmt in extract_statements(llm, question, answer):
        v = parse_verdict(llm.complete(
            FAITHFULNESS_VERDICT_PROMPT.format(context=context,
                                               statement=stmt),
            max_tokens=10, temperature=0.0, top_k=1))
        if v is not None:
            verdicts.append(v)
    if not verdicts:
        return None
    return sum(verdicts) / len(verdicts)


def context_precision(llm, question: str, gt_answer: str,
                      contexts: Sequence[str]) -> Optional[float]:
    """RAGAS context precision: mean over relevant positions k of
    precision@k — rewards putting the useful contexts first."""
    if not contexts:
        return None
    # Unparsed verdicts are dropped (their rank positions excluded), same
    # policy as faithfulness — counting them as "irrelevant" would let
    # parser flakiness systematically deflate the score.
    rels: list[bool] = []
    for ctx in contexts:
        v = parse_verdict(llm.complete(
            CONTEXT_PRECISION_PROMPT.format(question=question,
                                            answer=gt_answer, context=ctx),
            max_tokens=10, temperature=0.0, top_k=1))
        if v is not None:
            rels.append(v)
    if not rels:
        return None
    if not any(rels):
        return 0.0
    score = 0.0
    hits = 0
    for k, rel in enumerate(rels, start=1):
        if rel:
            hits += 1
            score += hits / k
    return score / hits


# ------------------------------------------------------------- retrieval

def ndcg_at_k(ranked_ids: Sequence[int], gold_id: int, k: int) -> float:
    """Binary-relevance nDCG@k: one relevant item (the gold chunk), so
    ideal DCG is 1 and nDCG = 1/log2(rank+1) if found in the top k."""
    for rank, rid in enumerate(list(ranked_ids)[:k], start=1):
        if rid == gold_id:
            return 1.0 / math.log2(rank + 1)
    return 0.0


def retrieval_metrics(ranked_ids: Sequence[int], gold_id: Optional[int],
                      k: int) -> Optional[dict[str, float]]:
    """Per-question retrieval scores vs the chunk the question was
    synthesized from. None when the gold id is unknown."""
    if gold_id is None:
        return None
    ranked = list(ranked_ids)
    hit = gold_id in ranked[:k]
    rr = 0.0
    for rank, rid in enumerate(ranked, start=1):
        if rid == gold_id:
            rr = 1.0 / rank
            break
    return {"ndcg": ndcg_at_k(ranked, gold_id, k),
            "hit": 1.0 if hit else 0.0,
            "mrr": rr}


def mean_of(values: Sequence[Optional[float]]) -> Optional[float]:
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    return sum(vals) / len(vals)
