"""LLM-as-judge Likert scoring of RAG answers.

Script form of the reference's human-like evaluation notebook
(reference: tools/evaluation/04_Human_Like_RAG_Evaluation-AIP.ipynb): a
few-shot judge prompt rates the assistant answer 1-5 against the
ground-truth context + answer, the ``Rating:``/``Explanation:`` fields are
regex-parsed with a retry loop, 0-ratings are clamped to 1, and the suite
reports the mean plus a 1-5 histogram (the notebook's matplotlib
histogram, as data).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

JUDGE_SYSTEM = (
    "You are an impartial judge evaluating the quality of an AI "
    "assistant's answer to a user question, given a reference context and "
    "a reference answer. Rate helpfulness, relevance, accuracy, and "
    "conciseness on a scale of 1 to 5. Respond in the exact format: "
    '"Rating": <1-5>, "Explanation": "<one sentence>".'
)

JUDGE_EXAMPLE = (
    "Example:\n"
    "[Question]\n"
    "What is the peak HBM bandwidth of the chip?\n"
    "[The Start of the Reference Context]\n"
    "The accelerator pairs a 128x128 systolic array with 16 GB of HBM "
    "delivering 819 GB/s of memory bandwidth.\n"
    "[The End of the Reference Context]\n"
    "[The Start of the Reference Answer]\n"
    "The chip's HBM provides 819 GB/s of peak bandwidth.\n"
    "[The End of the Reference Answer]\n"
    "[The Start of the Assistant's Answer]\n"
    "819 GB/s.\n"
    "[The End of the Assistant's Answer]\n"
    '"Rating": 5, "Explanation": "Accurate and concise; matches the '
    'reference answer exactly."\n'
)

JUDGE_PROMPT = (
    "{system}\n\n{example}\n"
    "Now evaluate the following.\n"
    "[Question]\n{question}\n"
    "[The Start of the Reference Context]\n{gt_context}\n"
    "[The End of the Reference Context]\n"
    "[The Start of the Reference Answer]\n{gt_answer}\n"
    "[The End of the Reference Answer]\n"
    "[The Start of the Assistant's Answer]\n{answer}\n"
    "[The End of the Assistant's Answer]\n"
)

_RATING = re.compile(r"Rating\"?\s*[:=]\s*\"?(\d+)", re.IGNORECASE)
_EXPLANATION = re.compile(r"Explanation\"?\s*[:=]\s*\"?(.+)", re.IGNORECASE)


def parse_rating(text: str) -> tuple[Optional[int], str]:
    m = _RATING.search(text)
    rating = int(m.group(1)) if m else None
    if rating is not None:
        # the notebook clamps stray 0s to 1; also clamp >5 hallucinations
        rating = min(5, max(1, rating))
    em = _EXPLANATION.search(text)
    explanation = em.group(1).strip().strip('"') if em else text.strip()
    return rating, explanation


def judge_answer(llm, question: str, gt_context: str, gt_answer: str,
                 answer: str, max_retries: int = 1,
                 ) -> tuple[Optional[int], str]:
    """Rate one answer 1-5; (None, raw_text) when no rating parsed after
    retries (reference notebook appends None and drops it from the mean)."""
    prompt = JUDGE_PROMPT.format(system=JUDGE_SYSTEM, example=JUDGE_EXAMPLE,
                                 question=question, gt_context=gt_context,
                                 gt_answer=gt_answer, answer=answer)
    explanation = ""
    for _ in range(1 + max_retries):
        text = llm.complete(prompt, max_tokens=200, temperature=0.1, top_k=4)
        rating, explanation = parse_rating(text)
        if rating is not None:
            return rating, explanation
    return None, explanation


def summarize_ratings(ratings: Sequence[Optional[int]]) -> dict:
    """Mean + histogram over parsed ratings (unparsed counted separately)."""
    parsed = [r for r in ratings if r is not None]
    hist = {str(i): sum(1 for r in parsed if r == i) for i in range(1, 6)}
    return {
        "mean_rating": (round(sum(parsed) / len(parsed), 2)
                        if parsed else None),
        "histogram": hist,
        "rated": len(parsed),
        "unparsed": len(ratings) - len(parsed),
    }
