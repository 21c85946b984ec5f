"""Synthetic QA-pair generation from knowledge-base chunks.

Script form of the reference's synthetic-data notebook
(reference: tools/evaluation/01_synthetic_data_generation.ipynb: chunk the
corpus, prompt a strong LLM for "two very good question answer pairs ...
in a json format", collect {question, answer} records alongside the source
chunk as ground-truth context). The JSON parser here is deliberately
lenient — models wrap JSON in prose and code fences — and a deterministic
extractive fallback keeps the pipeline runnable on the dev (echo) stack,
where the LLM double produces no JSON at all.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence

QA_GENERATION_PROMPT = (
    "{chunk}\n\n"
    "Given the previous paragraph, create {n} very good question answer "
    "pairs. Your output should be in a json format of individual question "
    "answer pairs, like [{{\"question\": \"...\", \"answer\": \"...\"}}]. "
    "Restrict the question to the context information provided."
)


@dataclass
class QAPair:
    """One evaluation record. ``gt_*`` = ground truth from synthesis;
    ``answer``/``contexts`` are filled by the RAG pipeline (stage 2)."""
    question: str
    gt_answer: str
    gt_context: str
    gt_doc_id: Optional[int] = None        # index id of the source chunk
    source: str = ""                       # filename of the source chunk
    synthetic_mode: str = "llm"            # "llm" | "extractive"
    answer: str = ""
    contexts: list[str] = field(default_factory=list)
    context_ids: list[int] = field(default_factory=list)

    def to_dict(self) -> dict:
        return asdict(self)


_JSON_OBJ = re.compile(r"\{[^{}]*\}", re.DOTALL)
_FENCE = re.compile(r"```(?:json)?\s*(.*?)```", re.DOTALL)


def extract_qa_json(text: str) -> list[tuple[str, str]]:
    """Pull (question, answer) pairs out of arbitrary LLM output.

    Accepts a bare JSON list/object, fenced blocks, or loose ``{...}``
    objects embedded in prose; keys are matched case-insensitively and
    ``question``/``answer`` prefixed keys (question1, Answer_2) count."""
    candidates: list[str] = []
    for m in _FENCE.finditer(text):
        candidates.append(m.group(1))
    candidates.append(text)
    for chunk in candidates:
        pairs = _pairs_from_blob(chunk)
        if pairs:
            return pairs
    pairs = []
    for m in _JSON_OBJ.finditer(text):
        try:
            obj = json.loads(m.group(0))
        except (json.JSONDecodeError, ValueError):
            continue
        pairs.extend(_pairs_from_value(obj))
    return pairs


def _pairs_from_blob(blob: str) -> list[tuple[str, str]]:
    try:
        return _pairs_from_value(json.loads(blob))
    except (json.JSONDecodeError, ValueError):
        return []


def _pairs_from_value(value) -> list[tuple[str, str]]:
    if isinstance(value, list):
        out = []
        for item in value:
            out.extend(_pairs_from_value(item))
        return out
    if not isinstance(value, dict):
        return []
    qs: dict[str, str] = {}
    ans: dict[str, str] = {}
    for key, val in value.items():
        if not isinstance(val, (str, int, float)):
            # nested {"pair1": {"question": ..}} shapes
            nested = _pairs_from_value(val)
            if nested:
                return nested
            continue
        k = key.lower().strip()
        if k in ("q", "query"):
            qs[""] = str(val)
        elif k.startswith("question"):
            qs[k[len("question"):].strip(" _-")] = str(val)
        elif k in ("a", "response"):
            ans[""] = str(val)
        elif k.startswith("answer"):
            ans[k[len("answer"):].strip(" _-")] = str(val)
    return [(qs[s], ans[s]) for s in qs
            if s in ans and _plausible(qs[s]) and _plausible(ans[s], 1)]


def _plausible(text: str, min_words: int = 3) -> bool:
    """Reject placeholder/degenerate values (e.g. the literal "..." from a
    format example echoed back by a model — or by the echo test double)."""
    stripped = text.strip(" .?!…")
    return bool(stripped) and len(text.split()) >= min_words


def _first_sentence(text: str, max_chars: int = 200) -> str:
    text = " ".join(text.split())
    for sep in (". ", "? ", "! "):
        idx = text.find(sep)
        if 0 < idx < max_chars:
            return text[:idx + 1]
    return text[:max_chars]


def extractive_pair(chunk: str) -> tuple[str, str]:
    """Deterministic fallback: a quote-back question whose terms come from
    the chunk itself, so retrieval quality is still measurable on the dev
    stack (hash n-gram embedder) where the echo LLM emits no JSON."""
    lead = _first_sentence(chunk)
    return (f"According to the documentation, is it true that {lead}",
            lead)


_STOPWORDS = frozenset(
    "a an the and or but of to in on for with is are was were be been it "
    "its this that these those as at by from so no not into over under "
    "such can may will would should could does do did done their there "
    "they them then than when where which while what who whose how all "
    "any each more most some only also very just both about between "
    "after before during against through".split())


def keyword_pair(chunk: str) -> Optional[tuple[str, str]]:
    """Harder deterministic fallback: ask about the chunk's distinctive
    terms WITHOUT quoting any sentence. The quote-back question is
    near-trivial for a lexical retriever (its text IS the chunk's first
    sentence), so on its own it saturates hit/nDCG at 1.0; this variant
    gives the ranker only a handful of content words to work from,
    keeping the retrieval metrics informative."""
    words = re.findall(r"[A-Za-z][A-Za-z0-9_\-]{3,}", chunk)
    seen: list[str] = []
    lower_seen: set[str] = set()
    for w in words:
        lw = w.lower()
        if lw in _STOPWORDS or lw in lower_seen:
            continue
        lower_seen.add(lw)
        seen.append(w)
    # distinctive ~= longest; stable position tie-break keeps it
    # deterministic, then restore document order for a natural question
    ranked = sorted(range(len(seen)), key=lambda i: (-len(seen[i]), i))
    picks = [seen[i] for i in sorted(ranked[:3])]
    if len(picks) < 2:
        return None
    q = ("What does the documentation say about "
         + ", ".join(picks[:-1]) + " and " + picks[-1] + "?")
    return q, _first_sentence(chunk)


def generate_qa_pairs(llm, chunks: Sequence[tuple[str, dict]],
                      pairs_per_chunk: int = 2, max_retries: int = 1,
                      max_tokens: int = 300,
                      extractive_fallback: bool = True) -> list[QAPair]:
    """Synthesize QA pairs for each (chunk_text, metadata) pair.

    metadata may carry ``source`` and ``doc_id`` for retrieval scoring.
    Temperature mirrors the reference notebook's judge-grade settings
    (temperature 0.2, max 300 tokens)."""
    out: list[QAPair] = []
    for chunk, meta in chunks:
        pairs: list[tuple[str, str]] = []
        for _ in range(1 + max_retries):
            text = llm.complete(
                QA_GENERATION_PROMPT.format(chunk=chunk, n=pairs_per_chunk),
                max_tokens=max_tokens, temperature=0.2, top_k=4)
            pairs = extract_qa_json(text)
            if pairs:
                break
        records = [(q, a, "llm") for q, a in pairs]
        if not records and extractive_fallback:
            # deterministic ladder: a keyword question first (retrieval
            # actually has to rank), then the near-trivial quote-back
            kw = keyword_pair(chunk)
            if kw is not None:
                records.append((*kw, "keyword"))
            records.append((*extractive_pair(chunk), "extractive"))
        for q, a, mode in records[:pairs_per_chunk]:
            out.append(QAPair(
                question=q, gt_answer=a, gt_context=chunk,
                gt_doc_id=meta.get("doc_id"), source=meta.get("source", ""),
                synthetic_mode=mode))
    return out
