"""Token-aware text splitting and context budgeting (a copy of the
reference package's ``chains/splitter.py``).

Parity with the reference's chunking — 510 tokens per chunk with 200
overlap on the embedder's tokenizer
(reference: common/utils.py:315-321 ``SentenceTransformersTokenTextSplitter``,
common/configuration.py:83-92) — and with its retrieved-context token cap
(reference: common/utils.py:96-118 ``LimitRetrievedNodesLength`` caps
stuffed context at 1500 tokens).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

from ..models.tokenizer import ByteTokenizer, Tokenizer

_SENTENCE_RE = re.compile(r"(?<=[.!?;\n])\s+")


class TokenTextSplitter:
    """Sentence-respecting token-window splitter.

    Sentences are packed greedily into windows of ``chunk_size`` tokens;
    consecutive chunks share ``chunk_overlap`` tokens of trailing context.
    A sentence longer than ``chunk_size`` is hard-split on token boundaries.
    """

    def __init__(self, tokenizer: Optional[Tokenizer] = None,
                 chunk_size: int = 510, chunk_overlap: int = 200):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.tok = tokenizer or ByteTokenizer()
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap

    def _count(self, text: str) -> int:
        return len(self.tok.encode(text, add_bos=False))

    def split_text(self, text: str) -> list[str]:
        text = text.strip()
        if not text:
            return []
        if self._count(text) <= self.chunk_size:
            return [text]

        # Sentence units, hard-splitting any oversized sentence.
        units: list[tuple[str, int]] = []
        for sent in _SENTENCE_RE.split(text):
            if not sent.strip():
                continue
            n = self._count(sent)
            if n <= self.chunk_size:
                units.append((sent, n))
            else:
                ids = self.tok.encode(sent, add_bos=False)
                for s in range(0, len(ids), self.chunk_size):
                    piece = self.tok.decode(ids[s:s + self.chunk_size])
                    units.append((piece, min(self.chunk_size, len(ids) - s)))

        chunks: list[str] = []
        cur: list[tuple[str, int]] = []
        cur_tokens = 0
        for sent, n in units:
            # +1 per join separator so the reassembled chunk stays in budget
            if cur and cur_tokens + n + 1 > self.chunk_size:
                chunks.append(" ".join(s for s, _ in cur))
                # Retain trailing sentences as overlap for continuity.
                keep: list[tuple[str, int]] = []
                kept = 0
                for us, un in reversed(cur):
                    if kept + un + 1 > self.chunk_overlap:
                        break
                    keep.insert(0, (us, un))
                    kept += un + 1
                cur, cur_tokens = keep, kept
            cur.append((sent, n))
            cur_tokens += n + (1 if len(cur) > 1 else 0)
        if cur:
            chunks.append(" ".join(s for s, _ in cur))
        return chunks


def cap_context(texts: Sequence[str], max_tokens: int = 1500,
                tokenizer: Optional[Tokenizer] = None) -> list[str]:
    """Keep the leading documents that fit in the token budget.

    Parity with ``LimitRetrievedNodesLength._postprocess_nodes``
    (reference: common/utils.py:96-118): iterate retrieved docs in rank
    order, stop once the running token total would exceed the cap.
    """
    tok = tokenizer or ByteTokenizer()
    out: list[str] = []
    total = 0
    for text in texts:
        n = len(tok.encode(text, add_bos=False))
        if total + n > max_tokens:
            break
        out.append(text)
        total += n
    return out
