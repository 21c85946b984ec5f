"""Incremental streaming detokenizer and stop-word trap (a copy of the
reference package's ``engine/detokenizer.py``).

Decodes a sliding window of recent ids and emits the stable prefix diff,
holding back trailing bytes that are still an incomplete UTF-8 fragment,
so per-token work stays bounded.
"""

from __future__ import annotations

from ..models.tokenizer import Tokenizer


class IncrementalDetokenizer:
    """Feed token ids one at a time; get back printable text chunks."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._prefix = 0        # ids before this index are fully emitted
        self._read = 0          # ids in [prefix:read] produced emitted text
        self._text = ""         # everything emitted so far

    def prime(self, ids: list[int]) -> None:
        """Seed context that was already emitted (a mid-stream resume):
        the replayed ids count as emitted, so ``push`` decodes new tokens
        against their tail (sentencepiece spaces stay right across the
        boundary) while ``text`` and later chunks carry only new text."""
        self._ids = [int(i) for i in ids]
        self._read = len(self._ids)
        self._prefix = max(0, self._read - 8)

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        window = self._ids[self._prefix:]
        emitted = self._tok.decode(self._ids[self._prefix:self._read])
        full = self._tok.decode(window)
        # A trailing replacement char usually means the last token ends
        # mid-UTF-8-sequence and the next token completes it: hold back.
        if full.endswith("�") or len(full) <= len(emitted):
            return ""
        chunk = full[len(emitted):]
        self._text += chunk
        self._prefix = self._read
        self._read = len(self._ids)
        return chunk

    def flush(self) -> str:
        emitted = self._tok.decode(self._ids[self._prefix:self._read])
        full = self._tok.decode(self._ids[self._prefix:])
        chunk = full[len(emitted):]
        self._text += chunk
        self._prefix = self._read = len(self._ids)
        return chunk

    @property
    def text(self) -> str:
        emitted = self._tok.decode(self._ids[self._prefix:self._read])
        full = self._tok.decode(self._ids[self._prefix:])
        return self._text + full[len(emitted):]


class StopWordTrap:
    """Stop-word scanning over the accumulated stream: returns the
    emittable part of each chunk while withholding text that could be the
    start of a stop word. Truncates at the EARLIEST stop occurrence across
    all stop words; once tripped, every later feed/flush returns ""."""

    def __init__(self, stop_words: list[str]):
        self._stops = [s for s in stop_words if s]
        self._buf = ""
        self.stopped = False

    def feed(self, chunk: str) -> str:
        if self.stopped:
            return ""
        self._buf += chunk
        idx = min((i for i in (self._buf.find(s) for s in self._stops)
                   if i >= 0), default=-1)
        if idx >= 0:
            self.stopped = True
            out, self._buf = self._buf[:idx], ""
            return out
        # Withhold the longest suffix that is a prefix of any stop word.
        hold = 0
        for stop in self._stops:
            for n in range(min(len(stop) - 1, len(self._buf)), 0, -1):
                if self._buf.endswith(stop[:n]):
                    hold = max(hold, n)
                    break
        if hold:
            out, self._buf = self._buf[:-hold], self._buf[-hold:]
        else:
            out, self._buf = self._buf, ""
        return out

    def flush(self) -> str:
        out, self._buf = self._buf, ""
        return "" if self.stopped else out
