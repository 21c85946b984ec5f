"""Bounded conversation memory (a copy of the reference package's
``assistant/memory.py``; reference: experimental/
multimodal_assistant/utils/memory.py — chat history folded into the
prompt so follow-up questions resolve pronouns against earlier turns)."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass


@dataclass
class Turn:
    question: str
    answer: str


class ConversationMemory:
    def __init__(self, max_turns: int = 6, max_chars: int = 2000):
        self._turns: deque[Turn] = deque(maxlen=max_turns)
        self.max_chars = max_chars

    def add(self, question: str, answer: str) -> None:
        self._turns.append(Turn(question, answer))

    def clear(self) -> None:
        self._turns.clear()

    def __len__(self) -> int:
        return len(self._turns)

    def render(self) -> str:
        """Newest-last history string, trimmed to the char budget by
        dropping oldest turns first."""
        lines = [f"User: {t.question}\nAssistant: {t.answer}"
                 for t in self._turns]
        while lines and sum(len(ln) + 1 for ln in lines) > self.max_chars:
            lines.pop(0)
        return "\n".join(lines)
