"""Feedback capture (a copy of the reference package's
``assistant/feedback.py``; reference: experimental/multimodal_assistant/utils/
feedback.py — per-response user feedback persisted for later tuning).
JSONL on disk; append-only."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class FeedbackStore:
    def __init__(self, path: str = "./feedback.jsonl"):
        self.path = path

    def record(self, question: str, answer: str, rating: int,
               comment: str = "", sources: Optional[list[str]] = None,
               ) -> dict:
        entry = {"ts": time.time(), "question": question, "answer": answer,
                 "rating": int(rating), "comment": comment,
                 "sources": sources or []}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        return entry

    def load(self) -> list[dict]:
        if not os.path.isfile(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
