"""Speculative decoding, host half: prompt-lookup drafting and the
per-request draft-length controller (a copy of the reference package's
``engine/spec_decode.py``).

A decode step emits one token per slot. A verify round instead scores
``S = K + 1`` positions per slot in one forward (``models/llama.py``
``apply_verify_paged``): the slot's last token plus up to K draft tokens
proposed here, and keeps the longest prefix the model agrees with, plus
one correction or bonus token. Acceptance is exact: a greedy row keeps a
draft iff it is the row's argmax, a sampled row uses rejection sampling
(``ops/fused_sampler.py`` ``fused_verify_sample``), which keeps the output
distribution.

- :class:`PromptLookupDrafter`: proposes the continuation of the most
  recent earlier occurrence of the context's suffix n-gram (Saxena,
  "Prompt Lookup Decoding"). RAG answers copy spans of their retrieved
  context, so the prompt itself is the draft model.
- :class:`AdaptiveDraftController`: per-request K, grown after a round
  that accepted most of its drafts, halved after one that accepted few.
- :class:`SpecConfig`: the resolved knobs (env beats the ``EngineConfig``
  field beats the default).

The device half is the engine's verify round (``engine/engine.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

DEFAULT_MAX_DRAFT = 7      # K: draft tokens per slot per round (S = K+1)
DEFAULT_MIN_DRAFT = 1
DEFAULT_NGRAM_MAX = 3
DEFAULT_NGRAM_MIN = 1
DEFAULT_ADAPT_HIGH = 0.8   # acceptance >= high -> grow K
DEFAULT_ADAPT_LOW = 0.3    # acceptance < low  -> halve K


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    return float(raw) if raw else default


@dataclass(frozen=True)
class SpecConfig:
    """Resolved speculative-decoding knobs for one engine.
    ``max_draft_tokens`` fixes the verify round's shape (it scores
    ``max_draft_tokens + 1`` positions per slot); the per-request
    adaptive K moves inside [min_draft_tokens, max_draft_tokens]."""

    max_draft_tokens: int = DEFAULT_MAX_DRAFT
    min_draft_tokens: int = DEFAULT_MIN_DRAFT
    ngram_max: int = DEFAULT_NGRAM_MAX
    ngram_min: int = DEFAULT_NGRAM_MIN
    adapt: bool = True
    adapt_high: float = DEFAULT_ADAPT_HIGH
    adapt_low: float = DEFAULT_ADAPT_LOW

    @classmethod
    def resolve(cls, cfg_max_draft: Optional[int] = None) -> "SpecConfig":
        """``SPEC_*`` env beats the EngineConfig field beats the default."""
        env_max = os.environ.get("SPEC_MAX_DRAFT_TOKENS", "")
        max_draft = int(env_max) if env_max else (
            cfg_max_draft or DEFAULT_MAX_DRAFT)
        max_draft = max(1, max_draft)
        min_draft = max(1, min(
            _env_int("SPEC_MIN_DRAFT_TOKENS", DEFAULT_MIN_DRAFT),
            max_draft))
        ngram_max = max(1, _env_int("SPEC_NGRAM_MAX", DEFAULT_NGRAM_MAX))
        ngram_min = max(1, min(_env_int("SPEC_NGRAM_MIN",
                                        DEFAULT_NGRAM_MIN), ngram_max))
        return cls(
            max_draft_tokens=max_draft,
            min_draft_tokens=min_draft,
            ngram_max=ngram_max,
            ngram_min=ngram_min,
            adapt=os.environ.get("SPEC_ADAPT", "1") != "0",
            adapt_high=_env_float("SPEC_ADAPT_HIGH", DEFAULT_ADAPT_HIGH),
            adapt_low=_env_float("SPEC_ADAPT_LOW", DEFAULT_ADAPT_LOW))


def spec_enabled(cfg_flag: bool) -> bool:
    """``ENGINE_SPEC_DECODE`` env beats the ``EngineConfig.spec_decode``
    field: ``0`` forces the plain decode path, any other non-empty value
    forces speculation on, unset defers to the config."""
    env = os.environ.get("ENGINE_SPEC_DECODE", "")
    if env == "":
        return bool(cfg_flag)
    return env != "0"


class PromptLookupDrafter:
    """N-gram prompt-lookup drafting over one request's prompt and
    generated tokens.

    ``propose(k)`` finds the longest suffix n-gram (``ngram_max`` down to
    ``ngram_min``) of the context that also occurs earlier and proposes up
    to ``k`` tokens that followed that earlier occurrence. The index is
    incremental: each appended token registers the n-grams ending at it,
    so a proposal is a few dict lookups. Only the most recent earlier
    occurrence is kept (plus the one before it, so the suffix's own
    registration never shadows a real match)."""

    def __init__(self, context: Sequence[int] = (), *,
                 ngram_max: int = DEFAULT_NGRAM_MAX,
                 ngram_min: int = DEFAULT_NGRAM_MIN):
        self.ngram_max = max(1, ngram_max)
        self.ngram_min = max(1, min(ngram_min, self.ngram_max))
        self._ids: list[int] = []
        self._last: dict = {}   # (n, gram) -> latest start index
        self._prev: dict = {}   # (n, gram) -> start index before that
        if context:
            self.extend(context)

    def __len__(self) -> int:
        return len(self._ids)

    def extend(self, tokens: Iterable[int]) -> None:
        ids = self._ids
        for tok in tokens:
            ids.append(int(tok))
            L = len(ids)
            for n in range(self.ngram_min, self.ngram_max + 1):
                if L < n:
                    break
                key = (n, tuple(ids[L - n:]))
                old = self._last.get(key)
                if old is not None:
                    self._prev[key] = old
                self._last[key] = L - n

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens, or ``[]`` when no suffix n-gram has
        an earlier occurrence."""
        if k <= 0:
            return []
        ids = self._ids
        L = len(ids)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if L < n + 1:   # need at least one token after the match
                continue
            key = (n, tuple(ids[L - n:]))
            start = self._last.get(key)
            if start == L - n:      # that is the suffix itself
                start = self._prev.get(key)
            if start is None:
                continue
            cont = ids[start + n:start + n + k]
            if cont:
                return list(cont)
        return []


class AdaptiveDraftController:
    """Per-request draft length K: a round accepting at least ``high`` of
    its drafts grows K by one (up to ``max_draft_tokens``), one accepting
    under ``low`` halves it (down to ``min_draft_tokens``).
    ``adapt=False`` pins K at the maximum."""

    def __init__(self, spec: SpecConfig):
        self._spec = spec
        self.k = spec.max_draft_tokens

    def update(self, drafted: int, accepted: int) -> None:
        if drafted <= 0 or not self._spec.adapt:
            return
        rate = accepted / drafted
        if rate >= self._spec.adapt_high:
            self.k = min(self._spec.max_draft_tokens, self.k + 1)
        elif rate < self._spec.adapt_low:
            self.k = max(self._spec.min_draft_tokens, self.k // 2)
