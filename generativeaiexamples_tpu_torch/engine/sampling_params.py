"""Per-request sampling parameters (a copy of the reference package's
``engine/sampling_params.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SamplingParams:
    max_tokens: int = 100
    temperature: float = 1.0
    top_k: int = 1
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    # length_penalty reweights beam-search hypotheses; with beam_width
    # fixed to 1 only the neutral 1.0 is honest to accept.
    length_penalty: float = 1.0
    beam_width: int = 1               # only 1 supported
    random_seed: int = 0
    stop_words: list[str] = field(default_factory=list)
    # Words banned from being generated: single-token spellings go on a
    # vocab mask, multi-token spellings become device-side sequence bans.
    bad_words: list[str] = field(default_factory=list)
    ignore_eos: bool = False          # benchmarking aid

    def __post_init__(self) -> None:
        if self.beam_width != 1:
            raise ValueError(
                "beam_width != 1 is not supported: beam search is a "
                "declared non-goal of this stack")
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.length_penalty != 1.0:
            raise ValueError(
                "length_penalty requires beam search (beam_width > 1), "
                "which is not supported; use 1.0")
