"""Token-budget continuous scheduler: chunked prefill interleaved with
decode — the port's copy of the reference's ``engine/scheduler.py``
(pure host policy, no device state).

Each engine round is planned as a mix of decode steps for the armed slots
plus prefill *chunks* for admitted requests, sized so the round stays
under a per-round token budget: decode keeps its cadence while a long
prompt makes page-quantized progress in the gaps (the Sarathi/Orca
recipe). Admission is ordered by deadline slack, arrival order breaking
ties.

The budget is the ``EngineConfig`` pin when set, else derived from a
:class:`StepCostModel`: the prefill tokens whose modeled cost equals one
decode round. The engine builds the model at construction: on the card
from replays of its captured programs (``Engine._measure_costs``),
elsewhere from the class defaults. Unlike the reference, this module
reads no profile file: the reference's ``PROFILE_r*.json`` artifacts are
TPU measurements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class StepCostModel:
    """Per-deployment serving costs, in milliseconds.

    ``decode_step_ms`` is one decode step across all slots;
    ``prefill_ms_per_token`` is one prompt token through prefill. Their
    ratio is what the budget derivation consumes."""

    decode_step_ms: float = 2.0
    prefill_ms_per_token: float = 0.125
    slots: int = 8
    source: str = "default"

    @classmethod
    def from_profile(cls, profile: dict,
                     source: str = "profile") -> "StepCostModel":
        """A model from a profile row (``full_ms_per_step``, ``slots``,
        ``prefill_ms_per_token``). A row without a prefill measurement
        estimates it from the decode step: the per-slot decode cost,
        discounted 4x for prefill's batching."""
        decode = float(profile.get("full_ms_per_step") or 2.0)
        slots = int(profile.get("slots") or 8)
        prefill = profile.get("prefill_ms_per_token")
        if not prefill or prefill <= 0:
            prefill = decode / max(1, slots) / 4.0
        return cls(decode_step_ms=decode, prefill_ms_per_token=float(prefill),
                   slots=slots, source=source)

    def prefill_s(self, tokens: int) -> float:
        """Modeled wall seconds to prefill ``tokens`` prompt tokens."""
        return max(0, tokens) * self.prefill_ms_per_token / 1e3

    def decode_round_ms(self, steps: int) -> float:
        return steps * self.decode_step_ms


def derive_round_budget(model: StepCostModel, steps_per_round: int,
                        page_size: int) -> int:
    """Default per-round prefill-token budget: the tokens whose modeled
    prefill cost equals one full decode round, so a round that carries a
    chunk takes at most ~2x a decode round. Whole pages, at least one."""
    tokens = model.decode_round_ms(steps_per_round) / model.prefill_ms_per_token
    pages = max(1, int(tokens) // page_size)
    return pages * page_size


@dataclass
class PrefillJob:
    """One prefill the scheduler may advance this round. ``key`` is the
    engine's request, echoed back in the plan; ``remaining`` counts tokens
    still to compute (a prefix-cache hit shrinks it)."""

    key: object
    remaining: int
    deadline_t: Optional[float] = None
    seq: int = 0
    started: bool = False    # already holds a slot (in-flight chunks)


@dataclass
class RoundPlan:
    """One engine round: the decode dispatch (steps and how many armed
    slots ride it) plus the prefill chunks that fit under the budget."""

    decode_steps: int
    active_decodes: int
    chunks: list = field(default_factory=list)  # [(key, grant_tokens)]

    @property
    def decode_cost_tokens(self) -> int:
        if not self.decode_steps:
            return 0
        return self.decode_steps * max(1, self.active_decodes)


class TokenBudgetScheduler:
    """Plans rounds under a token budget; orders admission by slack.

    One prefill token costs 1; one decode step costs one token per
    active slot (each armed slot emits a token per step)."""

    def __init__(self, cost: StepCostModel, *, page_size: int,
                 steps_per_round: int,
                 round_budget_tokens: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 max_one_shot_tokens: Optional[int] = None):
        self.cost = cost
        self.page_size = page_size
        self.steps_per_round = steps_per_round
        if round_budget_tokens is not None:
            budget = max(page_size, int(round_budget_tokens))
        else:
            budget = derive_round_budget(cost, steps_per_round, page_size)
        self.round_budget_tokens = budget
        # Per-chunk cap: one request's grant within one round; defaults
        # to the whole budget.
        self.chunk_tokens = max(page_size, int(chunk_tokens)) \
            if chunk_tokens else budget
        # Above this a request is never one-shot (the engine passes its
        # largest prefill bucket, also its largest single dispatch).
        self.max_one_shot_tokens = max_one_shot_tokens
        if max_one_shot_tokens is not None:
            self.chunk_tokens = min(self.chunk_tokens,
                                    max(page_size, max_one_shot_tokens))
        # Fair-rotation cursor: when the leftover cannot give every job a
        # page, who gets this round's page rotates across rounds.
        self._rr = 0

    def slack_s(self, job: PrefillJob, now: float) -> float:
        """Seconds to spare if this job's prefill started now; +inf
        without a deadline."""
        if job.deadline_t is None:
            return math.inf
        return (job.deadline_t - now) - self.cost.prefill_s(job.remaining)

    def order(self, jobs: Sequence[PrefillJob], now: float
              ) -> list[PrefillJob]:
        """Admission order: smallest slack first, then arrival."""
        return sorted(jobs, key=lambda j: (self.slack_s(j, now), j.seq))

    def plan_round(self, *, decode_steps: int, active_decodes: int,
                   inflight: Sequence[PrefillJob] = (),
                   backlog: Sequence[PrefillJob] = (),
                   now: float = 0.0,
                   max_new: Optional[int] = None) -> RoundPlan:
        """Pack one round: decode first (never displaced), then prefill
        chunks into the leftover budget.

        ``inflight`` jobs (mid-prefill, holding a slot) come before new
        admissions; ``backlog`` jobs are slack-ordered and at most
        ``max_new`` of them (the engine's free slots) are considered.
        Grants are whole pages except a job's final grant. If prefill
        work exists at least one page is granted even when decode took
        the whole budget; on an idle engine a lone job up to 2x the
        budget (and never past ``max_one_shot_tokens``) is granted whole,
        so a typical prompt pays no extra dispatches while an unbounded
        one-shot cannot re-open the prefill wall for the next arrival."""
        plan = RoundPlan(decode_steps=decode_steps,
                         active_decodes=active_decodes)
        admitted = self.order(backlog, now)
        if max_new is not None:
            admitted = admitted[:max(0, max_new)]
        jobs = list(inflight) + admitted
        if not jobs:
            return plan
        page = self.page_size
        leftover = self.round_budget_tokens - plan.decode_cost_tokens
        leftover = max(leftover, page)    # decode never starves prefill
        one_shot_cap = 2 * self.round_budget_tokens
        if self.max_one_shot_tokens is not None:
            one_shot_cap = min(one_shot_cap, self.max_one_shot_tokens)
        if (decode_steps == 0 and active_decodes == 0 and len(jobs) == 1
                and not jobs[0].started
                and jobs[0].remaining <= one_shot_cap):
            plan.chunks.append((jobs[0].key, jobs[0].remaining))
            return plan
        # Two-phase packing: every job first gets a fair share of the
        # leftover (page-quantized, one page at least), so a short prompt
        # behind a long in-flight prefill admits this round; then what the
        # fair pass left goes to the highest-priority jobs.
        share = max(page, (leftover // len(jobs)) // page * page)
        # Scarcity rotation: when the leftover cannot give every job a
        # page, who packs first rotates across rounds.
        order_idx = list(range(len(jobs)))
        if leftover < page * len(jobs):
            start = self._rr % len(jobs)
            order_idx = order_idx[start:] + order_idx[:start]
        self._rr += 1
        granted: dict[int, int] = {}      # job index -> raw tokens
        for phase_cap in (share, None):
            for i in order_idx:
                job = jobs[i]
                if leftover <= 0:
                    break
                cap = leftover if phase_cap is None else phase_cap
                grant = min(job.remaining - granted.get(i, 0),
                            self.chunk_tokens - granted.get(i, 0),
                            cap, leftover)
                if grant < job.remaining - granted.get(i, 0):
                    grant = (grant // page) * page
                if grant <= 0:
                    continue
                granted[i] = granted.get(i, 0) + grant
                leftover -= grant
        for i, job in enumerate(jobs):
            total = granted.get(i, 0)
            if total <= 0:
                continue
            if total < job.remaining:
                # A non-final grant is whole pages, so every later chunk
                # starts page-aligned.
                total = (total // page) * page
                if total <= 0:
                    continue
            plan.chunks.append((job.key, total))
        return plan
