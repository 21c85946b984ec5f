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

With online calibration on (``SCHED_ONLINE_CALIB``, default on) an
:class:`OnlineCalibrator` blends the construction-time model toward the
device time of completed pure rounds, and ``recalibrate`` re-derives the
budget between rounds. On the card the engine feeds it CUDA-event times
of the rounds' programs.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence


@dataclass(frozen=True)
class StepCostModel:
    """Per-deployment serving costs, in milliseconds.

    ``decode_step_ms`` is one decode step across all slots;
    ``prefill_ms_per_token`` is one prompt token through prefill. Their
    ratio is what the budget derivation consumes.
    ``verify_ms_per_token`` is one scored position of a speculative
    verify round; ``h2d_ms_per_page`` / ``d2h_ms_per_page`` move one KV
    page host->device (restore) and device->host (offload). 0 means
    unmeasured: a verify position is then priced as a prefill token and a
    restore is assumed to win."""

    decode_step_ms: float = 2.0
    prefill_ms_per_token: float = 0.125
    verify_ms_per_token: float = 0.0
    h2d_ms_per_page: float = 0.0
    d2h_ms_per_page: float = 0.0
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
                   verify_ms_per_token=float(
                       profile.get("verify_ms_per_token") or 0.0),
                   h2d_ms_per_page=float(
                       profile.get("h2d_ms_per_page") or 0.0),
                   d2h_ms_per_page=float(
                       profile.get("d2h_ms_per_page") or 0.0),
                   slots=slots, source=source)

    def prefill_s(self, tokens: int) -> float:
        """Modeled wall seconds to prefill ``tokens`` prompt tokens."""
        return max(0, tokens) * self.prefill_ms_per_token / 1e3

    def decode_round_ms(self, steps: int) -> float:
        return steps * self.decode_step_ms

    def verify_cost_tokens(self, positions: int) -> int:
        """A verify round's price against the token budget: ``positions``
        scored positions (slots x S) in prefill-token units through the
        measured per-token costs; 1:1 while verify is unmeasured."""
        if positions <= 0:
            return 0
        if self.verify_ms_per_token <= 0 or self.prefill_ms_per_token <= 0:
            return positions
        return max(1, math.ceil(
            positions * self.verify_ms_per_token
            / self.prefill_ms_per_token))

    def restore_ms(self, pages: int) -> float:
        """Modeled ms to restore ``pages`` KV pages host->device."""
        return max(0, pages) * self.h2d_ms_per_page

    def restore_cheaper(self, pages: int, page_size: int) -> bool:
        """The KV tier's admission decision: is restoring ``pages`` pages
        from host RAM cheaper than recomputing their tokens through
        prefill? Unmeasured H2D (0) answers True."""
        if pages <= 0:
            return False
        if self.h2d_ms_per_page <= 0:
            return True
        return self.restore_ms(pages) \
            < pages * page_size * self.prefill_ms_per_token

    def handoff_cheaper(self, pages: int, page_size: int) -> bool:
        """The disaggregation pricing rule: is shipping ``pages`` finished
        prefix pages donor device → host → wire → host → decode device
        cheaper than the decode replica recomputing their tokens? The
        handoff pays both transfer legs (``d2h`` on the donor, ``h2d`` on
        the receiver); unmeasured legs (0) answer True, as
        :meth:`restore_cheaper` does. Serialization and the wire are not
        priced."""
        if pages <= 0:
            return False
        per_page = self.d2h_ms_per_page + self.h2d_ms_per_page
        if per_page <= 0:
            return True
        return pages * per_page \
            < pages * page_size * self.prefill_ms_per_token


def online_calib_enabled(default: bool = True) -> bool:
    """``SCHED_ONLINE_CALIB``: ``0``/``false``/``no``/``off`` pins the
    construction-time model; any other value, and unset, calibrates."""
    raw = os.environ.get("SCHED_ONLINE_CALIB", "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "false", "no", "off")


class OnlineCalibrator:
    """EWMA calibration of a :class:`StepCostModel` from measured rounds
    (the reference's, unchanged).

    The engine feeds each completed pure round's device time (a decode
    round ``decode_step_ms``, a prefill-only round
    ``prefill_ms_per_token``, a verify-only round ``verify_ms_per_token``;
    mixed rounds cannot be split and are skipped) and the KV tier's page
    copies. :meth:`current` blends the prior toward the EWMA on a linear
    ramp (``weight = min(1, n / warmup)``). ``observe_*`` run on the
    harvest thread, ``current`` on the serve thread: a lock keeps each
    update atomic."""

    def __init__(self, prior: StepCostModel, *, alpha: float = 0.25,
                 warmup: int = 4):
        self.prior = prior
        self.alpha = float(alpha)
        self.warmup = max(1, int(warmup))
        self._lock = threading.Lock()
        self._ewma: dict[str, float] = {}
        self._n: dict[str, int] = {}
        self._cached: StepCostModel = prior
        self._dirty = False
        self.version = 0    # bumps per observation; recalibrate keys off it

    def _observe(self, key: str, value: float) -> None:
        if value <= 0 or not math.isfinite(value):
            return
        with self._lock:
            prev = self._ewma.get(key)
            self._ewma[key] = (value if prev is None
                               else prev + self.alpha * (value - prev))
            self._n[key] = self._n.get(key, 0) + 1
            self._dirty = True
            self.version += 1

    def observe_decode(self, steps: int, device_ms: float) -> None:
        """A pure decode round of ``steps`` steps took ``device_ms``."""
        if steps > 0:
            self._observe("decode_step_ms", device_ms / steps)

    def observe_prefill(self, tokens: int, device_ms: float) -> None:
        """A prefill-only round computed ``tokens`` prompt tokens."""
        if tokens > 0:
            self._observe("prefill_ms_per_token", device_ms / tokens)

    def observe_verify(self, positions: int, device_ms: float) -> None:
        """A verify-only round scored ``positions`` slot-positions."""
        if positions > 0:
            self._observe("verify_ms_per_token", device_ms / positions)

    def observe_h2d(self, pages: int, ms: float) -> None:
        """A restore copied ``pages`` pages host->device in ``ms``."""
        if pages > 0:
            self._observe("h2d_ms_per_page", ms / pages)

    def observe_d2h(self, pages: int, ms: float) -> None:
        """An offload copied ``pages`` pages device->host in ``ms``."""
        if pages > 0:
            self._observe("d2h_ms_per_page", ms / pages)

    def _blend(self, key: str, prior_value: float) -> float:
        ewma = self._ewma.get(key)
        if ewma is None:
            return prior_value
        w = min(1.0, self._n.get(key, 0) / self.warmup)
        return (1.0 - w) * prior_value + w * ewma

    def samples(self, key: str) -> int:
        with self._lock:
            return self._n.get(key, 0)

    def current(self) -> StepCostModel:
        """The blended model (rebuilt only after new observations); each
        field stays the prior's until it has evidence."""
        with self._lock:
            if not self._dirty:
                return self._cached
            p = self.prior
            self._cached = replace(
                p,
                decode_step_ms=self._blend("decode_step_ms",
                                           p.decode_step_ms),
                prefill_ms_per_token=self._blend(
                    "prefill_ms_per_token", p.prefill_ms_per_token),
                verify_ms_per_token=self._blend(
                    "verify_ms_per_token", p.verify_ms_per_token),
                h2d_ms_per_page=self._blend("h2d_ms_per_page",
                                            p.h2d_ms_per_page),
                d2h_ms_per_page=self._blend("d2h_ms_per_page",
                                            p.d2h_ms_per_page),
                source=p.source + "+online")
            self._dirty = False
            return self._cached


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
    # The decode work's price when it is not steps x slots: a verify
    # round scores S positions per slot in one step
    # (``StepCostModel.verify_cost_tokens``).
    decode_cost_override: Optional[int] = None

    @property
    def decode_cost_tokens(self) -> int:
        if not self.decode_steps:
            return 0
        if self.decode_cost_override is not None:
            return self.decode_cost_override
        return self.decode_steps * max(1, self.active_decodes)


class TokenBudgetScheduler:
    """Plans rounds under a token budget; orders admission by slack.

    One prefill token costs 1; one decode step costs one token per
    active slot (each armed slot emits a token per step)."""

    def __init__(self, cost: StepCostModel, *, page_size: int,
                 steps_per_round: int,
                 round_budget_tokens: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 max_one_shot_tokens: Optional[int] = None,
                 calibrator: Optional[OnlineCalibrator] = None):
        self._static_cost = cost
        # With a calibrator the scheduler plans with its blended model;
        # a pinned budget or chunk cap never moves.
        self.calibrator = calibrator
        self._budget_pinned = round_budget_tokens is not None
        self._chunk_pinned = chunk_tokens is not None
        self._calib_version = -1
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

    @property
    def cost(self) -> StepCostModel:
        """The model rounds are planned with: the calibrator's blended
        model when online calibration is on, else the static one."""
        if self.calibrator is not None:
            return self.calibrator.current()
        return self._static_cost

    def recalibrate(self) -> bool:
        """Re-derive the round budget (and an unpinned chunk cap, clamped
        to the largest one-shot bucket) from the current model, between
        rounds; a no-op without new evidence or with a pinned budget.
        True when the budget changed. A chunk of any length runs as the
        captured program of the smallest bucket holding it, so a new cap
        never needs a new program."""
        if self.calibrator is None or self._budget_pinned:
            return False
        version = self.calibrator.version
        if version == self._calib_version:
            return False
        self._calib_version = version
        budget = derive_round_budget(self.cost, self.steps_per_round,
                                     self.page_size)
        if budget == self.round_budget_tokens:
            return False
        self.round_budget_tokens = budget
        if not self._chunk_pinned:
            cap = budget
            if self.max_one_shot_tokens is not None:
                cap = min(cap, max(self.page_size, self.max_one_shot_tokens))
            self.chunk_tokens = cap
        return True

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
                   max_new: Optional[int] = None,
                   decode_cost_tokens: Optional[int] = None) -> RoundPlan:
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
        one-shot cannot re-open the prefill wall for the next arrival.
        ``decode_cost_tokens`` overrides the steps x slots decode price (a
        verify round)."""
        plan = RoundPlan(decode_steps=decode_steps,
                         active_decodes=active_decodes,
                         decode_cost_override=decode_cost_tokens)
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
