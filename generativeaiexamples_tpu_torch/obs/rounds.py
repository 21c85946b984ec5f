"""Engine-level round telemetry: what did the ENGINE do each round? — a
copy of the reference package's ``obs/rounds.py`` (metric names and
record fields unchanged).

The flight recorder (``obs/flight.py``) answers "where did THIS
request's time go"; this module answers the question that remained
unobservable: *what did the engine do in each scheduler round, and did
it match the plan?* The token-budget scheduler (engine/scheduler.py)
makes per-round promises — decode never displaced, chunks sized to the
budget, verify rounds priced through the step-cost model — and those
are exactly per-round properties: without a per-round record they can
neither be audited in production nor used to calibrate the cost model
on real chips.

Every executed round gets a :class:`RoundRecord` in a bounded ring,
built under the same discipline as the flight ring:

- the **scheduler thread** appends the *plan* (``begin``: budget
  tokens, decode steps/slots, spec decisions) and *seals* the dispatch
  half (``seal``: prefill grants per job, host dispatch wall, modeled
  cost, estimated HBM traffic);
- the **harvest thread** completes the *execution* (``complete_part``:
  readback waits, tokens emitted, spec acceptances) — the record
  finalizes when its last outstanding device output has been harvested,
  which is when per-round device time can honestly be measured.

Appends never contend with the engine's token path: ``begin``/``seal``
run once per round on the scheduler thread, completion once per
harvested item on the harvest thread, and the recorder's lock guards
only the ring and the pipelined-completion clock — O(1) work per round,
nothing per token.

Exposure, three ways:

- ``GET /debug/rounds`` on the chain server and the model server: the
  last-N records plus rolling aggregates (``snapshot``);
- ``engine_round_*`` / ``sched_cost_drift_ratio`` metrics on
  ``/metrics``, declared in :data:`ROUND_METRICS`;
- a retrospective OTel span per round (``emit_round_span``) when
  tracing is on — explicit timestamps, no SDK work on the serve loop.

Timing semantics (what the fields mean):

- ``dispatch_ms`` — host wall spent inside this round's device
  dispatches (compile + enqueue; the scheduler-thread cost).
- ``round_ms`` — plan start to last harvested output: the round's
  end-to-end wall, including host dispatch. This is what the drift
  gauge and the slow-round dump judge, so a host-side stall (a fault
  injection, a GC pause, a compile) is visible, not just device time.
- ``device_ms`` — the pipelined service-time estimate: completion time
  minus the later of (this round's dispatch end, the PREVIOUS round's
  completion). Under dispatch-ahead the raw dispatch→harvest latency
  double-counts queue wait; this estimator converges on the true
  per-round device time and is what the online cost calibrator feeds
  on.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from ..utils.logging import get_logger

logger = get_logger(__name__)

#: Tokens-per-round ladder: one decode round emits steps x slots tokens
#: (8..512 typical); prefill-heavy rounds grant up to a few pages.
ROUND_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                       2048, 4096)

#: The round-telemetry metric surface, name -> (kind, help), the
#: reference's names and kinds. ``sched_cost_drift_ratio`` keeps its
#: scheduler-facing name on purpose: it is the model-vs-measured signal
#: operators alert on.
ROUND_METRICS: dict[str, tuple[str, str]] = {
    "engine_rounds_total": (
        "counter",
        "engine rounds completed: plan sealed AND every device output "
        "of the round harvested"),
    "engine_round_seconds": (
        "histogram",
        "per-round wall time, plan start to last harvested output "
        "(includes host dispatch — the drift/dump signal)"),
    "engine_round_device_seconds": (
        "histogram",
        "pipelined per-round device service-time estimate (completion "
        "minus max(dispatch end, previous completion)) — what the "
        "online cost calibrator feeds on"),
    "engine_round_tokens": (
        "histogram",
        "tokens per completed round: decode/verify tokens emitted + "
        "first tokens + prefill tokens granted"),
    "engine_round_bw_util": (
        "gauge",
        "last completed round's estimated HBM bandwidth-utilization "
        "fraction (estimated bytes moved / device time / chip peak; "
        "0 on CPU where no peak is defined)"),
    "engine_round_hbm_bytes_total": (
        "counter",
        "estimated HBM bytes moved by completed rounds (weight stream "
        "per step + live KV pages touched + prefill KV writes)"),
    "sched_cost_drift_ratio": (
        "gauge",
        "EWMA of measured round wall vs the step-cost model's "
        "prediction (1.0 = model matches reality; engine-level, "
        "mirrored per-engine as engine_sched_cost_drift_ratio)"),
    "engine_round_slow_dumps_total": (
        "counter",
        "slow-round structured dumps emitted (round drift or wall time "
        "breached ROUND_DRIFT_DUMP_RATIO / ROUND_SLOW_MS)"),
}


# Resolved metric handles, memoized: record_round_metrics runs on the
# harvest thread once per round — one dict hit beats a lock-guarded
# registry lookup per metric (the obs/metrics.py stage-children
# convention).
_metric_cache: dict[str, object] = {}


def _round_metric(name: str):
    """Resolve one declared round metric from the process registry
    (memoized; benign race — both writers cache the same object)."""
    m = _metric_cache.get(name)
    if m is not None:
        return m
    from . import metrics as obs_metrics
    kind, help_txt = ROUND_METRICS[name]
    reg = obs_metrics.REGISTRY
    if kind == "counter":
        m = reg.counter(name, help_txt)
    elif kind == "gauge":
        m = reg.gauge(name, help_txt)
    else:
        buckets = (ROUND_TOKEN_BUCKETS if name == "engine_round_tokens"
                   else obs_metrics.STAGE_BUCKETS)
        m = reg.histogram(name, help_txt, buckets=buckets)
    _metric_cache[name] = m
    return m


class RoundRecord:
    """One scheduler round: the plan, its dispatch, and its harvest.

    Written by exactly two threads in a strict phase order — scheduler
    (``begin``/``seal``), then harvest (completion) — with ``done`` set
    last, so a snapshot reader that observes ``done`` observes a fully
    written record (the no-torn-records contract the thread-safety test
    pins)."""

    __slots__ = (
        # identity / plan (scheduler thread, begin)
        "round_id", "engine_tag", "t_start", "wall_start", "kind",
        "budget_tokens", "decode_steps", "decode_cost_tokens",
        "active_decodes",
        # dispatch (scheduler thread, filled until seal)
        "decode_slots", "spec_drafted", "verify_positions",
        "prefill_tokens", "prefill_computed", "grants", "pages_touched",
        "hbm_bytes",
        "kv_restore_pages",
        "dispatch_ms", "modeled_ms", "t_dispatch_done",
        # (start, end) CUDA events around the round's programs on the
        # card (None elsewhere): the device time the cost calibrator
        # reads once the end event has completed.
        "device_events",
        # execution (harvest thread)
        "harvest_wait_ms", "first_readback_ms", "tokens_emitted",
        "first_tokens", "spec_accepted",
        # finalization
        "device_ms", "round_ms", "bw_util", "drift_ratio", "done",
        # bookkeeping
        "_parts", "_done_parts", "_sealed", "_cb",
    )

    def __init__(self, round_id: int, engine_tag: str):
        self.round_id = round_id
        self.engine_tag = engine_tag
        self.t_start = time.monotonic()
        self.wall_start = time.time()
        self.kind = "decode"
        self.budget_tokens = 0
        self.decode_steps = 0
        self.decode_cost_tokens = 0
        self.active_decodes = 0
        self.decode_slots = 0
        self.spec_drafted = 0
        self.verify_positions = 0
        self.prefill_tokens = 0
        # The tokens the round's prefill programs computed (each padded to
        # its bucket): the calibrator's denominator.
        self.prefill_computed = 0
        self.grants: list[tuple[str, int]] = []
        self.pages_touched = 0
        self.hbm_bytes = 0
        # KV-tier H2D traffic: pages restored from host RAM ahead of
        # this round's chunk grants (engine/kv_tier.py) — their bytes
        # are folded into hbm_bytes; the count is kept separately so
        # the round record shows restore work explicitly.
        self.kv_restore_pages = 0
        self.dispatch_ms = 0.0
        self.modeled_ms = 0.0
        self.t_dispatch_done = self.t_start
        self.device_events = None
        self.harvest_wait_ms = 0.0
        self.first_readback_ms = 0.0
        self.tokens_emitted = 0
        self.first_tokens = 0
        self.spec_accepted = 0
        self.device_ms = 0.0
        self.round_ms = 0.0
        self.bw_util = 0.0
        self.drift_ratio = 0.0
        self.done = False
        self._parts = 0
        self._done_parts = 0
        self._sealed = False
        self._cb: Optional[Callable[["RoundRecord"], None]] = None

    def to_dict(self) -> dict:
        """JSON-ready view for ``/debug/rounds`` and the slow-round
        dump."""
        return {
            "round_id": self.round_id,
            "engine": self.engine_tag,
            "started_unix_ms": int(self.wall_start * 1e3),
            "kind": self.kind,
            "done": self.done,
            "plan": {
                "budget_tokens": self.budget_tokens,
                "decode_steps": self.decode_steps,
                "decode_cost_tokens": self.decode_cost_tokens,
                "active_decodes": self.active_decodes,
                "prefill_grants": [
                    {"request_id": rid, "tokens": n}
                    for rid, n in self.grants],
                "spec_draft_tokens": self.spec_drafted,
                "modeled_ms": round(self.modeled_ms, 3),
            },
            "execution": {
                "decode_slots": self.decode_slots,
                "prefill_tokens": self.prefill_tokens,
                "dispatch_ms": round(self.dispatch_ms, 3),
                "harvest_wait_ms": round(self.harvest_wait_ms, 3),
                "first_readback_ms": round(self.first_readback_ms, 3),
                "device_ms": round(self.device_ms, 3),
                "round_ms": round(self.round_ms, 3),
            },
            "outcome": {
                "tokens_emitted": self.tokens_emitted,
                "first_tokens": self.first_tokens,
                "spec_accepted": self.spec_accepted,
                "pages_touched": self.pages_touched,
                "kv_restore_pages": self.kv_restore_pages,
                "hbm_bytes_est": self.hbm_bytes,
                "bw_util": round(self.bw_util, 4),
                "drift_ratio": round(self.drift_ratio, 3),
            },
        }


class RoundRecorder:
    """Bounded ring of :class:`RoundRecord`, append-side lock-free for
    the engine's hot threads (the lock guards ring mutation and the
    pipelined-completion clock only; both are once-per-round)."""

    def __init__(self, cap: Optional[int] = None):
        self._cap = (cap if cap is not None
                     else int(os.environ.get("ROUND_RING_CAP", "512")))
        self._lock = threading.Lock()
        self._ring: "deque[RoundRecord]" = deque(maxlen=max(1, self._cap))
        # Monotone across reset(): a restarted engine's rounds continue
        # the sequence, so dashboards and tests can detect a reset as a
        # gap, never as a replayed id.
        self._ids = itertools.count()
        # Pipelined-completion clock PER ENGINE TAG: multi-engine
        # processes (fleet bench, capacity sweeps) share this recorder,
        # and engine A's completion must not truncate engine B's
        # device-time estimate — that estimate feeds B's cost
        # calibrator.
        self._last_complete_t: dict[str, float] = {}

    # --------------------------------------------------- scheduler side

    def begin(self, *, engine_tag: str = "", budget_tokens: int = 0,
              decode_steps: int = 0, decode_cost_tokens: int = 0,
              active_decodes: int = 0, kind: str = "decode",
              on_complete: Optional[Callable[[RoundRecord], None]] = None
              ) -> RoundRecord:
        """Open this round's record (scheduler thread). The record is
        visible in ``/debug/rounds`` immediately, flagged not-done."""
        rec = RoundRecord(next(self._ids), engine_tag)
        rec.kind = kind
        rec.budget_tokens = int(budget_tokens)
        rec.decode_steps = int(decode_steps)
        rec.decode_cost_tokens = int(decode_cost_tokens)
        rec.active_decodes = int(active_decodes)
        rec._cb = on_complete
        with self._lock:
            self._ring.append(rec)
        return rec

    def discard(self, rec: RoundRecord) -> None:
        """Drop a record whose round dispatched nothing (the plan had
        work but every dispatch declined). Ids stay monotone — a gap is
        cheaper than a lie."""
        with self._lock:
            try:
                self._ring.remove(rec)
            except ValueError:
                pass  # already rotated out of the bounded ring

    def seal(self, rec: RoundRecord, *, parts: int,
             prefill_tokens: int = 0,
             grants: Optional[list] = None,
             modeled_ms: float = 0.0) -> None:
        """Close the dispatch half (scheduler thread): ``parts`` is how
        many harvest-side completion signals this round will produce
        (the decode/verify output and/or the prefill completion marker).
        Finalizes immediately if the harvest thread already drained
        every part (it can outrun the scheduler on short rounds)."""
        rec.prefill_tokens = int(prefill_tokens)
        if grants:
            rec.grants = list(grants)
        rec.modeled_ms = float(modeled_ms)
        rec.t_dispatch_done = time.monotonic()
        rec.dispatch_ms = (rec.t_dispatch_done - rec.t_start) * 1e3
        finalize = False
        with self._lock:
            rec._parts = int(parts)
            rec._sealed = True
            finalize = rec._done_parts >= rec._parts
        if finalize:
            self._finalize(rec)

    # ----------------------------------------------------- harvest side

    def complete_part(self, rec: Optional[RoundRecord], *,
                      tokens: int = 0, spec_accepted: int = 0,
                      harvest_wait_ms: float = 0.0) -> None:
        """One harvested device output of this round (harvest thread).
        The last part — once the scheduler has sealed the expected
        count — finalizes the record."""
        if rec is None:
            return
        rec.tokens_emitted += int(tokens)
        rec.spec_accepted += int(spec_accepted)
        rec.harvest_wait_ms += float(harvest_wait_ms)
        finalize = False
        with self._lock:
            rec._done_parts += 1
            finalize = rec._sealed and rec._done_parts >= rec._parts
        if finalize:
            self._finalize(rec)

    def first_token(self, rec: Optional[RoundRecord], *,
                    wait_ms: float = 0.0, counted: bool = True) -> None:
        """A first-token readback attributed to the round that armed the
        request (harvest thread). Does NOT count toward the round's
        completion parts — the prefill completion marker follows it in
        FIFO order and owns the completion signal."""
        if rec is None:
            return
        rec.first_readback_ms += float(wait_ms)
        if counted:
            rec.first_tokens += 1

    def _finalize(self, rec: RoundRecord) -> None:
        now = time.monotonic()
        rec.round_ms = (now - rec.t_start) * 1e3
        with self._lock:
            busy_from = max(rec.t_dispatch_done,
                            self._last_complete_t.get(rec.engine_tag, 0.0))
            self._last_complete_t[rec.engine_tag] = now
        rec.device_ms = max(0.0, (now - busy_from) * 1e3)
        cb = rec._cb
        rec._cb = None
        if cb is not None:
            try:
                cb(rec)
            except Exception:  # noqa: BLE001 — observability never raises
                logger.debug("round completion callback failed",
                             exc_info=True)
        rec.done = True  # LAST write: a done record is fully written

    # --------------------------------------------------------- queries

    def reset(self) -> None:
        """Drop retained records; round ids keep counting (monotone
        across reset — pinned by the thread-safety test)."""
        with self._lock:
            self._ring.clear()
            self._last_complete_t.clear()

    def records(self) -> list[RoundRecord]:
        with self._lock:
            return list(self._ring)

    def snapshot(self, limit: int = 50,
                 engine_tag: Optional[str] = None) -> dict:
        """JSON-ready view for ``GET /debug/rounds``: the ``limit`` most
        recent records plus rolling aggregates over every COMPLETED
        record still in the ring (the aggregation window is therefore
        the ring capacity, ``ROUND_RING_CAP``). ``engine_tag`` restricts
        both to one engine's rounds — multi-engine processes share this
        recorder, and an aggregate mixing two engines' geometries
        answers no question honestly (the bench's per-engine block
        filters here)."""
        recs = self.records()
        if engine_tag is not None:
            recs = [r for r in recs if r.engine_tag == engine_tag]
        complete = [r for r in recs if r.done]
        agg: dict[str, Any] = {"rounds_completed": len(complete)}
        if complete:
            n = len(complete)
            toks = sum(r.tokens_emitted + r.first_tokens for r in complete)
            prefill = sum(r.prefill_tokens for r in complete)
            wall_s = sum(r.round_ms for r in complete) / 1e3
            device_s = sum(r.device_ms for r in complete) / 1e3
            inter = sum(1 for r in complete
                        if r.decode_slots and r.prefill_tokens)
            by_ms = sorted(r.device_ms for r in complete)
            agg.update({
                "window_start_unix_ms": int(complete[0].wall_start * 1e3),
                "tokens_emitted": toks,
                "prefill_tokens": prefill,
                "avg_round_ms": round(1e3 * wall_s / n, 3),
                "avg_device_ms": round(1e3 * device_s / n, 3),
                "p50_device_ms": round(by_ms[n // 2], 3),
                "tokens_per_sec": (round(toks / device_s, 1)
                                   if device_s > 0 else 0.0),
                "interleaved_share": round(inter / n, 4),
                "avg_bw_util": round(
                    sum(r.bw_util for r in complete) / n, 4),
                "hbm_bytes_est": sum(r.hbm_bytes for r in complete),
                "avg_drift_ratio": round(
                    sum(r.drift_ratio for r in complete) / n, 3),
                "spec_drafted": sum(r.spec_drafted for r in complete),
                "spec_accepted": sum(r.spec_accepted for r in complete),
            })
        limit = max(0, int(limit))
        recent = recs[-limit:] if limit else []
        return {
            "rounds": [r.to_dict() for r in reversed(recent)],
            "aggregates": agg,
            "ring_cap": self._cap,
            "retained": len(recs),
        }


def record_round_metrics(rec: RoundRecord,
                         drift_ewma: Optional[float] = None) -> None:
    """Mirror one completed round into the declared ``ROUND_METRICS``
    surface (called from the engine's completion callback — once per
    round, off the scheduler thread)."""
    _round_metric("engine_rounds_total").inc()
    _round_metric("engine_round_seconds").observe(rec.round_ms / 1e3)
    _round_metric("engine_round_device_seconds").observe(
        rec.device_ms / 1e3)
    _round_metric("engine_round_tokens").observe(
        rec.tokens_emitted + rec.first_tokens + rec.prefill_tokens)
    _round_metric("engine_round_bw_util").set(rec.bw_util)
    if rec.hbm_bytes:
        _round_metric("engine_round_hbm_bytes_total").inc(rec.hbm_bytes)
    if drift_ewma is not None:
        _round_metric("sched_cost_drift_ratio").set(drift_ewma)


def emit_round_span(rec: RoundRecord) -> None:
    """Retrospective OTel span for one completed round (explicit
    timestamps — the serve loop never touches the SDK). No-op when
    tracing is off."""
    from . import tracing
    if not tracing.enabled():
        return
    try:
        tracer = tracing._get_tracer()
        if tracer is None:
            return
        start_ns = int(rec.wall_start * 1e9)
        end_ns = int((rec.wall_start + rec.round_ms / 1e3) * 1e9)
        span = tracer.start_span(
            "engine_round", start_time=start_ns,
            attributes={
                "round.id": rec.round_id,
                "round.kind": rec.kind,
                "round.engine": rec.engine_tag,
                "round.decode_steps": rec.decode_steps,
                "round.prefill_tokens": rec.prefill_tokens,
                "round.tokens_emitted": rec.tokens_emitted,
                "round.device_ms": round(rec.device_ms, 3),
                "round.drift_ratio": round(rec.drift_ratio, 3),
            })
        span.end(end_time=end_ns)
    except Exception:  # noqa: BLE001 — observability must never raise
        logger.debug("round span emit failed", exc_info=True)


# Process-wide default recorder: the engine(s) and both HTTP servers
# share this instance unless handed a private one (tests install their
# own via Engine.rounds). Multi-engine processes (the fleet bench)
# interleave here — records carry engine_tag to tell them apart.
RECORDER = RoundRecorder()


def debug_rounds_response(request,
                          recorder: Optional[RoundRecorder] = None):
    """The ``GET /debug/rounds`` aiohttp handler body, shared by the
    chain server and the model server so the endpoint contract
    (``limit``/``engine`` parsing, error shape, snapshot schema) cannot
    drift between them. ``?engine=<tag>`` scopes records and aggregates
    to one engine in multi-engine processes."""
    from aiohttp import web

    from .history import query_int
    limit = query_int(request, "limit", 50, minimum=0)
    engine_tag = request.query.get("engine") or None
    return web.json_response((recorder or RECORDER).snapshot(
        limit=limit, engine_tag=engine_tag))
