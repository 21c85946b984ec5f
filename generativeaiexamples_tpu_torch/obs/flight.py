"""Per-request flight recorder: who was slow, and where — a copy of the
reference package's ``obs/flight.py``.

The aggregate registry (``obs/metrics.py``) answers "how is the fleet
doing"; this module answers the question aggregates can't: *why was THIS
request slow?* Every request entering the serving path gets

- a **request ID**: adopted from the caller's ``X-Request-ID`` header (or
  the W3C ``traceparent`` trace-id) at the HTTP edge, minted otherwise,
  and passed to ``Engine.submit()``, whose stream owns the timeline;
- a **timeline**: a preallocated per-request event ring recording queue
  wait, admission dispatch, prefix-cache hit length, prefill chunks,
  first token, per-round token counts, and the finish/cancel reason.

Concurrency contract (the token-path budget): timeline appends are O(1)
slot writes into a preallocated ring, indexed by an atomic-under-GIL
``itertools.count`` — no lock is taken on append, so the engine's
scheduler and harvest threads never contend with each other or with a
``/debug/requests`` reader. Per-TOKEN work records nothing; the harvest
worker records one event per decode round. The recorder's own lock
guards only the in-flight/completed maps, touched once at begin and once
at completion — never from ``decode_round`` dispatch.

Exposure:

- ``GET /debug/requests`` on the chain server and the model server
  renders ``RECORDER.snapshot()`` — in-flight plus the last-N completed
  timelines;
- requests breaching the SLO thresholds (``FLIGHT_SLO_TTFT_MS``,
  ``FLIGHT_SLO_TOTAL_MS``) dump their whole timeline as one structured
  log line (``utils/logging.log_event``);
- when tracing is on (``obs/tracing.py``), completion replays the
  timeline's duration events as OTel child spans carrying the request ID
  — the engine's internal stages land in the same trace as the chain's
  retrieve/templating/llm spans.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

from ..utils.logging import get_logger, log_event

logger = get_logger(__name__)

# The timeline of the request the calling context serves: the chain
# server binds it around its chain generator, which runs under a copied
# context (``serving/streaming.py``), so the chain's stages, the embedder
# and ``Engine.submit`` all reach it without an argument.
_current: contextvars.ContextVar[Optional["Timeline"]] = \
    contextvars.ContextVar("flight_timeline", default=None)

_MAX_RID_CHARS = 128


def mint_request_id() -> str:
    """A fresh request ID (16 hex chars — short enough to grep, unique
    enough for a ring of thousands)."""
    return uuid.uuid4().hex[:16]


def adopt_request_id(headers: Any, mint=mint_request_id) -> str:
    """Request ID from inbound HTTP headers: ``X-Request-ID`` verbatim
    (sanitized), else the W3C ``traceparent`` trace-id — so a traced
    caller's spans and its flight timeline share an identity — else one
    from ``mint`` (callers with their own ID shape, e.g. the OpenAI
    surface's ``cmpl-`` completion ids, pass their minter so malformed
    headers fall back to the documented shape)."""
    rid = ""
    if headers is not None:
        rid = (headers.get("X-Request-ID") or "").strip()
        if not rid:
            # traceparent: 00-<trace-id 32hex>-<span-id 16hex>-<flags>
            parts = (headers.get("traceparent") or "").split("-")
            if len(parts) == 4 and len(parts[1]) == 32:
                rid = parts[1]
    rid = "".join(c for c in rid[:_MAX_RID_CHARS]
                  if c.isprintable() and c not in '{}"\\')
    return rid or mint()


def adopt_deadline_ms(headers: Any,
                      default_ms: Optional[float] = None) -> Optional[float]:
    """Per-request deadline from the ``X-Deadline-Ms`` header: how long
    the caller is willing to wait for this request END TO END. Returns
    milliseconds, or None when neither the header nor ``default_ms``
    sets a positive bound. Malformed values fall back to the default —
    a garbled header must not grant an infinite deadline when the
    deployment configured a finite one."""
    ms: Optional[float] = None
    if headers is not None:
        raw = (headers.get("X-Deadline-Ms") or "").strip()
        if raw:
            try:
                ms = float(raw)
            except ValueError:
                ms = None
    if ms is None:
        ms = default_ms
    if ms is None or ms <= 0:
        return None
    return ms


def bind(timeline: Optional["Timeline"]):
    """Bind ``timeline`` as the current request's; returns the reset
    token for ``unbind``."""
    return _current.set(timeline)


def unbind(token) -> None:
    _current.reset(token)


def current() -> Optional["Timeline"]:
    return _current.get()


def current_request_id() -> Optional[str]:
    tl = _current.get()
    return tl.request_id if tl is not None else None


def record_current_stage(name: str, seconds: float) -> None:
    """Append a stage duration to the bound timeline, if any — the hook
    ``obs.tracing.record_stage`` fans into, so every ``event_span`` and
    ``record_stage`` site (the chain's retrieve/templating/llm, the
    embedder's dispatch, EngineLLM's first chunk) lands on the request's
    timeline."""
    tl = _current.get()
    if tl is not None:
        tl.stage(name, seconds)


class Timeline:
    """Event ring for one request.

    Events are ``(seq, t_monotonic, name, value)`` tuples in a
    preallocated ring; value typing is by convention — ``float`` means a
    stage DURATION in seconds, ``int`` a count, ``str`` an annotation,
    ``None`` a bare marker. Appends take no lock (see module docstring);
    readers snapshot best-effort. ``meta`` is a plain dict for
    single-value facts (slot, prompt tokens, finish reason, ...) —
    per-key assignment is atomic under the GIL.
    """

    __slots__ = ("request_id", "t_start", "wall_start", "meta", "done",
                 "otel_ctx", "deadline_t", "_events", "_cap", "_seq", "_n")

    def __init__(self, request_id: str, event_cap: int = 64):
        self.request_id = request_id
        self.t_start = time.monotonic()
        self.wall_start = time.time()
        self.meta: dict[str, Any] = {}
        self.done = False
        # Absolute (monotonic) deadline for this request, stamped by the
        # engine from the one the serving edge passed (X-Deadline-Ms /
        # the configured default).
        self.deadline_t: Optional[float] = None
        # OTel context captured at begin() (the request's server span)
        # so the retrospective span replay parents engine stages INTO
        # the request's trace instead of emitting disconnected roots.
        self.otel_ctx: Any = None
        self._cap = max(8, int(event_cap))
        self._events: list = [None] * self._cap
        self._seq = itertools.count()   # next() is atomic under the GIL
        self._n = 0                     # approximate (racy, monotonic-ish)

    # ------------------------------------------------------------ writers

    def event(self, name: str, value: Any = None,
              t: Optional[float] = None) -> None:
        """O(1) ring append from any thread."""
        i = next(self._seq)
        self._events[i % self._cap] = (
            i, time.monotonic() if t is None else t, name, value)
        self._n = i + 1

    def stage(self, name: str, seconds: float) -> None:
        """A completed stage of ``seconds`` duration ending now."""
        self.event(name, float(seconds))

    def annotate(self, **fields: Any) -> None:
        self.meta.update(fields)

    def set_deadline(self, ms: Optional[float]) -> None:
        """Arm this request's deadline, ``ms`` from its start (None/<=0
        clears). Recorded in meta so /debug/requests shows the budget a
        dropped request was admitted against."""
        if ms is None or ms <= 0:
            self.deadline_t = None
            self.meta.pop("deadline_ms", None)
            return
        self.deadline_t = self.t_start + ms / 1e3
        self.meta["deadline_ms"] = round(float(ms), 1)

    # ------------------------------------------------------------ readers

    def events_snapshot(self) -> list[tuple]:
        """Best-effort ordered copy of the ring's live events."""
        items = [e for e in list(self._events) if e is not None]
        items.sort(key=lambda e: e[0])
        return items

    def stage_durations(self) -> dict[str, float]:
        """name -> seconds for every duration event (first occurrence
        wins, matching the old first-wins stage collector)."""
        out: dict[str, float] = {}
        for _, _, name, value in self.events_snapshot():
            if isinstance(value, float) and not isinstance(value, bool) \
                    and name not in out:
                out[name] = value
        return out

    def epoch_ns(self, t_monotonic: float) -> int:
        return int((self.wall_start + (t_monotonic - self.t_start)) * 1e9)

    def to_dict(self) -> dict:
        events = []
        for _, t, name, value in self.events_snapshot():
            ev: dict[str, Any] = {"event": name,
                                  "t_ms": round((t - self.t_start) * 1e3, 3)}
            if isinstance(value, float) and not isinstance(value, bool):
                ev["dur_ms"] = round(value * 1e3, 3)
            elif isinstance(value, bool) or value is not None:
                ev["value"] = value
            events.append(ev)
        n = self._n
        out = {
            "request_id": self.request_id,
            "started_unix_ms": int(self.wall_start * 1e3),
            "age_ms": round((time.monotonic() - self.t_start) * 1e3, 1),
            "done": self.done,
            "meta": dict(self.meta),
            "events": events,
            "events_dropped": max(0, n - self._cap),
        }
        return out


class FlightRecorder:
    """In-flight map + bounded completed ring of request timelines."""

    def __init__(self, completed_cap: Optional[int] = None,
                 event_cap: Optional[int] = None):
        self._lock = threading.Lock()   # maps only; never on the token path
        self._inflight: dict[str, Timeline] = {}
        self._completed: "deque[Timeline]" = deque(
            maxlen=completed_cap if completed_cap is not None
            else int(os.environ.get("FLIGHT_COMPLETED_CAP", "256")))
        self.event_cap = (event_cap if event_cap is not None
                          else int(os.environ.get("FLIGHT_EVENT_CAP", "64")))
        # Slow-request dump thresholds, ms; 0 disables either check.
        self.slo_ttft_ms = float(
            os.environ.get("FLIGHT_SLO_TTFT_MS", "2000") or 0)
        self.slo_total_ms = float(
            os.environ.get("FLIGHT_SLO_TOTAL_MS", "30000") or 0)

    # ---------------------------------------------------------- lifecycle

    def begin(self, request_id: Optional[str] = None,
              fresh: bool = False) -> Timeline:
        """Timeline for ``request_id``, creating one if none is in
        flight under that ID — idempotent by default, so two begin()
        calls for the same logical request share one timeline.

        ``fresh=True`` is for serving EDGES, where each call is a new
        request by definition: a client-supplied ID colliding with a
        different still-in-flight request (a retry racing its original,
        a duplicating proxy) gets a ``#N``-suffixed timeline instead of
        silently interleaving into — and being swallowed by — the first
        request's record."""
        rid = request_id or mint_request_id()
        with self._lock:
            tl = self._inflight.get(rid)
            if tl is not None and fresh:
                n = 2
                while f"{rid}#{n}" in self._inflight:
                    n += 1
                rid = f"{rid}#{n}"
                tl = None
            if tl is None:
                tl = Timeline(rid, self.event_cap)
                self._inflight[rid] = tl
                created = True
            else:
                created = False
        if created:
            from . import tracing
            if tracing.enabled() and tl.otel_ctx is None:
                # Capture the caller's span context (the server span when
                # begin() runs inside an instrumented handler); the
                # completion-time replay runs on an engine thread with an
                # EMPTY context, so without this the stage spans would be
                # parentless roots outside the request's trace.
                try:
                    from opentelemetry import context as otel_context
                    tl.otel_ctx = otel_context.get_current()
                except Exception:  # noqa: BLE001 — tracing is best-effort
                    pass
        return tl

    def complete(self, tl: Optional[Timeline]) -> None:
        """Move a timeline to the completed ring (idempotent; first call
        wins), then run the SLO dump and span replay off the maps lock."""
        if tl is None:
            return
        with self._lock:
            if tl.done:
                return
            tl.done = True
            if self._inflight.get(tl.request_id) is tl:
                del self._inflight[tl.request_id]
            self._completed.append(tl)
        # Requests that never reached an engine (echo chains, pre-submit
        # failures) have no stream-measured duration — fall back to the
        # timeline's own age so the total-duration SLO still fires on
        # chain-side slowness.
        tl.meta.setdefault(
            "duration_ms", round((time.monotonic() - tl.t_start) * 1e3, 2))
        self._check_slo(tl)
        self._emit_spans(tl)

    def complete_stream(self, stream) -> None:
        """Completion driven from a terminal ``TokenStream`` transition
        (finish/fail/cancel): stamp the engine's serving measurements
        into the stream's timeline and — when the engine owns it —
        complete it.

        A stream that ADOPTED a serving edge's timeline
        (``stream.owns_timeline`` False) must not retire it: a chain may
        run several engine calls per HTTP request, and the request is
        over only when the edge completes it. Sub-call stats accumulate
        instead: ``generated`` sums, ``ttft_ms`` keeps the first
        sub-call's, ``finish`` tracks the latest, and the duration is
        left to ``complete()``'s whole-timeline fallback."""
        tl = getattr(stream, "timeline", None)
        if tl is None or tl.done:
            return
        reason = stream.finish_reason or "unknown"
        owns = getattr(stream, "owns_timeline", True)
        tl.meta["generated"] = (tl.meta.get("generated") or 0) \
            + len(stream.token_ids)
        if stream.ttft_ms is not None:
            tl.meta.setdefault("ttft_ms", round(stream.ttft_ms, 2))
        tl.annotate(finish=reason)
        if owns and stream.finish_time is not None:
            # failed streams have no finish_time; complete() falls back
            # to the timeline's age for the duration SLO
            tl.annotate(duration_ms=round(
                (stream.finish_time - stream.submit_time) * 1e3, 2))
        tl.event("finish", reason)
        if owns:
            self.complete(tl)

    # ------------------------------------------------------------ queries

    def recent_stage_ms(self, name: str, limit: int = 32,
                        window_s: float = 60.0) -> tuple[int, float]:
        """``(samples, avg_ms)`` of stage ``name`` over the most recently
        completed timelines — the data behind edge admission control: the
        chain server estimates a new request's queue wait from the
        ``engine_admit_pickup`` durations of the last N requests and
        sheds arrivals whose deadline the estimate already exceeds.
        ``window_s`` bounds how STALE the evidence may be: without it, a
        past congestion burst would keep shedding requests long after
        the queue drained idle (no completions → the ring never turns
        over). Cheap by construction: reads only the bounded ring."""
        now = time.monotonic()
        with self._lock:
            tls = list(self._completed)[-max(0, int(limit)):]
        vals = []
        for tl in tls:
            if window_s and now - tl.t_start > window_s:
                continue
            d = tl.stage_durations().get(name)
            if d is not None:
                vals.append(d * 1e3)
        if not vals:
            return 0, 0.0
        return len(vals), sum(vals) / len(vals)

    def snapshot(self, limit: int = 50) -> dict:
        """JSON-ready view for ``/debug/requests``: every in-flight
        timeline plus the ``limit`` most recently completed."""
        limit = int(limit)
        with self._lock:
            inflight = list(self._inflight.values())
            # NB [-limit:] with limit=0 would slice EVERYTHING
            completed = list(self._completed)[-limit:] if limit > 0 else []
        inflight.sort(key=lambda t: t.t_start)
        return {
            "in_flight": [t.to_dict() for t in inflight],
            "completed": [t.to_dict() for t in reversed(completed)],
            "completed_retained": len(completed),
            "slo": {"ttft_ms": self.slo_ttft_ms,
                    "total_ms": self.slo_total_ms},
        }

    # ----------------------------------------------------------- exposure

    def _check_slo(self, tl: Timeline) -> None:
        ttft = tl.meta.get("ttft_ms")
        total = tl.meta.get("duration_ms")
        slow = ((self.slo_ttft_ms and ttft is not None
                 and ttft > self.slo_ttft_ms)
                or (self.slo_total_ms and total is not None
                    and total > self.slo_total_ms))
        if slow:
            log_event(logger, "slow_request", request_id=tl.request_id,
                      ttft_ms=ttft, duration_ms=total,
                      slo_ttft_ms=self.slo_ttft_ms,
                      slo_total_ms=self.slo_total_ms,
                      timeline=tl.to_dict())

    def _emit_spans(self, tl: Timeline) -> None:
        """Replay the timeline's duration events as OTel child spans
        (request ID + stage attributes) when tracing is enabled. Spans
        are emitted retrospectively at completion with explicit
        timestamps, so the token path never touches the OTel SDK."""
        from . import tracing
        if not tracing.enabled():
            return
        try:
            tracer = tracing._get_tracer()  # may ImportError w/o the SDK
            if tracer is None:
                return
            for _, t, name, value in tl.events_snapshot():
                if not isinstance(value, float) or isinstance(value, bool):
                    continue
                span = tracer.start_span(
                    name, context=tl.otel_ctx,
                    start_time=tl.epoch_ns(t - value),
                    attributes={"request.id": tl.request_id, "stage": name})
                span.end(end_time=tl.epoch_ns(t))
        except Exception:   # noqa: BLE001 — observability must never raise
            logger.debug("span replay failed", exc_info=True)


# Process-wide default recorder: the engine, both HTTP servers, and the
# bench all read/write this instance unless handed a private one.
RECORDER = FlightRecorder()


def debug_requests_response(request,
                            recorder: Optional[FlightRecorder] = None):
    """The ``GET /debug/requests`` aiohttp handler body, shared by the
    chain server and the model server so the endpoint contract (``limit``
    parsing, error shape, snapshot schema) cannot drift between them."""
    from aiohttp import web

    from .history import query_int
    limit = query_int(request, "limit", 50, minimum=0)
    return web.json_response((recorder or RECORDER).snapshot(limit=limit))
