"""Router flight recorder + rolling SLO window: the fleet's edge view.

The engine's flight recorder (``obs/flight.py``) answers *why was this
request slow inside one replica*; this module answers the questions only
the ROUTER can: *where was this request placed and why, what did each
connect/retry attempt cost, and is the fleet meeting its SLO* — measured
from router-observed outcomes (first upstream byte, deadline vs
``X-Deadline-Ms``, error frames), never from replica self-reports.

Two pieces:

- :class:`RouterFlightRecorder` — a thin specialization of the engine's
  ``FlightRecorder`` (same bounded lock-light ring ``Timeline``, same
  in-flight map + completed deque, same ``/debug/requests`` snapshot
  contract), whose timelines record the ROUTER's stages: the placement
  decision (chosen replica, scored candidates, affinity-sketch match,
  KV-transfer hint), each connect/retry attempt with its reason, drain /
  429 relays, the first upstream byte (``router_ttft`` — the
  router-observed TTFT), and stream end or mid-stream loss. Timelines
  are keyed by the SAME ``X-Request-ID`` the router forwards, so one ID
  joins the router timeline, the replica's ``/debug/requests`` timeline,
  and the engine's round-record grant list. When tracing is on, the
  request's ``traceparent`` is adopted as the span-replay parent, so the
  retrospective ``router_place`` / ``router_connect`` /
  ``router_stream`` stage spans land in the caller's trace next to the
  chain server's and the engine's replayed spans — one trace, three
  layers.
- :class:`SloWindow` — a recency-windowed per-replica outcome ring
  feeding the doc-fenced ``router_slo_attainment{replica=}`` gauge, the
  ``router_ttft_seconds`` histogram, and the windowed shed / error /
  mid-stream-loss rate gauges. Every routed request (and every failed
  connect attempt) lands one outcome row; rows older than
  ``ROUTER_SLO_WINDOW_S`` age out of the rates, so a past incident stops
  dragging attainment once the window turns over.

Outcome taxonomy (one row per terminal outcome, plus one per failed
connect attempt — attempt rows are attributed to the replica that
failed, which is what makes a partitioned replica's attainment drop
while its healthy siblings', and the fleet totals, stay consistent):

======================  ==================================================
outcome                 meaning
======================  ==================================================
``ok``                  2xx stream ran to completion
``shed``                backpressure relayed or originated by the router
                        (429 queue_full/draining/deadline, 503
                        no_replicas — attributed to ``_router`` when no
                        replica was involved)
``error``               5xx relays, post-connect failures, 4xx other
                        than backpressure
``connect_fail``        one connect-phase attempt failed (the request
                        itself may still have succeeded on a sibling)
``midstream_loss``      replica lost mid-stream (error frame appended)
``disconnect``          the CALLER hung up mid-stream — says nothing
                        about the fleet; excluded from the error rate
======================  ==================================================

SLO attainment per row: a request with a deadline attains when it
completed ``ok`` within ``X-Deadline-Ms``; without one, when its
router-observed TTFT beat ``ROUTER_SLO_TTFT_MS``. Non-``ok`` rows never
attain.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Optional

from ..obs import flight as obs_flight
from ..utils.logging import get_logger
from . import metrics as router_metrics

logger = get_logger(__name__)

#: Replica label for outcomes no replica was involved in (e.g. a 503
#: ``no_replicas`` — the router itself shed the request).
ROUTER_SELF = "_router"

#: Outcomes counted against the windowed error rate. ``disconnect`` is
#: deliberately absent: an impatient caller proves nothing about the
#: fleet.
_ERROR_OUTCOMES = ("error", "connect_fail")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class Transcript:
    """Bounded per-request generation transcript: every byte the router
    has forwarded downstream for one ``/generate`` stream, held to clean
    UTF-8 boundaries.

    This is the dedupe boundary of mid-stream failover
    (docs/robustness.md): on upstream loss the router re-submits the
    request with ``text`` as the generated-so-far continuation, and the
    sibling streams only what comes AFTER it — so the transcript must
    equal EXACTLY what the caller has seen. ``push`` therefore withholds
    a trailing incomplete UTF-8 sequence (HTTP chunking can split a
    multibyte character across TCP segments even though the engine's
    detokenizer only emits whole characters) from both the caller and
    the transcript; the ≤3-byte tail is flushed on clean EOF or on a
    failed resume (ahead of the error frame), and DISCARDED on a
    successful resume — the sibling regenerates that token and the
    caller receives its full bytes exactly once.

    The buffer is bounded by ``ROUTER_TRANSCRIPT_MAX_BYTES``: past the
    cap (or on a stream that is not UTF-8 at all) the transcript stops
    accumulating and marks itself ``overflowed`` — forwarding continues
    untouched, resume is simply off for this request (outcome
    ``overflow`` in ``router_resume_total``).
    """

    def __init__(self, max_bytes: Optional[int] = None):
        self.max_bytes = (max_bytes if max_bytes is not None
                          else int(_env_float(
                              "ROUTER_TRANSCRIPT_MAX_BYTES", 262144)))
        self._buf = bytearray()
        self._pending = b""
        self.overflowed = False

    @staticmethod
    def _clean_cut(data: bytes) -> int:
        """Length of the longest prefix that is complete UTF-8; -1 when
        even holding back 3 bytes leaves the tail undecodable (the
        stream is not UTF-8 — transcripting is meaningless)."""
        for cut in range(len(data), max(len(data) - 3, 0) - 1, -1):
            try:
                data[:cut].decode("utf-8")
                return cut
            except UnicodeDecodeError:
                continue
        return -1

    def push(self, chunk: bytes) -> bytes:
        """Absorb one upstream chunk; returns the bytes to forward to
        the caller now (everything up to the last clean UTF-8
        boundary)."""
        data = self._pending + chunk
        cut = self._clean_cut(data)
        if cut < 0:
            # Not UTF-8: forward verbatim, stop transcripting.
            self.overflowed = True
            self._buf.clear()
            self._pending = b""
            return data
        out, self._pending = data[:cut], data[cut:]
        if not self.overflowed:
            if len(self._buf) + len(out) > self.max_bytes:
                self.overflowed = True
                self._buf.clear()
            else:
                self._buf += out
        return out

    def flush(self) -> bytes:
        """Release the held-back tail (clean EOF / failed resume)."""
        out, self._pending = self._pending, b""
        return out

    def discard_pending(self) -> None:
        """Drop the held-back tail (successful resume: the sibling
        regenerates the token those bytes came from)."""
        self._pending = b""

    @property
    def size(self) -> int:
        return len(self._buf)

    @property
    def text(self) -> str:
        """The generated-so-far text — what the caller has seen."""
        return bytes(self._buf).decode("utf-8")


class SloWindow:
    """Recency-windowed per-replica outcome ring (see module docstring).

    Appends are O(1) deque pushes under a small lock (the router is
    single-threaded asyncio, but the bench and tests read from other
    threads); rate/attainment computation walks the bounded ring only
    when asked (``snapshot``/``publish``) — never per request.
    """

    def __init__(self, window_s: Optional[float] = None,
                 cap: Optional[int] = None,
                 slo_ttft_ms: Optional[float] = None):
        self.window_s = (window_s if window_s is not None
                         else _env_float("ROUTER_SLO_WINDOW_S", 60.0))
        self.slo_ttft_ms = (slo_ttft_ms if slo_ttft_ms is not None
                            else _env_float("ROUTER_SLO_TTFT_MS", 2000.0))
        self._lock = threading.Lock()
        self._ring: deque = deque(
            maxlen=cap if cap is not None
            else int(_env_float("ROUTER_SLO_WINDOW_CAP", 2048)))

    # ------------------------------------------------------------ writers

    def record(self, *, replica: str, outcome: str,
               ttft_ms: Optional[float] = None,
               duration_ms: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> bool:
        """Append one outcome row; returns whether it attained the SLO."""
        attained = False
        if outcome == "ok":
            if deadline_ms is not None:
                attained = (duration_ms is not None
                            and duration_ms <= deadline_ms)
            else:
                attained = (ttft_ms is not None
                            and ttft_ms <= self.slo_ttft_ms)
        with self._lock:
            self._ring.append((time.monotonic(), replica or ROUTER_SELF,
                               outcome, ttft_ms, attained))
        router_metrics.counter("router_requests_total", outcome).inc()
        if ttft_ms is not None:
            router_metrics.histogram("router_ttft_seconds").observe(
                ttft_ms / 1e3)
        return attained

    def forget(self, replica: str) -> int:
        """Drop every outcome row attributed to ``replica`` — the
        membership-churn hook: a removed (or re-added) replica's window
        must not poison the fresh pod's attainment, and fleet totals
        must stop counting a member that no longer exists. Returns the
        number of rows dropped."""
        with self._lock:
            kept = [r for r in self._ring if r[1] != replica]
            dropped = len(self._ring) - len(kept)
            if dropped:
                self._ring.clear()
                self._ring.extend(kept)
        return dropped

    # ------------------------------------------------------------ readers

    def _live_rows(self) -> list[tuple]:
        cutoff = time.monotonic() - self.window_s
        with self._lock:
            return [r for r in self._ring if r[0] >= cutoff]

    def snapshot(self, replicas: Optional[list[str]] = None) -> dict:
        """``{replica: {requests, attained, attainment, shed_rate,
        error_rate, midstream_loss_rate, ttft_p50_ms, outcomes}}`` plus a
        ``_total`` row aggregating every live row — by construction the
        total's counts equal the sum of the per-replica rows (the fleet
        consistency the acceptance test pins). ``replicas`` forces empty
        rows for known-but-quiet replicas so the fleet snapshot always
        carries every table member.

        Attainment denominators differ by level ON PURPOSE: a
        per-replica row divides by ALL of that replica's rows — a
        replica you cannot connect to is failing ITS SLO, so attempt
        rows drag it down — while the ``_total`` row divides by
        request-terminal outcomes only (``connect_fail`` attempt rows
        and caller ``disconnect``s excluded): a request that retried
        onto a sibling and met its deadline counts once, as attained,
        in the fleet headline callers actually experienced."""
        rows = self._live_rows()
        by_rep: dict[str, list[tuple]] = {}
        for row in rows:
            by_rep.setdefault(row[1], []).append(row)
        for name in replicas or ():
            by_rep.setdefault(name, [])
        out: dict[str, dict] = {}
        for name, rep_rows in by_rep.items():
            out[name] = self._stats(rep_rows)
        out["_total"] = self._stats(rows, request_level=True)
        out["_total"]["window_s"] = self.window_s
        out["_total"]["slo_ttft_ms"] = self.slo_ttft_ms
        return out

    def _stats(self, rows: list[tuple],
               request_level: bool = False) -> dict:
        n = len(rows)
        outcomes: dict[str, int] = {}
        ttfts: list[float] = []
        attained = 0
        for _, _, outcome, ttft_ms, ok in rows:
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            attained += bool(ok)
            if ttft_ms is not None:
                ttfts.append(ttft_ms)
        ttfts.sort()
        errors = sum(outcomes.get(o, 0) for o in _ERROR_OUTCOMES)
        denom = n
        if request_level:
            denom = n - outcomes.get("connect_fail", 0) \
                - outcomes.get("disconnect", 0)
        return {
            "requests": n,
            "attained": attained,
            "attainment": (round(attained / denom, 4) if denom > 0
                           else None),
            "shed_rate": round(outcomes.get("shed", 0) / n, 4) if n else 0.0,
            "error_rate": round(errors / n, 4) if n else 0.0,
            "midstream_loss_rate": (round(
                outcomes.get("midstream_loss", 0) / n, 4) if n else 0.0),
            "ttft_p50_ms": (round(ttfts[len(ttfts) // 2], 2)
                            if ttfts else None),
            "outcomes": outcomes,
        }

    def publish(self, replicas: Optional[list[str]] = None) -> dict:
        """Refresh the per-replica window gauges from the current rows
        and return the snapshot (the fleet refresh calls this once per
        heartbeat; /metrics holds the last published values)."""
        snap = self.snapshot(replicas)
        for name, stats in snap.items():
            if name.startswith("_") or name == ROUTER_SELF:
                continue
            # An EMPTY window publishes 1.0, not the last value: once an
            # incident's rows age out there is no evidence of misses,
            # and a frozen incident-era gauge would keep an attainment
            # alert firing forever on a recovered-but-idle replica.
            router_metrics.gauge(
                "router_slo_attainment", name).set(
                stats["attainment"] if stats["attainment"] is not None
                else 1.0)
            router_metrics.gauge(
                "router_window_shed_rate", name).set(stats["shed_rate"])
            router_metrics.gauge(
                "router_window_error_rate", name).set(stats["error_rate"])
            router_metrics.gauge(
                "router_window_midstream_loss_rate", name).set(
                stats["midstream_loss_rate"])
        return snap


class RouterFlightRecorder(obs_flight.FlightRecorder):
    """The engine flight recorder's storage and snapshot contract, with
    router-shaped begin/complete hooks (see module docstring). The
    ``GET /debug/requests`` handler body is shared with both servers via
    ``obs_flight.debug_requests_response(request, recorder=...)``."""

    def __init__(self, slo: Optional[SloWindow] = None,
                 completed_cap: Optional[int] = None):
        super().__init__(
            completed_cap=completed_cap if completed_cap is not None
            else int(_env_float("ROUTER_FLIGHT_COMPLETED_CAP", 256)))
        self.slo = slo or SloWindow()

    # ---------------------------------------------------------- lifecycle

    def begin_request(self, headers: Any, path: str) -> obs_flight.Timeline:
        """Open this request's router timeline: adopt (or mint) the
        request ID the forward will carry, arm the deadline, and — with
        tracing on — adopt the caller's ``traceparent`` as the parent
        context the completion-time span replay emits under."""
        rid = obs_flight.adopt_request_id(headers)
        tl = self.begin(rid, fresh=True)
        tl.annotate(route=path, edge="router")
        deadline_ms = obs_flight.adopt_deadline_ms(headers)
        if deadline_ms is not None:
            tl.set_deadline(deadline_ms)
        from ..obs import tracing
        if tracing.enabled():
            try:
                from opentelemetry.propagate import extract
                tl.otel_ctx = extract(dict(headers or {}))
            except Exception:  # noqa: BLE001 — tracing is best-effort
                pass
        return tl

    def complete_request(self, tl: Optional[obs_flight.Timeline], *,
                         outcome: str, replica: str = "",
                         status: Optional[int] = None) -> None:
        """Terminal transition: stamp the outcome, feed the SLO window,
        and retire the timeline (idempotent — only the first outcome
        wins, like the engine recorder's ``complete``)."""
        if tl is None or tl.done:
            return
        duration_ms = round((time.monotonic() - tl.t_start) * 1e3, 2)
        tl.annotate(outcome=outcome, duration_ms=duration_ms)
        if replica:
            tl.annotate(replica=replica)
        if status is not None:
            tl.annotate(status=status)
        tl.event("finish", outcome)
        attained = self.slo.record(
            replica=replica or ROUTER_SELF, outcome=outcome,
            ttft_ms=tl.meta.get("ttft_ms"), duration_ms=duration_ms,
            deadline_ms=tl.meta.get("deadline_ms"))
        tl.annotate(slo_attained=attained)
        self.complete(tl)

    # ------------------------------------------------------------ events

    @staticmethod
    def placement(tl: Optional[obs_flight.Timeline], *, replica: str,
                  affinity_blocks: int, candidates: list[dict],
                  t_start: float, kv_donor: Optional[str] = None) -> None:
        """One placement decision: the chosen replica, how many leading
        prompt blocks its sketch matched, and every candidate's score —
        the evidence an operator needs to answer 'why THERE?'."""
        if tl is None:
            return
        tl.stage("router_place", time.monotonic() - t_start)
        tl.event("place", {"replica": replica,
                           "affinity_blocks": affinity_blocks,
                           "candidates": candidates})
        if kv_donor:
            tl.event("kv_transfer_hint", kv_donor)

    def attempt_failed(self, tl: Optional[obs_flight.Timeline], *,
                       replica: str, reason: str,
                       retried: bool) -> None:
        """A forward attempt died (connect failure or a 429-draining
        refusal). Recorded on the timeline AND — for connect failures —
        as an attempt-level outcome row against the failing replica, so
        a partitioned replica's SLO window degrades even while every
        caller request still succeeds on a sibling."""
        if tl is not None:
            tl.event("retry" if retried else "attempt_failed",
                     {"replica": replica, "reason": reason})
        if reason == "connect":
            self.slo.record(replica=replica, outcome="connect_fail")

    @staticmethod
    def first_byte(tl: Optional[obs_flight.Timeline]) -> None:
        """First upstream body byte = the router-observed TTFT."""
        if tl is None or "ttft_ms" in tl.meta:
            return
        ttft_s = time.monotonic() - tl.t_start
        tl.stage("router_ttft", ttft_s)
        tl.annotate(ttft_ms=round(ttft_s * 1e3, 2))
