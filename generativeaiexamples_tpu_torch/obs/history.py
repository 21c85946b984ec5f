"""In-process metric history: a fixed-interval ring sampler over the
metrics registry — a copy of the reference package's ``obs/history.py``.

Every surface in this repo publishes point-in-time state — ``/metrics``
is a scrape, ``/debug/fleet`` a snapshot, the flight/round recorders
bounded rings — so "what happened in the last ten minutes?" has no
answer unless an external scraper happened to be attached. The
``MetricHistory`` sampler closes that gap in-process: every
``HISTORY_INTERVAL_S`` it snapshots the registry (every gauge value,
every counter's cumulative value so deltas/rates derive at query time)
into a ``deque`` ring bounded by ``HISTORY_WINDOW_S``, the same
lock-light shape as the round ring (``obs/rounds.py``): one lock guards
ring mutation only, samples are immutable once appended, readers copy
under the lock and aggregate outside it.

Served as ``GET /debug/history?metrics=<glob>&window=<s>`` on the chain
server, the model server, and the router — windowed aggregates
(last/min/max/avg; counters additionally delta + rate) per series.

Arming is a deployment decision: ``HISTORY_INTERVAL_S=0`` makes the
layer INERT — no sampler thread, no alert ticks downstream, no disk
writes — pinned by tests/test_history_alerts.py. The sampler is also
where the alert engine (``obs/alerts.py``) ticks from and what the
incident black-box (``obs/incidents.py``) freezes.

This module additionally hosts the one shared ``?limit=``/``?window=``
query parser every ``/debug/*`` endpoint uses (non-integer → 400 with
the repo's JSON error body + ``X-Request-ID``), replacing the
hand-rolled per-endpoint ``int(request.query...)`` parses.
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
from typing import Callable, Optional, Sequence

from ..utils.logging import get_logger
from . import metrics as obs_metrics

logger = get_logger(__name__)

#: Ring span: how far back /debug/history (and incident bundles) can
#: look. Interval: sampling period; 0 disarms the whole retained-
#: telemetry layer (sampler, alerts, incident capture).
HISTORY_WINDOW_S = float(os.environ.get("HISTORY_WINDOW_S", "600"))
HISTORY_INTERVAL_S = float(os.environ.get("HISTORY_INTERVAL_S", "5.0"))


# --------------------------------------------------------------- query parse


def query_int(request, name: str, default: int, *, minimum: int = 0,
              maximum: Optional[int] = None) -> int:
    """Parse an integer query parameter uniformly across every
    ``/debug/*`` endpoint (all three servers): absent/empty → default;
    non-integer or out of range → 400 with the repo's JSON error body
    (``{"error": {"type", "message"}, "request_id"}``) and the
    ``X-Request-ID`` header, matching the error contract of the work
    endpoints instead of a bare-text 400."""
    raw = request.query.get(name, "")
    if raw == "":
        return default
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise _bad_query(request, name, raw, "must be an integer")
    if value < minimum:
        raise _bad_query(request, name, raw, f"must be >= {minimum}")
    if maximum is not None and value > maximum:
        raise _bad_query(request, name, raw, f"must be <= {maximum}")
    return value


def _bad_query(request, name: str, raw: str, why: str):
    from aiohttp import web

    from .flight import adopt_request_id

    rid = adopt_request_id(request.headers)
    body = {"error": {"type": "bad_query",
                      "message": f"query parameter {name}={raw!r} {why}"},
            "request_id": rid}
    return web.HTTPBadRequest(text=json.dumps(body),
                              content_type="application/json",
                              headers={"X-Request-ID": rid})


# ------------------------------------------------------------------ sampler


class MetricHistory:
    """Fixed-interval ring of registry snapshots with windowed
    aggregation.

    ``interval_s <= 0`` builds a permanently-disabled history: ``start``
    is a no-op, ``enabled`` is False, queries answer
    ``{"enabled": false}`` — the parity-pinned inert configuration.
    """

    def __init__(self, registry: obs_metrics.Registry = obs_metrics.REGISTRY,
                 window_s: float = None, interval_s: float = None,
                 pre_sample: Sequence[Callable[[], None]] = ()):
        self.registry = registry
        self.window_s = HISTORY_WINDOW_S if window_s is None else \
            float(window_s)
        self.interval_s = HISTORY_INTERVAL_S if interval_s is None else \
            float(interval_s)
        #: hooks run before each snapshot (mirror engine stats, process
        #: stats) so history carries them even between /metrics scrapes.
        self.pre_sample = list(pre_sample)
        #: called with this history after every sample — the alert
        #: engine's tick point.
        self.on_sample: list[Callable[["MetricHistory"], None]] = []
        from collections import deque
        cap = 2
        if self.enabled:
            cap = max(2, int(self.window_s / self.interval_s) + 1)
        self._ring: "deque[tuple[float, float, dict[str, float]]]" = \
            deque(maxlen=cap)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    @property
    def samples(self) -> int:
        return len(self._ring)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Spawn the sampler thread. A no-op when disabled (the inert
        pin: HISTORY_INTERVAL_S=0 must start NO thread) or already
        running."""
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metric-history")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _loop(self) -> None:
        # Sample immediately so short-lived processes still leave a
        # first snapshot, then on the interval.
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — sampling must never die
                logger.debug("history sample failed", exc_info=True)
            self._stop.wait(self.interval_s)

    # ------------------------------------------------------------- sampling

    def sample_once(self) -> dict[str, float]:
        """Take one snapshot now (also the deterministic tick tests and
        the bench overhead arm drive). Runs pre_sample hooks, appends
        the immutable sample under the ring lock, then notifies
        on_sample subscribers OUTSIDE the lock."""
        for hook in self.pre_sample:
            try:
                hook()
            except Exception:  # noqa: BLE001
                logger.debug("history pre_sample hook failed",
                             exc_info=True)
        values = self.registry.snapshot()
        sample = (time.time(), time.monotonic(), values)
        with self._lock:
            self._ring.append(sample)
        for cb in list(self.on_sample):
            try:
                cb(self)
            except Exception:  # noqa: BLE001
                logger.debug("history on_sample subscriber failed",
                             exc_info=True)
        return values

    def window(self, window_s: Optional[float] = None
               ) -> list[tuple[float, float, dict[str, float]]]:
        """Samples within the trailing ``window_s`` (default: the whole
        ring), oldest first. Samples are immutable — callers may hold
        them without copying."""
        with self._lock:
            samples = list(self._ring)
        if window_s is None or not samples:
            return samples
        horizon = samples[-1][1] - float(window_s)
        return [s for s in samples if s[1] >= horizon]

    # ---------------------------------------------------------- aggregation

    def _kind(self, key: str, kinds: dict[str, str]) -> str:
        """counter vs gauge for one snapshot key. Labeled keys carry the
        base name before ``{``; histogram samples surface as
        ``_count``/``_sum`` — both cumulative, i.e. counter-like."""
        base = key.split("{", 1)[0]
        kind = kinds.get(base)
        if kind is not None:
            return kind
        for suffix in ("_count", "_sum"):
            if base.endswith(suffix) and \
                    kinds.get(base[: -len(suffix)]) == "histogram":
                return "counter"
        return "gauge"

    def query(self, metrics: str = "", window_s: Optional[float] = None
              ) -> dict:
        """Windowed aggregates per series: last/min/max/avg for every
        matching key; counters (and histogram _count/_sum samples)
        additionally ``delta`` (reset-aware) and ``rate_per_s``."""
        if not self.enabled:
            return {"enabled": False, "interval_s": self.interval_s,
                    "window_s": self.window_s, "samples": 0, "span_s": 0.0,
                    "series": {}}
        samples = self.window(window_s)
        out = {"enabled": True, "interval_s": self.interval_s,
               "window_s": self.window_s, "samples": len(samples),
               "span_s": round(samples[-1][1] - samples[0][1], 3)
               if len(samples) >= 2 else 0.0,
               "series": {}}
        if not samples:
            return out
        kinds = self.registry.kinds()
        keys = set()
        for _, _, values in samples:
            keys.update(values)
        if metrics:
            keys = {k for k in keys if fnmatch.fnmatchcase(k, metrics)
                    or fnmatch.fnmatchcase(k.split("{", 1)[0], metrics)}
        span = out["span_s"]
        for key in sorted(keys):
            points = [(mono, values[key]) for _, mono, values in samples
                      if key in values]
            if not points:
                continue
            vals = [v for _, v in points]
            entry = {"kind": self._kind(key, kinds),
                     "points": len(points),
                     "last": vals[-1],
                     "min": min(vals), "max": max(vals),
                     "avg": round(sum(vals) / len(vals), 6)}
            if entry["kind"] == "counter":
                # Reset-aware delta: a process restart drops the
                # cumulative value; count only forward movement.
                delta = sum(max(0.0, b - a)
                            for a, b in zip(vals, vals[1:]))
                entry["delta"] = round(delta, 6)
                entry["rate_per_s"] = round(delta / span, 6) if span > 0 \
                    else 0.0
            out["series"][key] = entry
        return out

    def raw(self, window_s: Optional[float] = None,
            metrics: str = "") -> list[dict]:
        """The window itself — wall-clock stamped samples for the
        incident bundle (values optionally glob-filtered to keep
        bundles bounded)."""
        rows = []
        for wall, mono, values in self.window(window_s):
            if metrics:
                values = {k: v for k, v in values.items()
                          if fnmatch.fnmatchcase(k, metrics)
                          or fnmatch.fnmatchcase(k.split("{", 1)[0],
                                                 metrics)}
            rows.append({"t": round(wall, 3), "mono": round(mono, 3),
                         "values": values})
        return rows


# ------------------------------------------------------------ HTTP handler


def debug_history_response(request, history: Optional[MetricHistory]):
    """Shared ``GET /debug/history`` body for all three servers:
    ``?metrics=<glob>`` filters series, ``?window=<s>`` trims the
    aggregation window (default: the whole ring)."""
    from aiohttp import web

    if history is None:
        return web.json_response({"enabled": False, "series": {},
                                  "samples": 0})
    window = query_int(request, "window", 0, minimum=0)
    metrics_glob = request.query.get("metrics", "")
    return web.json_response(
        history.query(metrics=metrics_glob,
                      window_s=float(window) if window else None))
