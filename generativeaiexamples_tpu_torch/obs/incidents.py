"""Incident black-box: freeze the joined evidence before the rings
recycle it — a copy of the reference package's ``obs/incidents.py``.

When an alert rule fires (obs/alerts.py) — or an operator POSTs
``/control/incident`` — the server captures one bounded JSON bundle
joining everything the process knows about the affected window:

- the metric-history window (obs/history.py raw samples + aggregates);
- the firing rule's evidence and the full alert state;
- the last-N flight timelines (obs/flight.py) and round records
  (obs/rounds.py) — request-ID keyed, so the bundle preserves the
  X-Request-ID trace-join across layers;
- extras per tier: the router adds its fleet snapshot, autoscale
  decision ring, and a per-replica pull of each replica's
  ``/debug/requests`` + ``/debug/rounds`` slice.

Bundles land in a count/byte-capped on-disk store under ``incidents/``
of the run directory (``utils/logging.run_dir``; atomic tmp+rename
writes; oldest evicted first), are listed at ``GET /debug/incidents``.
Capture happens
once per firing episode — a rule that STAYS firing does not re-capture
(pinned by the chaos suite); a resolved-then-refired rule starts a new
episode and captures again.

``ObservabilityStack`` is the one wiring point all three servers share:
history + alerts + incidents built together, inert as a unit when
``HISTORY_INTERVAL_S=0`` (no sampler thread, no alert ticks, no disk
writes — the store directory is not even created).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional, Sequence

from ..utils.logging import get_logger, log_event, run_dir
from . import metrics as obs_metrics
from .alerts import AlertEngine, AlertRule
from .history import MetricHistory

logger = get_logger(__name__)

BUNDLE_SCHEMA = "incident/v1"

INCIDENT_MAX_COUNT = int(os.environ.get("INCIDENT_MAX_COUNT", "20"))
INCIDENT_MAX_BYTES = int(os.environ.get("INCIDENT_MAX_BYTES",
                                        str(32 * 1024 * 1024)))
#: flight timelines / round records retained per bundle.
INCIDENT_SLICE_LIMIT = int(os.environ.get("INCIDENT_SLICE_LIMIT", "50"))


def incident_root() -> str:
    return os.path.join(run_dir(), "incidents")


class IncidentStore:
    """Count/byte-capped directory of incident bundles.

    Writes are atomic (tmp + rename) and serialized by one lock;
    eviction drops oldest-first until both caps hold. The directory is
    created lazily on the FIRST capture — an inert deployment writes
    nothing to disk, not even an empty dir."""

    def __init__(self, root: Optional[str] = None,
                 max_count: int = INCIDENT_MAX_COUNT,
                 max_bytes: int = INCIDENT_MAX_BYTES):
        self.root = root or incident_root()
        self.max_count = max_count
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._seq = 0

    # -------------------------------------------------------------- write

    def capture(self, bundle: dict) -> Optional[str]:
        """Persist one bundle; returns its path (None on IO failure —
        capture is best-effort and must never take down serving)."""
        with self._lock:
            self._seq += 1
            incident_id = bundle.get("id") or (
                f"inc-{time.strftime('%Y%m%dT%H%M%S')}-"
                f"{os.getpid()}-{self._seq}-"
                f"{bundle.get('trigger', {}).get('rule') or 'manual'}")
            bundle = dict(bundle)
            bundle["id"] = incident_id
            bundle.setdefault("schema", BUNDLE_SCHEMA)
            path = os.path.join(self.root, f"{incident_id}.json")
            tmp = path + ".tmp"
            try:
                os.makedirs(self.root, exist_ok=True)
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(bundle, fh, default=str)
                os.replace(tmp, path)
            except OSError:
                logger.warning("incident capture failed: %s", path,
                               exc_info=True)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
            self._evict()
        log_event(logger, "incident_captured", id=incident_id, path=path,
                  rule=bundle.get("trigger", {}).get("rule"),
                  bytes=os.path.getsize(path))
        return path

    def _evict(self) -> None:
        entries = self._entries()
        total = sum(e["bytes"] for e in entries)
        while entries and (len(entries) > self.max_count
                           or total > self.max_bytes):
            victim = entries.pop(0)          # oldest first
            total -= victim["bytes"]
            try:
                os.unlink(victim["path"])
            except OSError:
                pass

    # --------------------------------------------------------------- read

    def _entries(self) -> list[dict]:
        try:
            names = [n for n in os.listdir(self.root)
                     if n.endswith(".json")]
        except OSError:
            return []
        rows = []
        for name in names:
            path = os.path.join(self.root, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            rows.append({"id": name[:-5], "path": path,
                         "bytes": st.st_size, "mtime": st.st_mtime})
        rows.sort(key=lambda e: (e["mtime"], e["id"]))
        return rows

    def list(self, limit: int = 50) -> dict:
        entries = self._entries()
        for e in entries:
            # Surface the trigger without shipping whole bundles in a
            # listing: read just the header fields.
            try:
                with open(e["path"], encoding="utf-8") as fh:
                    b = json.load(fh)
                e["rule"] = b.get("trigger", {}).get("rule")
                e["kind"] = b.get("trigger", {}).get("kind")
                e["server"] = b.get("server")
                e["ts"] = b.get("ts")
            except (OSError, ValueError):
                e["rule"] = e["kind"] = e["server"] = e["ts"] = None
        entries.reverse()                    # newest first for operators
        return {"root": self.root, "count": len(entries),
                "total_bytes": sum(e["bytes"] for e in entries),
                "max_count": self.max_count, "max_bytes": self.max_bytes,
                "incidents": entries[:limit]}

    def load(self, incident_id: str) -> Optional[dict]:
        path = os.path.join(self.root, f"{incident_id}.json")
        if os.path.realpath(path).rpartition(os.sep)[0] != \
                os.path.realpath(self.root):
            return None                      # path traversal guard
        try:
            with open(path, encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None


# ------------------------------------------------------------------ bundles


def build_bundle(*, server: str, trigger: dict,
                 history: Optional[MetricHistory],
                 alerts: Optional[AlertEngine],
                 flight=None, rounds=None,
                 extras: Optional[dict] = None,
                 slice_limit: int = INCIDENT_SLICE_LIMIT) -> dict:
    """Join the local evidence into one bundle. ``flight``/``rounds``
    are recorder objects (obs/flight.py / obs/rounds.py) or None;
    ``extras`` merges tier-specific sections (fleet, autoscale,
    replicas) at the top level."""
    bundle = {
        "schema": BUNDLE_SCHEMA,
        "server": server,
        "ts": time.time(),
        "trigger": trigger,
        "alerts": alerts.snapshot() if alerts is not None else None,
        "history": {
            "aggregates": history.query() if history is not None else None,
            "window": history.raw() if history is not None else [],
        },
        "flight": flight.snapshot(limit=slice_limit)
        if flight is not None else None,
        "rounds": rounds.snapshot(limit=slice_limit)
        if rounds is not None else None,
    }
    if extras:
        bundle.update(extras)
    return bundle


# ------------------------------------------------------------------- stack


class ObservabilityStack:
    """History + alerts + incident store, wired as one unit.

    ``interval_s <= 0`` (HISTORY_INTERVAL_S=0) builds the parity-pinned
    inert stack: no sampler thread is ever started, the alert engine is
    None (zero ticks), the store is None (zero disk writes). The debug
    endpoints stay mounted and answer ``{"enabled": false}``.

    ``capture_extras`` (optional) returns tier-specific bundle sections
    at capture time; ``capture_async`` (router) replaces the default
    synchronous capture with a scheduler that may gather remote
    evidence — it receives the (rule-or-None, trigger dict).
    """

    def __init__(self, server: str,
                 pre_sample: Sequence[Callable[[], None]] = (),
                 flight=None, rounds=None,
                 rules: Optional[tuple[AlertRule, ...]] = None,
                 capture_extras: Optional[Callable[[], dict]] = None,
                 capture_async: Optional[Callable] = None,
                 registry: obs_metrics.Registry = obs_metrics.REGISTRY,
                 window_s: Optional[float] = None,
                 interval_s: Optional[float] = None):
        self.server = server
        self.flight = flight
        self.rounds = rounds
        self.capture_extras = capture_extras
        self.capture_async = capture_async
        self.history = MetricHistory(registry=registry, window_s=window_s,
                                     interval_s=interval_s,
                                     pre_sample=pre_sample)
        if self.history.enabled:
            self.store: Optional[IncidentStore] = IncidentStore()
            self.alerts: Optional[AlertEngine] = AlertEngine(
                self.history, rules=rules, registry=registry,
                on_fire=self._on_fire, server=server).attach()
        else:
            self.store = None
            self.alerts = None

    @property
    def enabled(self) -> bool:
        return self.history.enabled

    def start(self) -> None:
        self.history.start()

    def stop(self) -> None:
        self.history.stop()

    # ------------------------------------------------------------- capture

    def _on_fire(self, rule: AlertRule, record: dict) -> None:
        trigger = {"kind": "alert", "rule": rule.name,
                   "severity": rule.severity, "summary": rule.summary,
                   "state": record.get("state"),
                   "evidence": record.get("evidence", {})}
        if self.capture_async is not None:
            self.capture_async(rule, trigger)
        else:
            self.capture(trigger)

    def capture(self, trigger: dict,
                extras: Optional[dict] = None) -> Optional[str]:
        """Synchronous local capture; returns the bundle path. No-op
        (None) when inert."""
        if self.store is None:
            return None
        merged = dict(extras or {})
        if self.capture_extras is not None:
            try:
                merged.update(self.capture_extras() or {})
            except Exception:  # noqa: BLE001 — extras are best-effort
                logger.debug("incident capture_extras failed",
                             exc_info=True)
        bundle = build_bundle(server=self.server, trigger=trigger,
                              history=self.history, alerts=self.alerts,
                              flight=self.flight, rounds=self.rounds,
                              extras=merged)
        return self.store.capture(bundle)


# ------------------------------------------------------------ HTTP handlers


def debug_incidents_response(request, stack: Optional[ObservabilityStack]):
    from aiohttp import web

    from .history import query_int

    if stack is None or stack.store is None:
        return web.json_response({"enabled": False, "count": 0,
                                  "incidents": []})
    limit = query_int(request, "limit", 50, minimum=0)
    body = stack.store.list(limit=limit)
    body["enabled"] = True
    incident_id = request.query.get("id")
    if incident_id:
        bundle = stack.store.load(incident_id)
        if bundle is None:
            raise web.HTTPNotFound(
                text=json.dumps({"error": {
                    "type": "unknown_incident",
                    "message": f"no incident {incident_id!r}"}}),
                content_type="application/json")
        return web.json_response(bundle)
    return web.json_response(body)


async def control_incident_response(request,
                                    stack: Optional[ObservabilityStack]):
    """``POST /control/incident``: manual black-box capture (operator
    'freeze the evidence NOW' button). 409 when the layer is inert."""
    from aiohttp import web

    if stack is None or stack.store is None:
        raise web.HTTPConflict(
            text=json.dumps({"error": {
                "type": "incidents_disabled",
                "message": "retained telemetry is disarmed "
                           "(HISTORY_INTERVAL_S=0)"}}),
            content_type="application/json")
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001 — empty body is fine
        body = {}
    reason = str((body or {}).get("reason", "manual"))[:200]
    trigger = {"kind": "manual", "rule": None, "reason": reason,
               "state": None, "evidence": {}}
    if stack.capture_async is not None:
        stack.capture_async(None, trigger)
        return web.json_response({"status": "capturing",
                                  "kind": "manual"})
    path = stack.capture(trigger)
    if path is None:
        raise web.HTTPInternalServerError(
            text=json.dumps({"error": {
                "type": "capture_failed",
                "message": "incident bundle could not be written"}}),
            content_type="application/json")
    return web.json_response({"status": "captured", "path": path,
                              "id": os.path.basename(path)[:-5]})
