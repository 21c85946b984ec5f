"""Declarative alerting over the in-process metric history — a copy of
the reference package's ``obs/alerts.py``.

An ``AlertRule`` is data, not code: a metric glob, a windowed aggregate
(``last``/``min``/``max``/``avg``/``delta``/``rate``), a comparison, and
a ``for_s`` debounce — evaluated by the ``AlertEngine`` against
``MetricHistory`` (obs/history.py) every sample tick. Each rule runs a
pending→firing→resolved state machine:

- ``ok``: the expression holds for no matching series;
- ``pending``: breached, but not yet continuously for ``for_s``;
- ``firing``: breached for at least ``for_s`` — the transition that
  publishes ``alerts_firing{rule=}`` = 1, logs a structured
  ``alert_firing`` event, and triggers incident capture
  (obs/incidents.py) exactly once per firing episode;
- ``resolved``: the breach cleared while firing — gauge drops to 0,
  ``alert_resolved`` is logged, and the state returns to ``ok`` (a
  later breach starts a NEW episode and may capture again).

Default rules cover the signals the docs already call alert-worthy:
SLO burn rate (``router_slo_attainment``), scheduler cost-model drift
(``sched_cost_drift_ratio``), engine watchdog stalls, breaker flapping
(``breaker_trips_total`` rate), KV restore corruption, heartbeat
staleness, and shed rate. Thresholds/windows are env-tunable
(``ALERT_<RULE>_*`` knobs); rule sets are scoped
per server tier so a router never evaluates engine-local rules and vice
versa.

Every transition increments ``alerts_total{rule=,state=}``; the live
per-rule state is ``alerts_firing{rule=}`` (1 only while firing). Both
are registry-level metrics.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

from ..utils.logging import get_logger, log_event
from . import metrics as obs_metrics
from .history import MetricHistory

logger = get_logger(__name__)

_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

#: aggregate name -> key into a history series entry. ``delta``/``rate``
#: are only published for counter-kind series by history.query; for
#: gauges that mirror cumulative engine counters (the engine-stats
#: mirror) the engine computes them from the raw points instead.
_AGGS = ("last", "min", "max", "avg", "delta", "rate")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule: ``agg(metric glob over window_s) op
    threshold``, debounced by ``for_s``."""

    name: str
    metric: str                 # snapshot-key glob (labels included)
    agg: str                    # one of _AGGS
    op: str                     # one of _OPS
    threshold: float
    window_s: float = 120.0     # aggregation window within the history
    for_s: float = 0.0          # continuous-breach debounce
    severity: str = "warning"   # "warning" | "critical"
    summary: str = ""           # one-line operator description

    def __post_init__(self) -> None:
        if self.agg not in _AGGS:
            raise ValueError(f"rule {self.name}: unknown agg {self.agg!r}")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name}: unknown op {self.op!r}")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def default_rules(server: str = "chain") -> tuple[AlertRule, ...]:
    """The shipped rule set for one server tier. Read from env on every
    call so deployments (and tests) tune thresholds without code.

    ``server``: "chain" / "model" get the engine-local rules; "router"
    gets the fleet rules. Shed rate is meaningful on every tier.
    """
    engine_rules = (
        AlertRule(
            "engine_watchdog_stall", "engine_watchdog_stalls", "delta",
            ">", _env_f("ALERT_WATCHDOG_THRESHOLD", 0.0),
            window_s=_env_f("ALERT_WATCHDOG_WINDOW_S", 120.0),
            for_s=_env_f("ALERT_WATCHDOG_FOR_S", 0.0),
            severity="critical",
            summary="engine serve loop stalled (watchdog fired) within "
                    "the window"),
        AlertRule(
            "kv_restore_corrupt", "engine_kv_restore_corrupt", "delta",
            ">", 0.0,
            window_s=_env_f("ALERT_KV_CORRUPT_WINDOW_S", 300.0),
            severity="critical",
            summary="KV-tier restore rejected corrupt page payload(s) — "
                    "data-integrity signal, never expected in steady "
                    "state"),
        AlertRule(
            "sched_cost_drift", "engine_sched_cost_drift_ratio", "avg",
            ">", _env_f("ALERT_DRIFT_RATIO_MAX", 1.5),
            window_s=_env_f("ALERT_DRIFT_WINDOW_S", 300.0),
            for_s=_env_f("ALERT_DRIFT_FOR_S", 30.0),
            summary="rounds run slower than the scheduler's cost model "
                    "predicts (drift ratio high) — stale prior or "
                    "device regression"),
    )
    fleet_rules = (
        AlertRule(
            "slo_burn_rate", "router_slo_attainment*", "avg",
            "<", _env_f("ALERT_SLO_ATTAINMENT_MIN", 0.9),
            window_s=_env_f("ALERT_SLO_WINDOW_S", 300.0),
            for_s=_env_f("ALERT_SLO_FOR_S", 10.0),
            severity="critical",
            summary="a replica's rolling SLO attainment burned below "
                    "target over the window"),
        AlertRule(
            "heartbeat_stale", "router_heartbeat_age_seconds*", "last",
            ">", _env_f("ALERT_HEARTBEAT_MAX_AGE_S", 30.0),
            window_s=_env_f("ALERT_HEARTBEAT_WINDOW_S", 60.0),
            severity="critical",
            summary="a replica's last successful heartbeat is older "
                    "than the staleness budget"),
    )
    shared_rules = (
        AlertRule(
            "breaker_flap", "breaker_trips_total*", "rate",
            ">", _env_f("ALERT_BREAKER_FLAP_RATE", 0.1),
            window_s=_env_f("ALERT_BREAKER_WINDOW_S", 300.0),
            summary="a circuit breaker is flapping (trips/s over the "
                    "window above budget)"),
        AlertRule(
            "shed_rate", "shed_total*", "rate",
            ">", _env_f("ALERT_SHED_RATE", 1.0),
            window_s=_env_f("ALERT_SHED_WINDOW_S", 120.0),
            for_s=_env_f("ALERT_SHED_FOR_S", 10.0),
            summary="sustained load shedding (sheds/s over the window "
                    "above budget)"),
    )
    if server == "router":
        return fleet_rules + shared_rules
    return engine_rules + shared_rules


class _RuleState:
    __slots__ = ("state", "since", "breach_since", "fired_at",
                 "resolved_at", "evidence", "episodes")

    def __init__(self) -> None:
        self.state = "ok"
        self.since = time.time()
        self.breach_since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.evidence: dict = {}
        self.episodes = 0


class AlertEngine:
    """Evaluates rules against a MetricHistory on every tick.

    ``on_fire(rule, record)`` is called exactly once per firing episode
    (on the transition INTO firing, never while it stays firing) — the
    incident black-box's trigger.
    """

    def __init__(self, history: MetricHistory,
                 rules: Optional[tuple[AlertRule, ...]] = None,
                 registry: obs_metrics.Registry = obs_metrics.REGISTRY,
                 on_fire: Optional[Callable[[AlertRule, dict], None]] = None,
                 server: str = "chain"):
        self.history = history
        self.rules = tuple(rules if rules is not None
                           else default_rules(server))
        self.registry = registry
        self.on_fire = on_fire
        self.server = server
        self._states = {r.name: _RuleState() for r in self.rules}
        self._firing_gauge = registry.gauge(
            "alerts_firing",
            "1 while the named alert rule is firing, else 0",
            labelnames=("rule",))
        self._total = registry.counter(
            "alerts_total",
            "alert rule state transitions, by rule and entered state",
            labelnames=("rule", "state"))
        self.ticks = 0

    # ------------------------------------------------------------ evaluate

    def _evaluate(self, rule: AlertRule) -> Optional[dict]:
        """Evidence dict when the rule's expression is breached by any
        matching series, else None."""
        q = self.history.query(metrics=rule.metric, window_s=rule.window_s)
        if not q.get("series"):
            return None
        op = _OPS[rule.op]
        breached = {}
        for key, entry in q["series"].items():
            value = self._agg_value(rule, entry)
            if value is None:
                continue
            if op(float(value), rule.threshold):
                breached[key] = {"value": value, "aggregates": entry}
        if not breached:
            return None
        return {"metric": rule.metric, "agg": rule.agg, "op": rule.op,
                "threshold": rule.threshold, "window_s": rule.window_s,
                "samples": q["samples"], "span_s": q["span_s"],
                "series": breached}

    def _agg_value(self, rule: AlertRule, entry: dict) -> Optional[float]:
        if rule.agg in ("last", "min", "max", "avg"):
            return entry.get(rule.agg)
        # delta/rate: history publishes them for counter-kind series;
        # for gauges mirroring cumulative engine counters (the
        # engine-stats mirror) derive the same reset-aware numbers here.
        if rule.agg == "delta":
            return entry.get("delta", max(0.0, entry["last"] - entry["min"])
                             if entry.get("points", 0) >= 2 else None)
        if rule.agg == "rate":
            if "rate_per_s" in entry:
                return entry["rate_per_s"]
            if entry.get("points", 0) >= 2:
                span = self.history.query(
                    metrics=rule.metric,
                    window_s=rule.window_s).get("span_s") or 0.0
                delta = max(0.0, entry["last"] - entry["min"])
                return delta / span if span > 0 else None
        return None

    # ---------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> list[dict]:
        """Evaluate every rule once; returns the transition records
        emitted this tick. Called from the history sampler thread (one
        subscriber via ``attach``) or directly by tests/preflight."""
        now = time.time() if now is None else now
        self.ticks += 1
        transitions: list[dict] = []
        for rule in self.rules:
            st = self._states[rule.name]
            evidence = self._evaluate(rule)
            if evidence is not None:
                st.evidence = evidence
                if st.state == "ok":
                    st.breach_since = now
                    if now - st.breach_since >= rule.for_s:
                        transitions.append(self._transition(
                            rule, st, "firing", now))
                    else:
                        transitions.append(self._transition(
                            rule, st, "pending", now))
                elif st.state == "pending":
                    if now - (st.breach_since or now) >= rule.for_s:
                        transitions.append(self._transition(
                            rule, st, "firing", now))
            else:
                if st.state == "firing":
                    transitions.append(self._transition(
                        rule, st, "resolved", now))
                elif st.state == "pending":
                    st.state = "ok"
                    st.since = now
                    st.breach_since = None
        return transitions

    def _transition(self, rule: AlertRule, st: _RuleState,
                    state: str, now: float) -> dict:
        prev = st.state
        st.state = "ok" if state == "resolved" else state
        st.since = now
        if state == "firing":
            st.fired_at = now
            st.episodes += 1
            self._firing_gauge.labels(rule.name).set(1.0)
        elif state == "resolved":
            st.resolved_at = now
            st.breach_since = None
            self._firing_gauge.labels(rule.name).set(0.0)
        self._total.labels(rule.name, state).inc()
        record = {"rule": rule.name, "state": state, "prev": prev,
                  "t": now, "severity": rule.severity,
                  "summary": rule.summary,
                  "for_s": rule.for_s,
                  "evidence": st.evidence if state != "resolved" else {}}
        log_event(logger, f"alert_{state}", rule=rule.name, prev=prev,
                  severity=rule.severity, summary=rule.summary,
                  evidence=record["evidence"])
        if state == "firing" and self.on_fire is not None:
            try:
                self.on_fire(rule, record)
            except Exception:  # noqa: BLE001 — capture must not kill ticks
                logger.warning("alert on_fire handler failed",
                               exc_info=True)
        return record

    # ------------------------------------------------------------ plumbing

    def attach(self) -> "AlertEngine":
        """Subscribe to the history sampler: one tick per sample. The
        inert pin holds transitively — a disabled history never
        samples, so an attached engine never ticks."""
        self.history.on_sample.append(lambda _h: self.tick())
        return self

    def snapshot(self) -> dict:
        """The /debug/alerts body: per-rule spec + live state, firing
        list first-class for dashboards."""
        rules = []
        firing = []
        for rule in self.rules:
            st = self._states[rule.name]
            row = {"rule": rule.name, "state": st.state,
                   "severity": rule.severity, "summary": rule.summary,
                   "metric": rule.metric, "agg": rule.agg, "op": rule.op,
                   "threshold": rule.threshold,
                   "window_s": rule.window_s, "for_s": rule.for_s,
                   "since": round(st.since, 3),
                   "episodes": st.episodes,
                   "evidence": st.evidence if st.state in
                   ("pending", "firing") else {}}
            rules.append(row)
            if st.state == "firing":
                firing.append(rule.name)
        return {"enabled": self.history.enabled, "server": self.server,
                "ticks": self.ticks, "rules": rules, "firing": firing}

    def firing(self) -> list[str]:
        return [name for name, st in self._states.items()
                if st.state == "firing"]


def debug_alerts_response(request, engine: Optional[AlertEngine]):
    """Shared ``GET /debug/alerts`` body for all three servers."""
    from aiohttp import web

    if engine is None:
        return web.json_response({"enabled": False, "rules": [],
                                  "firing": []})
    return web.json_response(engine.snapshot())
