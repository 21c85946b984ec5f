"""Observability of the port: the metrics registry, the OTel tracing
spine, the per-request flight recorder, the per-round recorder, and the
retained telemetry (metric history, alerts, incident bundles) — copies of
the reference package's ``obs/`` modules, which the port does not
import."""

from . import alerts, flight, history, incidents, metrics, rounds, tracing

__all__ = ["alerts", "flight", "history", "incidents", "metrics",
           "rounds", "tracing"]
