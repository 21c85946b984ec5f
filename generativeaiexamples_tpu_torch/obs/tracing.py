"""OpenTelemetry tracing spine, gated by ``ENABLE_TRACING`` — a copy of
the reference package's ``obs/tracing.py``.

The server side extracts W3C traceparent from incoming request headers
and wraps handlers in spans (``instrumented``, ``server_span``); request
stages and engine rounds are replayed as child spans at completion.
OpenTelemetry is imported lazily, only once tracing is on: a machine
without the package serves with tracing off, and every helper is then a
no-op. Enablement is read per call (``enabled()``: the env, unless
``set_enabled()`` installed an override), so tests toggle it without a
reimport.
"""

from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Any, Optional

from . import metrics as _metrics

_enabled_override: Optional[bool] = None
_tracer = None


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get("ENABLE_TRACING", "").lower() in ("1", "true",
                                                            "yes")


def set_enabled(value: Optional[bool]) -> None:
    """Force tracing on/off at runtime (config-file wiring, tests);
    ``None`` restores the ``ENABLE_TRACING`` env check."""
    global _enabled_override
    _enabled_override = value


def _get_tracer():
    """Lazy tracer init (service name from ``OTEL_SERVICE_NAME``, default
    'chain-server' as in the reference; OTLP endpoint from the standard
    env var).
    Returns None whenever tracing is off — a tracer initialized by an
    earlier enablement does not leak spans after set_enabled(False)."""
    global _tracer
    if not enabled():
        return None
    if _tracer is None:
        from opentelemetry import trace
        try:
            from opentelemetry.sdk.resources import Resource
            from opentelemetry.sdk.trace import TracerProvider
            from opentelemetry.sdk.trace.export import (BatchSpanProcessor,
                                                        ConsoleSpanExporter)

            service = os.environ.get("OTEL_SERVICE_NAME", "chain-server")
            provider = TracerProvider(
                resource=Resource.create({"service.name": service}))
            endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
            if endpoint:
                try:
                    from opentelemetry.exporter.otlp.proto.grpc \
                        .trace_exporter import OTLPSpanExporter
                    provider.add_span_processor(BatchSpanProcessor(
                        OTLPSpanExporter(endpoint=endpoint)))
                except ImportError:
                    provider.add_span_processor(
                        BatchSpanProcessor(ConsoleSpanExporter()))
            trace.set_tracer_provider(provider)
        except ImportError:
            # api-only install: the global provider yields non-recording
            # spans — tracing stays wired but exports nothing.
            pass
        _tracer = trace.get_tracer("generativeaiexamples_tpu_torch")
    return _tracer


@contextmanager
def server_span(name: str, headers: Optional[dict] = None,
                attributes: Optional[dict] = None):
    """Span with remote parent extracted from W3C headers."""
    tracer = _get_tracer()
    if tracer is None:
        yield None
        return
    from opentelemetry import trace
    from opentelemetry.propagate import extract
    ctx = extract(dict(headers or {}))
    with tracer.start_as_current_span(
            name, context=ctx, kind=trace.SpanKind.SERVER,
            attributes=attributes or {}) as span:
        yield span


def inject_context(headers: Optional[dict] = None) -> dict:
    """A copy of ``headers`` with the current trace context injected as
    W3C headers (unchanged when tracing is off)."""
    headers = dict(headers or {})
    if enabled():
        from opentelemetry.propagate import inject
        inject(headers)
    return headers


def instrumented(name: str):
    """Decorator for aiohttp handlers: wraps in a server span carrying the
    request's W3C context. No-op (identity passthrough of the handler's
    own behavior) when tracing is off."""
    def deco(handler):
        @functools.wraps(handler)
        async def wrapper(request, *args: Any, **kwargs: Any):
            if not enabled():
                return await handler(request, *args, **kwargs)
            with server_span(name, headers=request.headers,
                             attributes={"http.route": str(request.rel_url)}):
                return await handler(request, *args, **kwargs)
        return wrapper
    return deco


def record_stage(name: str, seconds: float) -> None:
    """Report one stage duration to the bound request timeline (if any)
    and to the labeled ``engine_stage_seconds`` histogram, so the
    per-stage breakdown is in every scrape and in /debug/requests."""
    from .flight import record_current_stage
    record_current_stage(name, seconds)
    _metrics.observe_stage(name, seconds)


@contextmanager
def event_span(kind: str, **attributes: Any):
    """Child span for pipeline events (retrieve/embed/generate stages).
    The wall time is always reported through record_stage — stage
    histograms and flight timelines see every span site even with
    tracing off."""
    t0 = time.monotonic()
    try:
        tracer = _get_tracer()
        if tracer is None:
            yield None
            return
        clean = {k: v for k, v in attributes.items()
                 if isinstance(v, (str, int, float, bool))}
        with tracer.start_as_current_span(kind, attributes=clean) as span:
            yield span
    finally:
        record_stage(kind, time.monotonic() - t0)
