"""Typed exceptions the port raises (copied from the reference package's
``utils/errors.py``; the port imports nothing from it)."""

from __future__ import annotations


class FrameworkError(Exception):
    """Base class for all first-party errors."""


class ConfigError(FrameworkError):
    """Invalid or missing configuration."""


class ModelLoadError(FrameworkError):
    """A checkpoint could not be found, sniffed, or imported."""


class UnsupportedFormatError(ModelLoadError):
    """Checkpoint format not recognized, or not served by the port."""


class EngineError(FrameworkError):
    """Inference-engine runtime failure."""


class SchedulerFullError(EngineError):
    """No queue capacity for a new request."""


class RoleMismatchError(EngineError):
    """A request was submitted to a replica whose disaggregation role
    cannot serve it (a decode-bound request on a prefill-role engine). A
    routing error, not an engine fault: edges map it to a retryable 429,
    never a breaker trip (docs/disaggregation.md)."""


class RetrievalError(FrameworkError):
    """Vector-store failure. ``reason`` labels which dependency failed
    (``retrieval`` / ``embed``) for degradation metrics."""

    def __init__(self, *args, reason: str = "retrieval"):
        super().__init__(*args)
        self.reason = reason


class BreakerOpenError(FrameworkError):
    """A circuit breaker rejected the call without attempting it
    (utils/resilience.py). Carries the breaker's name and the cooldown
    remaining so edges can emit ``Retry-After`` and degradation paths
    can label their fallback."""

    def __init__(self, *args, breaker: str = "", retry_after_s: float = 0.0):
        super().__init__(*args)
        self.breaker = breaker
        self.retry_after_s = retry_after_s


class ChainError(FrameworkError):
    """Chain-server / example pipeline failure."""


class ShardingError(FrameworkError):
    """Invalid mesh/sharding request (e.g. TP*PP != device count;
    reference: model_server/__init__.py:103-110)."""
