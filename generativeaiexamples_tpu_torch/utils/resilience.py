"""Resilience primitives: circuit breakers and bounded retry (a copy of the
reference package's ``utils/resilience.py``; the gauges and counters go to
this package's ``obs/metrics.py`` registry).

The reference stack leaned on Triton's ready-polling and LangChain's
broad ``except`` blocks; this framework makes failure handling explicit:

- :class:`CircuitBreaker` — the classic closed → open → half-open state
  machine. Wraps a dependency (vector store, embedder, the engine edge);
  after ``failure_threshold`` consecutive failures the breaker OPENS and
  every call fails fast with :class:`~.errors.BreakerOpenError` until
  ``cooldown_s`` elapses, at which point ONE probe call is let through
  (half-open): success re-closes, failure re-opens. Callers catch
  ``BreakerOpenError`` to take their degradation path (e.g. ``rag_chain``
  falling back to ``llm_chain``) instead of stalling on a dead backend.

- :func:`retry_call` — bounded retry with exponential backoff and full
  jitter for idempotent operations (HTTP connects whose first byte never
  arrived: request IDs make the replay idempotent at the flight
  recorder). Gives up after the attempt budget, re-raising the last
  failure.

Every breaker registers itself in a process-wide table so ``/metrics``
can publish ``breaker_state{name=...}`` (0 closed / 1 half-open /
2 open) and ``breaker_trips_total{name=...}`` without the serving code
threading breaker handles around — gauges update on state transitions,
never on the per-call fast path.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type

from .errors import BreakerOpenError
from .logging import get_logger

logger = get_logger(__name__)

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _metrics():
    # Late import: utils must stay importable before obs (and without it
    # in stripped-down tools).
    from ..obs import metrics as obs_metrics
    return obs_metrics.REGISTRY


class CircuitBreaker:
    """Closed/open/half-open breaker over consecutive failure counts.

    Thread-safe; the lock is held only for the state bookkeeping, never
    across the protected call itself.
    """

    def __init__(self, name: str, failure_threshold: int = 5,
                 cooldown_s: float = 15.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trips = 0  # cumulative open transitions
        self._publish()

    # ------------------------------------------------------------- state

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def retry_after_s(self) -> float:
        """Seconds until the next probe is allowed (0 when not open)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._opened_at + self.cooldown_s
                       - self._clock())

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = HALF_OPEN
            self._probe_inflight = False
            self._publish()

    def _publish(self) -> None:
        try:
            _metrics().gauge(
                "breaker_state",
                "circuit breaker state (0 closed, 1 half-open, 2 open)",
                labelnames=("name",)).labels(self.name).set(
                    _STATE_CODE[self._state])
        except Exception:  # noqa: BLE001 — metrics must never break serving
            pass

    # ------------------------------------------------------------- calls

    def allow(self) -> bool:
        """May a call proceed right now? Half-open admits exactly one
        probe at a time; callers that use ``allow()`` directly MUST
        report the outcome via record_success/record_failure."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            changed = self._state != CLOSED
            self._state = CLOSED
            self._failures = 0
            self._probe_inflight = False
            if changed:
                self._publish()
                logger.info("breaker %s closed", self.name)

    def release_probe(self) -> None:
        """Walk back an ``allow()`` WITHOUT recording an outcome: the
        admitted call never actually probed the dependency (shed at
        admission, cancelled by the client, failed upstream of it).
        State and failure counts are untouched — a half-open breaker
        goes back to waiting for a real probe instead of being wedged
        (probe lost) or wrongly re-closed (fake success)."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probe_inflight = False
            if (self._state == HALF_OPEN
                    or self._failures >= self.failure_threshold):
                if self._state != OPEN:
                    self.trips += 1
                    try:
                        _metrics().counter(
                            "breaker_trips_total",
                            "breaker closed/half-open -> open transitions",
                            labelnames=("name",)).labels(self.name).inc()
                    except Exception:  # noqa: BLE001
                        pass
                    logger.warning(
                        "breaker %s OPEN after %d consecutive failures "
                        "(cooldown %.1fs)", self.name, self._failures,
                        self.cooldown_s)
                self._state = OPEN
                self._opened_at = self._clock()
                self._publish()

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under the breaker: fail fast when open, count the
        outcome otherwise. The raised ``BreakerOpenError`` carries the
        breaker's name so degradation paths can label their fallback."""
        if not self.allow():
            raise BreakerOpenError(
                f"circuit '{self.name}' is open "
                f"(retry in {self.retry_after_s():.1f}s)", breaker=self.name,
                retry_after_s=self.retry_after_s())
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def reset(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._probe_inflight = False
            self._publish()


# Process-wide named breakers: the serving path, the chains, and the
# /metrics exporter all resolve the same instance by name.
_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def get_breaker(name: str, failure_threshold: Optional[int] = None,
                cooldown_s: Optional[float] = None) -> CircuitBreaker:
    """The process-wide breaker called ``name`` (created on first use).
    Threshold/cooldown apply only at creation; env overrides
    ``BREAKER_FAILURES`` / ``BREAKER_COOLDOWN_S`` set the defaults."""
    with _breakers_lock:
        br = _breakers.get(name)
        if br is None:
            if failure_threshold is None:
                failure_threshold = int(
                    os.environ.get("BREAKER_FAILURES", "5"))
            if cooldown_s is None:
                cooldown_s = float(
                    os.environ.get("BREAKER_COOLDOWN_S", "15"))
            br = CircuitBreaker(name, failure_threshold, cooldown_s)
            _breakers[name] = br
        return br


def reset_breakers() -> None:
    """Forget every named breaker (tests)."""
    with _breakers_lock:
        _breakers.clear()


def retry_call(fn: Callable, *, attempts: Optional[int] = None,
               base_delay: float = 0.1, max_delay: float = 2.0,
               retry_on: Tuple[Type[BaseException], ...] = (ConnectionError,),
               should_retry: Optional[Callable[[BaseException], bool]] = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Callable[[], float] = random.random,
               on_retry: Optional[Callable] = None):
    """Call ``fn()``; on an exception in ``retry_on`` (and passing the
    optional ``should_retry`` predicate — for cases type alone can't
    decide, like requests.ConnectionError covering both connect refusal
    and mid-response resets), retry with exponential backoff and FULL
    jitter (delay uniformly drawn from
    ``[0, min(max_delay, base_delay * 2**i)]`` — the AWS-architecture
    jitter that decorrelates a thundering herd). Any other exception, or
    exhausting the ``attempts`` budget, re-raises immediately.

    Only use for operations that are safe to replay — here, HTTP calls
    whose connection failed before a first byte arrived; the request ID
    carried by the replay keeps the server-side flight record coherent.
    """
    if attempts is None:
        attempts = int(os.environ.get("HTTP_RETRY_ATTEMPTS", "3"))
    attempts = max(1, int(attempts))
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as exc:  # noqa: PERF203 — retry loop by design
            if should_retry is not None and not should_retry(exc):
                raise
            last = exc
            if i == attempts - 1:
                break
            delay = min(max_delay, base_delay * (2 ** i)) * rng()
            if on_retry is not None:
                on_retry(i + 1, exc, delay)
            logger.debug("retry %d/%d after %s (sleep %.3fs)", i + 1,
                         attempts, exc, delay)
            sleep(delay)
    raise last  # type: ignore[misc]
