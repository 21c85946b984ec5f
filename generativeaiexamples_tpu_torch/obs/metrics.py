"""First-party metrics: counters, gauges, histograms (with labels),
TTFT/TPS request timing — a copy of the reference package's
``obs/metrics.py``, cut to what the port's servers publish.

The process-wide registry every surface publishes through: the engine's
stats mirror (``record_engine_stats``), the round-telemetry metrics
(``obs/rounds.py``), the process gauges and the HTTP request timers all
render from the one ``REGISTRY`` as Prometheus text.

Label support: a metric declared with ``labelnames`` is a parent whose
``labels(...)`` returns (and memoizes) a child per label-value tuple —
rendered as ``engine_stage_seconds_bucket{stage="prefill",le="0.05"}``.

Concurrency: every mutation takes the metric's own lock; scrapes
(``render_prometheus``/``snapshot``/``percentile``) copy histogram state
under that same lock, so a concurrent ``observe()`` never yields a
scrape whose cumulative bucket counts disagree with ``_count``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2,
                    6.4, 12.8, 30.0, 60.0)

# Tokens-per-second histograms span single-token trickles to full-batch
# device throughput; the default latency buckets top out at 60.
TPS_BUCKETS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
               512.0, 1024.0, 2048.0, 4096.0)

# Pipeline stages run sub-millisecond (loop phases) to tens of seconds
# (a cold compile); extend the default ladder downward.
STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8, 30.0)


def _escape(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format: backslash and
    newline only (quotes are legal in help text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(pairs: Sequence[tuple[str, object]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


class Counter:
    _kind = "counter"

    def __init__(self, name: str, help_txt: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_txt
        self.labelnames = tuple(labelnames)
        self._value = 0.0
        self._lock = threading.Lock()
        self._children: dict[tuple, "Counter"] = {}

    # ----------------------------------------------------------- labels

    def labels(self, *values, **kw) -> "Counter":
        """Child metric for one label-value tuple (memoized). Accepts
        positional values in ``labelnames`` order or keywords."""
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(kw.pop(n) for n in self.labelnames)
            except KeyError as exc:
                raise ValueError(
                    f"{self.name}: missing label {exc}") from None
            if kw:
                raise ValueError(
                    f"{self.name}: unknown label(s) {sorted(kw)}")
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{len(values)} value(s)")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _make_child(self) -> "Counter":
        return type(self)(self.name, self.help)

    def _check_scalar(self) -> None:
        if self.labelnames:
            raise ValueError(
                f"{self.name} is declared with labels {self.labelnames}; "
                f"use .labels(...) to get a child first")

    def _samples(self) -> list[tuple[list, "Counter"]]:
        """(label pairs, leaf metric) for rendering: the metric itself
        when unlabeled, else one row per child."""
        if not self.labelnames:
            return [([], self)]
        with self._lock:
            items = sorted(self._children.items())
        return [(list(zip(self.labelnames, key)), child)
                for key, child in items]

    # ------------------------------------------------------------ values

    def inc(self, amount: float = 1.0) -> None:
        self._check_scalar()
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge(Counter):
    _kind = "gauge"

    def set(self, value: float) -> None:
        self._check_scalar()
        with self._lock:
            self._value = value


class Histogram:
    _kind = "histogram"

    def __init__(self, name: str, help_txt: str = "",
                 buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_txt
        self.buckets = tuple(sorted(buckets))
        self.labelnames = tuple(labelnames)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()
        self._children: dict[tuple, "Histogram"] = {}

    labels = Counter.labels
    _check_scalar = Counter._check_scalar
    _samples = Counter._samples

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, self.help, self.buckets)

    def observe(self, value: float) -> None:
        self._check_scalar()
        with self._lock:
            self._sum += value
            self._total += 1
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot_state(self) -> tuple[list[int], float, int]:
        """(bucket counts, sum, total) copied atomically under the
        histogram's own lock — the only way scrapes may read state (a
        lock-free read can tear against a concurrent observe())."""
        with self._lock:
            return list(self._counts), self._sum, self._total

    def percentile(self, q: float) -> float:
        """Approximate percentile from bucket upper edges (p50/p99
        health)."""
        counts, _, total = self.snapshot_state()
        if total == 0:
            return 0.0
        target = q * total
        seen = 0
        for i, edge in enumerate(self.buckets):
            seen += counts[i]
            if seen >= target:
                return edge
        return self.buckets[-1]

    @property
    def count(self) -> int:
        return self._total

    @property
    def sum(self) -> float:
        return self._sum


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_txt: str, labelnames=(), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_txt, labelnames=tuple(labelnames), **kw)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            elif m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name} already registered with labels "
                    f"{m.labelnames}, not {tuple(labelnames)}")
            elif isinstance(m, Histogram) and "buckets" in kw \
                    and m.buckets != tuple(sorted(kw["buckets"])):
                # A silently-ignored ladder mismatch would mis-bucket
                # every later observation (e.g. TPS samples into a
                # 60s-max latency ladder, all landing in +Inf).
                raise ValueError(
                    f"histogram {name} already registered with buckets "
                    f"{m.buckets}")
            return m

    def counter(self, name: str, help_txt: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help_txt, labelnames)

    def gauge(self, name: str, help_txt: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help_txt, labelnames)

    def histogram(self, name: str, help_txt: str = "",
                  buckets: Sequence[float] = _DEFAULT_BUCKETS,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name, help_txt, labelnames,
                         buckets=buckets)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format. Histogram state is copied
        under each histogram's lock (snapshot_state), so the rendered
        cumulative buckets always agree with _count. Metrics registered
        with a help string emit a ``# HELP`` line before their
        ``# TYPE`` — the one-line description dashboards and operators
        see on the raw scrape."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m._kind}")
            if isinstance(m, Histogram):
                for pairs, leaf in m._samples():
                    counts, total_sum, total = leaf.snapshot_state()
                    cum = 0
                    for i, edge in enumerate(leaf.buckets):
                        cum += counts[i]
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(pairs + [('le', edge)])} {cum}")
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(pairs + [('le', '+Inf')])} {total}")
                    lines.append(
                        f"{m.name}_sum{_fmt_labels(pairs)} {total_sum}")
                    lines.append(
                        f"{m.name}_count{_fmt_labels(pairs)} {total}")
            else:
                for pairs, leaf in m._samples():
                    lines.append(f"{m.name}{_fmt_labels(pairs)} {leaf.value}")
        return "\n".join(lines) + "\n"

    def kinds(self) -> dict[str, str]:
        """Metric name -> kind ("counter"/"gauge"/"histogram") — how the
        history sampler (obs/history.py) decides whether a snapshot key
        aggregates as a level (gauge: last/min/max/avg) or as a
        cumulative series (counter: delta + rate)."""
        with self._lock:
            return {name: m._kind for name, m in self._metrics.items()}

    def snapshot(self) -> dict[str, float]:
        """Flat name -> value map. Labeled children key as
        ``name{label="value"}`` (and ``name_count{...}``/``name_sum{...}``
        for histograms)."""
        with self._lock:
            metrics = list(self._metrics.items())
        out: dict[str, float] = {}
        for name, m in metrics:
            for pairs, leaf in m._samples():
                suffix = _fmt_labels(pairs)
                if isinstance(m, Histogram):
                    counts, total_sum, total = leaf.snapshot_state()
                    out[f"{name}_count{suffix}"] = float(total)
                    out[f"{name}_sum{suffix}"] = total_sum
                else:
                    out[name + suffix] = leaf.value
        return out


REGISTRY = Registry()


# Per-stage children of the default registry's engine_stage_seconds,
# memoized so the engine loop's per-iteration record_stage calls cost one
# dict hit instead of two lock-guarded registry lookups.
_stage_children: dict[str, Histogram] = {}


def _stage_histogram(registry: Registry) -> Histogram:
    return registry.histogram(
        "engine_stage_seconds",
        "per-stage serving-path latency (seconds), labeled by stage",
        buckets=STAGE_BUCKETS, labelnames=("stage",))


def observe_stage(name: str, seconds: float,
                  registry: Registry = REGISTRY) -> None:
    """One pipeline-stage latency sample into the labeled
    ``engine_stage_seconds`` histogram — the scrape-side replacement for
    eyeballing cumulative-ms/count gauge pairs. Fed by
    ``obs.tracing.record_stage``, i.e. every event_span and engine stage
    hook, whether or not tracing or a stage collector is active."""
    if registry is REGISTRY:
        child = _stage_children.get(name)
        if child is None:  # benign race: both writers memoize the same child
            child = _stage_histogram(registry).labels(name)
            _stage_children[name] = child
        child.observe(seconds)
    else:
        _stage_histogram(registry).labels(name).observe(seconds)


# Engine pipeline stage counters that are cumulative-(ms, events) pairs:
# record_engine_stats derives a per-event average gauge for each so the
# scrape shows "how long does one round's readback wait" directly,
# without PromQL rate division over two engine_* gauges.
ENGINE_STAGE_AVGS = (
    ("harvest_wait_ms", "harvest_rounds"),
    ("first_readback_ms", "first_readbacks"),
)


def record_engine_stats(stats: dict, registry: Registry = REGISTRY,
                        prefix: str = "engine_") -> None:
    """Mirror an engine ``stats()`` snapshot into the registry as gauges
    (``engine_requests``, ``engine_prefix_cache_hit_tokens``,
    ``engine_prefix_cache_hit_rate``, ``engine_prefix_cache_evicted_pages``,
    ...). Scrape-time pull rather than push-per-event: the engine's hot
    paths never touch the registry lock, and /metrics always reflects
    the live counters — including the prefix-cache hit/eviction numbers
    the warm-TTFT story depends on (the model server's /metrics calls
    it at every scrape).

    The overlapped harvest/dispatch pipeline's per-stage counters flow
    through here too: ``engine_harvest_wait_ms`` / ``engine_harvest_rounds``
    (decode-round readback wait, now off the scheduling path),
    ``engine_first_readback_ms`` / ``engine_first_readbacks`` (first-token
    readback overlap), and ``engine_dispatch_queue_depth`` (device rounds
    in flight; >0 during steady decode means the device never idles on the
    host). Each (total_ms, events) pair additionally publishes an
    ``engine_<stage>_avg`` gauge (see ENGINE_STAGE_AVGS)."""
    for key, value in stats.items():
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        registry.gauge(
            prefix + key,
            f"Engine.stats mirror of {key} (see the engine stats table "
            f"in the README's port section)").set(float(value))
    for total_key, count_key in ENGINE_STAGE_AVGS:
        if stats.get(count_key):
            registry.gauge(
                prefix + total_key + "_avg",
                f"derived per-event average of engine_{total_key} over "
                f"engine_{count_key}").set(
                float(stats[total_key]) / float(stats[count_key]))


#: Process-level resource gauges published at scrape time next to the
#: engine-stats mirror (and sampled into /debug/history) — the process
#: memory/fd/thread signals.
PROCESS_METRICS: tuple[tuple[str, str], ...] = (
    ("process_rss_bytes", "resident set size of this server process "
                          "(bytes, from /proc/self/status VmRSS)"),
    ("process_open_fds", "open file descriptors held by this process"),
    ("process_threads", "live threads in this process"),
)


def _read_proc_status() -> dict[str, float]:
    out: dict[str, float] = {}
    try:
        with open("/proc/self/status", encoding="ascii",
                  errors="ignore") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    out["process_rss_bytes"] = \
                        float(line.split()[1]) * 1024.0
                elif line.startswith("Threads:"):
                    out["process_threads"] = float(line.split()[1])
    except OSError:
        pass
    return out


def record_process_stats(registry: Registry = REGISTRY) -> None:
    """Mirror process resource usage into the registry as gauges
    (PROCESS_METRICS). Pull-at-scrape like ``record_engine_stats`` —
    /metrics handlers and the history sampler call it; nothing on a
    serving path does. Linux /proc only; on other platforms the gauges
    fall back to what the stdlib can see (thread count) and 0."""
    import threading as _threading

    values = _read_proc_status()
    values.setdefault("process_threads",
                      float(_threading.active_count()))
    try:
        values["process_open_fds"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        values.setdefault("process_open_fds", 0.0)
    values.setdefault("process_rss_bytes", 0.0)
    help_by_name = dict(PROCESS_METRICS)
    for name, _ in PROCESS_METRICS:
        registry.gauge(name, help_by_name[name]).set(values[name])


class RequestTimer:
    """Per-request serving metrics: TTFT, duration, token throughput.

    Tracks time to first token and tokens/sec for any request class.
    """

    def __init__(self, name: str, registry: Registry = REGISTRY):
        self.name = name
        self.registry = registry
        self._start = time.monotonic()
        self._first: Optional[float] = None
        self._tokens = 0
        registry.counter(f"{name}_requests_total",
                         f"{name} requests started").inc()

    def token(self, n: int = 1) -> None:
        if self._first is None:
            self._first = time.monotonic()
            self.registry.histogram(
                f"{self.name}_ttft_seconds",
                f"{self.name} time to first token, seconds").observe(
                self._first - self._start)
        self._tokens += n

    def finish(self) -> None:
        dur = time.monotonic() - self._start
        self.registry.histogram(
            f"{self.name}_duration_seconds",
            f"{self.name} request duration, seconds").observe(dur)
        if self._tokens and dur > 0:
            tps = self._tokens / dur
            self.registry.counter(
                f"{self.name}_tokens_total",
                f"tokens generated by {self.name} requests").inc(
                self._tokens)
            # The histogram is the real distribution under concurrency;
            # the last-write-wins gauge stays published for dashboards
            # pinned to the old name.
            self.registry.histogram(
                f"{self.name}_tokens_per_second",
                f"per-request {self.name} token throughput distribution",
                buckets=TPS_BUCKETS).observe(tps)
            self.registry.gauge(
                f"{self.name}_last_tokens_per_second",
                f"last completed {self.name} request's tokens/sec "
                f"(legacy last-write-wins gauge; prefer the histogram)"
            ).set(tps)
