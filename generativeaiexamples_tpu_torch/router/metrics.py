"""The fleet router's metric surface — one canonical table.

Every metric the router publishes is declared here, name -> (kind,
labelnames, help). ``docs/observability.md`` documents the same set in a
table fenced by ``<!-- router-metrics:begin/end -->`` and
``tools/check_metrics_docs.py`` enforces the two directions (a rename
here orphans the docs loudly; a new gauge can't ship undocumented) —
the same contract the engine gauge table has.

The registry is the process-wide one from ``obs/metrics.py``: when the
router runs in its own process these are simply its ``/metrics``; when
tests or the fleet bench run router + N replicas in ONE process, the
``router_*`` prefix keeps them distinct from the replicas' chain/engine
metrics, and the replica-labeled children tell the replicas apart.
"""

from __future__ import annotations

from ..obs import metrics as obs_metrics

#: name -> (kind, labelnames, help). The checker keys off the names; the
#: accessors below key off the whole row, so the two can never drift.
ROUTER_METRICS: dict[str, tuple[str, tuple[str, ...], str]] = {
    "router_replicas_healthy": (
        "gauge", (),
        "replicas currently placeable: reachable, not draining, breaker "
        "not open"),
    "router_replicas_total": (
        "gauge", (), "replicas in the table, placeable or not"),
    "router_placed_total": (
        "counter", ("replica",),
        "requests placed on each replica (post-retry final placement)"),
    "router_affinity_hits": (
        "counter", (),
        "placements whose chosen replica matched >= 1 prefix block in "
        "its affinity sketch"),
    "router_retries_total": (
        "counter", ("reason",),
        "forward attempts abandoned and retried on another replica, by "
        "reason: connect (connect-phase failure), draining (replica "
        "429'd as draining), breaker_open (placement raced a breaker "
        "trip)"),
    "router_drain_in_flight": (
        "gauge", (),
        "in-flight streams still running on DRAINING replicas, summed "
        "from heartbeats — a rollout waits for this to reach 0"),
    "router_kv_transfer_hints_total": (
        "counter", (),
        "placements forwarded with an X-KV-Transfer-From donor hint: "
        "the chosen replica missed the prompt's prefix but a sibling's "
        "affinity sketch covers it, so the replica fetches the prefix "
        "pages from the sibling instead of re-prefilling "
        "(docs/kv-tiering.md)"),
    "router_replica_queue_depth": (
        "gauge", ("replica",),
        "per-replica queued engine work from the last heartbeat: "
        "admission intake + scheduler backlog + in-flight device "
        "rounds — the congestion signal placement penalizes and the "
        "autoscaler's queue trigger reads"),
    "router_replica_in_flight": (
        "gauge", ("replica",),
        "per-replica in-flight /generate streams from the last "
        "heartbeat"),
    "router_replica_rejected_total": (
        "gauge", ("replica",),
        "per-replica cumulative engine admission rejections "
        "(queue-full + deadline queue drops) from the last heartbeat — "
        "the router diffs consecutive heartbeats into a recent shed "
        "rate for the load score"),
    "router_replica_prefix_hit_rate": (
        "gauge", ("replica",),
        "per-replica engine prefix-cache hit rate from the last "
        "heartbeat — fleet-wide cache health at a glance"),
    "router_heartbeat_failures_total": (
        "counter", ("replica",),
        "heartbeat probes that failed to get any HTTP answer from each "
        "replica — a climbing counter is the poller seeing a partition "
        "or a dead pod BEFORE placements go wrong"),
    "router_heartbeat_age_seconds": (
        "gauge", ("replica",),
        "seconds since each replica's last heartbeat observation, "
        "refreshed at scrape time and by the fleet refresh — a value "
        "far above ROUTER_HEARTBEAT_S means the poller itself has "
        "stalled, which silent breaker flips would otherwise hide"),
    "router_requests_total": (
        "counter", ("outcome",),
        "router-observed request outcomes: ok (stream completed), shed "
        "(backpressure relayed/originated), error (5xx/post-connect), "
        "connect_fail (one connect attempt failed; per attempt), "
        "midstream_loss (replica died on a 200), disconnect (caller "
        "hung up)"),
    "router_ttft_seconds": (
        "histogram", (),
        "router-observed time to first upstream body byte per routed "
        "request — the fleet-edge TTFT distribution, measured at the "
        "router, not replica self-reports"),
    "router_slo_attainment": (
        "gauge", ("replica",),
        "per-replica SLO attainment over the rolling ROUTER_SLO_WINDOW_S "
        "outcome window: requests that completed ok within their "
        "X-Deadline-Ms (or beat ROUTER_SLO_TTFT_MS when no deadline) "
        "over all router-observed outcomes placed there"),
    "router_window_shed_rate": (
        "gauge", ("replica",),
        "windowed fraction of each replica's router-observed outcomes "
        "that were backpressure sheds (429/503 relays)"),
    "router_window_error_rate": (
        "gauge", ("replica",),
        "windowed fraction of each replica's router-observed outcomes "
        "that were errors or failed connect attempts (caller "
        "disconnects excluded — they say nothing about the replica)"),
    "router_window_midstream_loss_rate": (
        "gauge", ("replica",),
        "windowed fraction of each replica's router-observed outcomes "
        "that were mid-stream losses (error frame appended to a 200)"),
    "router_fleet_headroom_tokens_per_sec": (
        "gauge", (),
        "fleet capacity-headroom estimate from the last fleet refresh: "
        "summed modeled decode capacity (per-replica step-cost model "
        "from the heartbeat) minus observed round-telemetry throughput "
        "— the number an SLO-driven autoscaler scales on "
        "(GET /debug/fleet carries the per-replica breakdown)"),
    "router_autoscale_target_replicas": (
        "gauge", (),
        "the autoscale controller's current replica target — what the "
        "last control cycle decided the fleet should be, whether or not "
        "an executor has finished converging it (GET /debug/autoscale "
        "carries the decision ring with full evidence)"),
    "router_autoscale_decisions_total": (
        "counter", ("action",),
        "autoscale control cycles by decided action: scale_up, "
        "scale_down, hold, surge_on, surge_off, blocked (cooldown / "
        "not leader / no executor / no drain candidate) — "
        "docs/autoscaling.md has the control law"),
    "router_surge_queue_depth": (
        "gauge", (),
        "requests currently waiting in the router's surge-admission "
        "queue — nonzero only while the fleet is at max_replicas and "
        "overloaded; sustained depth near ROUTER_SURGE_QUEUE_CAP means "
        "the fleet ceiling itself is too low"),
    "router_replicas_role": (
        "gauge", ("role",),
        "replicas in the table by disaggregation role (unified / "
        "prefill / decode) as last heartbeat-advertised — a role-less "
        "fleet reads all-unified (docs/disaggregation.md)"),
    "router_disagg_handoffs_total": (
        "counter", (),
        "long prompts served through the two-leg disaggregated "
        "prefill/decode handoff: prefill-role replica ran the prompt "
        "and pushed its finished prefix pages to the chosen decode "
        "replica, which then admitted the request as a near-full "
        "prefix-cache hit (docs/disaggregation.md)"),
    "router_disagg_fallbacks_total": (
        "counter", ("reason",),
        "disaggregation handoffs abandoned in favor of normal in-place "
        "placement, by reason: prefill_error (leg-1 POST failed or "
        "non-200), prefill_timeout (leg-1 exceeded "
        "ROUTER_DISAGG_PREFILL_TIMEOUT_S), no_pages (prefill replica "
        "exported nothing) — each one served correctly via recompute, "
        "just without the TTFT win"),
    "router_resume_total": (
        "counter", ("outcome",),
        "mid-stream failover resumes attempted after a replica died on "
        "a 200, by outcome: ok (sibling continued the stream; the "
        "caller never saw an error frame), no_replica (no placeable "
        "sibling), rejected (sibling answered non-200), connect_fail "
        "(sibling unreachable), overflow (transcript exceeded "
        "ROUTER_TRANSCRIPT_MAX_BYTES so replay was off), "
        "budget_exhausted (ROUTER_RESUME_ATTEMPTS already spent) — "
        "every non-ok outcome falls back to the classic replica_lost "
        "error frame (docs/robustness.md)"),
    "router_resume_replay_tokens": (
        "gauge", (),
        "replayed generated-so-far tokens admitted by the sibling on "
        "the most recent successful resume (from its X-Resume-Replayed "
        "header) — how much completed work the failover preserved "
        "instead of re-billing the client for"),
}


def _get(name: str):
    kind, labelnames, help_txt = ROUTER_METRICS[name]
    reg = obs_metrics.REGISTRY
    if kind == "histogram":
        return reg.histogram(name, help_txt,
                             buckets=obs_metrics.STAGE_BUCKETS,
                             labelnames=labelnames)
    factory = reg.counter if kind == "counter" else reg.gauge
    return factory(name, help_txt, labelnames=labelnames)


def counter(name: str, *labels: str):
    m = _get(name)
    return m.labels(*labels) if labels else m


def gauge(name: str, *labels: str):
    m = _get(name)
    return m.labels(*labels) if labels else m


def histogram(name: str, *labels: str):
    m = _get(name)
    return m.labels(*labels) if labels else m


def record_replica_load(name: str, load: dict) -> None:
    """Mirror one replica's heartbeat ``load`` block into the
    replica-labeled gauges (obs/metrics stays scrape-shaped: the router
    polls, the gauges hold the last observation)."""
    if "queue_depth" in load:
        gauge("router_replica_queue_depth", name).set(
            float(load["queue_depth"]))
    if "in_flight" in load:
        gauge("router_replica_in_flight", name).set(
            float(load["in_flight"]))
    if "rejected_total" in load:
        gauge("router_replica_rejected_total", name).set(
            float(load["rejected_total"]))
    if "prefix_hit_rate" in load:
        gauge("router_replica_prefix_hit_rate", name).set(
            float(load["prefix_hit_rate"]))
