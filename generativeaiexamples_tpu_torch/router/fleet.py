"""Fleet snapshot: the single view an autoscaler, a dashboard, or an
operator reads (``GET /debug/fleet``).

The raw signals all exist — heartbeat ``load`` blocks, each replica's
round-telemetry rolling aggregates and KV-tier counters (riding the
same heartbeat), per-replica breakers, and the router's own
rolling SLO window (router/flight.py). This module is the spine that
JOINS them: :func:`build_fleet_snapshot` folds everything the router
already holds into per-replica rows plus fleet totals and a
**capacity-headroom estimate** — modeled tokens/s remaining, derived
from the same step-cost model the open-loop goodput bench fits
(``capacity_tokens_per_sec`` in the heartbeat is the replica's
calibrated ``max_slots / decode_step_ms``; the observed load is the
round ring's wall-clock token rate), which is exactly the quantity the
ROADMAP's SLO-driven autoscale controller needs to scale BEFORE sheds
begin.

Everything is local state (the heartbeat already carried it), so
building a snapshot is cheap and always fresh; the router's background
refresh additionally publishes the window gauges and the fleet headroom
gauge once per heartbeat so ``/metrics`` stays live without scrapes of
``/debug/fleet``.

The response contract is pinned by :data:`FLEET_SCHEMA` /
:data:`FLEET_REPLICA_SCHEMA` and enforced element-wise by
:func:`validate_fleet_snapshot` — ``tools/preflight.py`` runs it over a
synthetic snapshot (proven able to fail in tier 1), and the fleet bench
sources its ``fleet_obs`` block from a validated snapshot, so a field
rename can never silently orphan a dashboard or the bench artifact.
"""

from __future__ import annotations

import time
from typing import Optional

from .flight import ROUTER_SELF, SloWindow
from .table import ReplicaTable

#: type-kind vocabulary shared with tools/check_bench_schema.py.
_TYPES = {
    "str": lambda v: isinstance(v, str),
    "num": lambda v: isinstance(v, (int, float))
    and not isinstance(v, bool),
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "bool": lambda v: isinstance(v, bool),
    "obj": lambda v: isinstance(v, dict),
    "list": lambda v: isinstance(v, list),
    "null": lambda v: v is None,
}

#: Top-level ``GET /debug/fleet`` contract: key -> allowed kinds.
FLEET_SCHEMA: dict[str, list[str]] = {
    "generated_unix_ms": ["int"],
    "heartbeat_s": ["num"],
    "window_s": ["num"],
    "slo_ttft_ms": ["num"],
    "fleet": ["obj"],
    "replicas": ["list"],
}

#: ``fleet`` totals block.
FLEET_TOTALS_SCHEMA: dict[str, list[str]] = {
    "replicas_total": ["int"],
    "replicas_placeable": ["int"],
    "in_flight": ["int"],
    "queue_depth": ["int"],
    "window_requests": ["int"],
    "slo_attainment": ["num", "null"],
    "shed_rate": ["num"],
    "error_rate": ["num"],
    "midstream_loss_rate": ["num"],
    "ttft_p50_ms": ["num", "null"],
    "tokens_per_sec": ["num"],
    "capacity_tokens_per_sec": ["num"],
    "headroom_tokens_per_sec": ["num"],
    "prefix_hit_rate": ["num", "null"],
    "kv_tier_host_pages": ["int"],
    "roles": ["obj"],
}

#: One per-replica row.
FLEET_REPLICA_SCHEMA: dict[str, list[str]] = {
    "name": ["str"],
    "url": ["str"],
    "role": ["str"],
    "placeable": ["bool"],
    "reachable": ["bool"],
    "draining": ["bool"],
    "breaker": ["str"],
    "heartbeat_age_s": ["num", "null"],
    "heartbeat_failures": ["int"],
    "placements": ["int"],
    "load": ["obj"],
    "rounds": ["obj", "null"],
    "kv_tier": ["obj", "null"],
    "capacity": ["obj", "null"],
    "slo": ["obj"],
    "tokens_per_sec": ["num"],
    "capacity_tokens_per_sec": ["num", "null"],
    "headroom_tokens_per_sec": ["num", "null"],
}

#: The per-replica ``slo`` sub-block (a SloWindow stats row minus the
#: window-global fields).
FLEET_SLO_SCHEMA: dict[str, list[str]] = {
    "requests": ["int"],
    "attained": ["int"],
    "attainment": ["num", "null"],
    "shed_rate": ["num"],
    "error_rate": ["num"],
    "midstream_loss_rate": ["num"],
    "ttft_p50_ms": ["num", "null"],
    "outcomes": ["obj"],
}

#: Router timeline contract (``GET /debug/requests`` on the router) —
#: the subset preflight pins so the join keys and TTFT field can't
#: silently rename out from under the bench/e2e tests.
ROUTER_TIMELINE_SCHEMA: dict[str, list[str]] = {
    "request_id": ["str"],
    "started_unix_ms": ["int"],
    "age_ms": ["num"],
    "done": ["bool"],
    "meta": ["obj"],
    "events": ["list"],
    "events_dropped": ["int"],
}


def _wall_tokens_per_sec(rounds: dict) -> float:
    """Observed decode load from the replica's round-telemetry block:
    tokens emitted over the WALL span of the aggregation window (the
    replica computes it; older replicas without the field fall back to
    0 — unknown load reads as full headroom, which over-scales down
    never up, the safe direction)."""
    try:
        return max(0.0, float(rounds.get("wall_tokens_per_sec", 0.0)))
    except (TypeError, ValueError):
        return 0.0


def build_fleet_snapshot(table: ReplicaTable, slo: SloWindow, *,
                         heartbeat_s: float) -> dict:
    """Assemble the ``GET /debug/fleet`` response from the table's
    heartbeat-carried state and the router's SLO window. Pure fold over
    local state — no I/O."""
    reps = table.snapshot()
    window = slo.snapshot([r["name"] for r in reps])
    total_row = window.get("_total", {})
    rows = []
    fleet_in_flight = 0
    fleet_queue = 0
    fleet_tps = 0.0
    fleet_cap = 0.0
    fleet_host_pages = 0
    hit_rates = []
    for r in reps:
        load = r.get("load") or {}
        rounds = r.get("rounds") or {}
        capacity = r.get("capacity") or {}
        tps = _wall_tokens_per_sec(rounds)
        cap = None
        headroom = None
        try:
            cap_v = capacity.get("capacity_tokens_per_sec")
            if cap_v is not None:
                cap = float(cap_v)
                headroom = round(max(0.0, cap - tps), 1)
        except (TypeError, ValueError):
            cap = None
        slo_row = dict(window.get(r["name"]) or slo._stats([]))
        rows.append({
            "name": r["name"],
            "url": r["url"],
            "role": str(r.get("role", "unified") or "unified"),
            "placeable": bool(r["placeable"]),
            "reachable": bool(r["reachable"]),
            "draining": bool(r["draining"]),
            "breaker": str(r["breaker"]),
            "heartbeat_age_s": r.get("heartbeat_age_s"),
            "heartbeat_failures": int(r.get("heartbeat_failures", 0)),
            "placements": int(r.get("placements", 0)),
            "load": load,
            "rounds": rounds or None,
            "kv_tier": (r.get("kv_tier") or None),
            "capacity": capacity or None,
            "slo": slo_row,
            "tokens_per_sec": round(tps, 1),
            "capacity_tokens_per_sec": cap,
            "headroom_tokens_per_sec": headroom,
        })
        fleet_in_flight += int(load.get("in_flight", 0) or 0)
        fleet_queue += int(load.get("queue_depth", 0) or 0)
        # Only PLACEABLE replicas count toward fleet capacity/headroom:
        # an unreachable or breaker-open replica keeps its last-seen
        # capacity block (heartbeats stopped updating it), and a
        # draining one admits nothing new — summing either would tell
        # an autoscaler there is headroom that no request can use,
        # suppressing the scale-up exactly when capacity was lost. The
        # per-replica row keeps its own numbers (state is visible
        # alongside them).
        if r["placeable"]:
            fleet_tps += tps
            fleet_cap += cap or 0.0
        kv = r.get("kv_tier") or {}
        fleet_host_pages += int(kv.get("host_pages", 0) or 0)
        if load.get("prefix_hit_rate") is not None:
            hit_rates.append(float(load["prefix_hit_rate"]))
    roles: dict[str, int] = {}
    for r in reps:
        role = str(r.get("role", "unified") or "unified")
        roles[role] = roles.get(role, 0) + 1
    fleet = {
        "replicas_total": len(reps),
        "replicas_placeable": sum(1 for r in reps if r["placeable"]),
        # Disaggregation role census (docs/disaggregation.md): how many
        # replicas advertise each role — a role-less fleet reads
        # {"unified": N}.
        "roles": roles,
        "in_flight": fleet_in_flight,
        "queue_depth": fleet_queue,
        "window_requests": int(total_row.get("requests", 0)),
        "slo_attainment": total_row.get("attainment"),
        "shed_rate": float(total_row.get("shed_rate", 0.0)),
        "error_rate": float(total_row.get("error_rate", 0.0)),
        "midstream_loss_rate": float(
            total_row.get("midstream_loss_rate", 0.0)),
        "ttft_p50_ms": total_row.get("ttft_p50_ms"),
        "tokens_per_sec": round(fleet_tps, 1),
        "capacity_tokens_per_sec": round(fleet_cap, 1),
        "headroom_tokens_per_sec": round(
            max(0.0, fleet_cap - fleet_tps), 1),
        "prefix_hit_rate": (round(sum(hit_rates) / len(hit_rates), 4)
                            if hit_rates else None),
        "kv_tier_host_pages": fleet_host_pages,
    }
    return {
        "generated_unix_ms": int(time.time() * 1e3),
        "heartbeat_s": float(heartbeat_s),
        "window_s": float(slo.window_s),
        "slo_ttft_ms": float(slo.slo_ttft_ms),
        "fleet": fleet,
        "replicas": rows,
    }


def _check(section: str, obj, spec: dict, errors: list) -> None:
    if not isinstance(obj, dict):
        errors.append(f"{section}: {obj!r} is not an object")
        return
    for key, kinds in spec.items():
        if key not in obj:
            errors.append(f"{section}: missing required key {key!r}")
            continue
        if not any(_TYPES[k](obj[key]) for k in kinds):
            errors.append(f"{section}.{key}: value {obj[key]!r} is not "
                          f"any of {'/'.join(kinds)}")
    unknown = sorted(set(obj) - set(spec))
    if unknown:
        errors.append(
            f"{section}: unknown key(s) {unknown} — new fields must be "
            f"added to the router/fleet.py schema (renames orphan "
            f"dashboards and the fleet bench's fleet_obs block)")


def validate_fleet_snapshot(snap: dict) -> list[str]:
    """Every mismatch between ``snap`` and the ``/debug/fleet``
    contract; empty on a clean snapshot. Element-wise: each replica row
    and its ``slo`` sub-block are checked individually, so a rename in
    one row cannot hide behind the list/obj types."""
    errors: list[str] = []
    _check("fleet_snapshot", snap, FLEET_SCHEMA, errors)
    if isinstance(snap.get("fleet"), dict):
        _check("fleet_snapshot.fleet", snap["fleet"],
               FLEET_TOTALS_SCHEMA, errors)
    for i, row in enumerate(snap.get("replicas") or []):
        _check(f"fleet_snapshot.replicas[{i}]", row,
               FLEET_REPLICA_SCHEMA, errors)
        if isinstance(row, dict) and isinstance(row.get("slo"), dict):
            _check(f"fleet_snapshot.replicas[{i}].slo", row["slo"],
                   FLEET_SLO_SCHEMA, errors)
    return errors


def validate_router_timeline(tl: dict) -> list[str]:
    """Check one router ``/debug/requests`` timeline dict against the
    pinned contract: the top-level keys, and each event carrying
    ``event`` + ``t_ms`` (durations additionally ``dur_ms``)."""
    errors: list[str] = []
    _check("router_timeline", tl, ROUTER_TIMELINE_SCHEMA, errors)
    for i, ev in enumerate(tl.get("events") or []):
        if not isinstance(ev, dict):
            errors.append(f"router_timeline.events[{i}]: {ev!r} is not "
                          f"an object")
            continue
        if not isinstance(ev.get("event"), str):
            errors.append(f"router_timeline.events[{i}]: missing/non-str "
                          f"'event' name")
        if not _TYPES["num"](ev.get("t_ms")):
            errors.append(f"router_timeline.events[{i}]: missing/non-num "
                          f"'t_ms'")
    return errors


def publish_fleet_gauges(snap: dict) -> None:
    """Mirror the fleet-level headroom estimate onto /metrics (the
    per-replica window gauges are published by ``SloWindow.publish``)."""
    from . import metrics as router_metrics
    router_metrics.gauge("router_fleet_headroom_tokens_per_sec").set(
        float(snap["fleet"]["headroom_tokens_per_sec"]))


__all__ = [
    "FLEET_SCHEMA", "FLEET_TOTALS_SCHEMA", "FLEET_REPLICA_SCHEMA",
    "FLEET_SLO_SCHEMA", "ROUTER_TIMELINE_SCHEMA", "ROUTER_SELF",
    "build_fleet_snapshot", "validate_fleet_snapshot",
    "validate_router_timeline", "publish_fleet_gauges",
]
