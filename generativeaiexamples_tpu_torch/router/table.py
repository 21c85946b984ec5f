"""Replica table: prefix-affinity sketches, load/health state, placement.

The placement problem (Preble's prompt-aware scheduling, Mooncake's
KV-centric routing, adapted to this stack): the engine's prefix cache makes a
replica that has *seen* a conversation's prefix much cheaper for its
next turn than a cold sibling — so the router must send shared-prefix
traffic back to the replica whose KV pages it warms, without starving
load balance or placing onto a draining/dead replica.

Three signals, combined per candidate replica:

- **Affinity** — a router-side copy of the engine's chained block hash
  (``engine/prefix_cache.hash_blocks``), computed over the UTF-8 bytes
  of the request's prompt head instead of token ids (the router has no
  tokenizer; it only needs *consistency with itself*, and byte-block
  chaining has the same property that equal hash prefixes mean equal
  text prefixes). Each replica carries a bounded-LRU **sketch** of the
  block hashes of prompts recently placed on it — learned passively
  from the router's own successful placements; the engine API is
  untouched. The affinity score is the number of LEADING blocks of the
  incoming prompt found in the sketch — exactly the prefix the
  replica's engine-side cache can serve without prefill.
- **Load** — dispatch queue depth, in-flight edge streams, and the
  recent admission-rejection rate (the diff of the heartbeat's
  cumulative ``rejected_total`` between polls), all from the replica's
  ``/health`` heartbeat payload (chains/server.py ``_load_block``).
- **Health** — a per-replica :class:`~..utils.resilience.CircuitBreaker`
  fed by the router's own forward outcomes, plus heartbeat-observed
  ``draining``/unreachable state. Draining, unreachable, or
  breaker-open replicas are never placed.

Everything here is synchronous and lock-guarded — callable from the
router's event loop, bench threads, and chaos tests concurrently
(the add/remove-while-placing race is pinned by tests/test_router.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..engine.prefix_cache import BlockHash, hash_blocks
from ..utils import resilience
from ..utils.logging import get_logger
from . import metrics as router_metrics

logger = get_logger(__name__)

#: Placement policies. ``affinity`` is the production default;
#: ``round_robin`` ignores both affinity and load (the bench baseline —
#: what the affinity headline is measured against).
POLICIES = ("affinity", "round_robin")


def affinity_blocks(text: str, block_bytes: int = 64,
                    head_bytes: int = 4096) -> list[BlockHash]:
    """Chained block hashes of the prompt HEAD's UTF-8 bytes.

    Reuses the engine's ``hash_blocks`` with bytes standing in for token
    ids — chaining gives the same invariant (equal leading hashes ⇔
    equal leading text), and capping at ``head_bytes`` bounds the cost:
    shared-prefix affinity lives at the *front* of the prompt (system
    prompt + early turns); differentiating tails add nothing."""
    data = text.encode("utf-8", errors="replace")[:head_bytes]
    return hash_blocks(list(data), block_bytes)


@dataclass
class Replica:
    name: str
    url: str
    breaker: resilience.CircuitBreaker
    reachable: bool = True      # the last heartbeat got an HTTP answer
    ready: bool = True          # ... and it was a 200 (drain/breaker -> 503)
    draining: bool = False
    load: dict = field(default_factory=dict)
    # Fleet-observability blocks from the heartbeat body (chains/server
    # ``/health``): the replica's round-telemetry rolling aggregates,
    # its KV-tier counters, and its modeled decode capacity — folded
    # into ``GET /debug/fleet`` (router/fleet.py), never into placement
    # scoring (the ``load`` block above stays the scoring contract).
    rounds: dict = field(default_factory=dict)
    kv_tier: dict = field(default_factory=dict)
    capacity: dict = field(default_factory=dict)
    # Disaggregation role, heartbeat-advertised (chains/server.py
    # /health): "unified" (the default — also what replicas that never
    # send a role resolve to, so a role-less fleet places byte-for-byte
    # like today), "prefill" (excluded from normal placement; the
    # router's handoff leg targets it directly), or "decode".
    role: str = "unified"
    recent_rejects: float = 0.0    # rejected_total diff between heartbeats
    last_heartbeat_t: float = 0.0
    heartbeat_failures: int = 0    # probes that got no HTTP answer at all
    placements: int = 0            # committed placements (the metric)
    selections: int = 0            # place() picks — bumped at decision
    #                                time, under the table lock, so
    #                                concurrent requests can't all pick
    #                                the same replica before any commits
    # Affinity sketch: block hash -> recency tick (insertion-ordered dict
    # as LRU). Bounded; evicts oldest.
    sketch: dict = field(default_factory=dict)

    def placeable(self) -> bool:
        return (self.reachable and self.ready and not self.draining
                and self.breaker.state != resilience.OPEN)

    def snapshot(self) -> dict:
        return {
            "name": self.name, "url": self.url,
            "reachable": self.reachable, "ready": self.ready,
            "draining": self.draining,
            "breaker": self.breaker.state, "placeable": self.placeable(),
            "role": self.role,
            "load": dict(self.load),
            "rounds": dict(self.rounds),
            "kv_tier": dict(self.kv_tier),
            "capacity": dict(self.capacity),
            "recent_rejects": self.recent_rejects,
            "placements": self.placements,
            "sketch_blocks": len(self.sketch),
            "heartbeat_failures": self.heartbeat_failures,
            "heartbeat_age_s": (round(time.monotonic()
                                      - self.last_heartbeat_t, 3)
                                if self.last_heartbeat_t else None),
        }


class ReplicaTable:
    """The router's authoritative replica set + placement scorer."""

    def __init__(self, *, policy: str = "affinity",
                 block_bytes: int = 64, head_bytes: int = 4096,
                 sketch_cap: int = 2048,
                 affinity_weight: float = 2.0,
                 queue_weight: float = 1.0,
                 inflight_weight: float = 0.5,
                 shed_weight: float = 1.0,
                 breaker_failures: int = 3,
                 breaker_cooldown_s: float = 10.0):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r} "
                             f"(known: {', '.join(POLICIES)})")
        self.policy = policy
        self.block_bytes = int(block_bytes)
        self.head_bytes = int(head_bytes)
        self.sketch_cap = int(sketch_cap)
        self.affinity_weight = float(affinity_weight)
        self.queue_weight = float(queue_weight)
        self.inflight_weight = float(inflight_weight)
        self.shed_weight = float(shed_weight)
        self._breaker_failures = int(breaker_failures)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}

    # ------------------------------------------------------------ members

    def add(self, name: str, url: str) -> Replica:
        """Add (or re-add) a replica. Re-adding an existing name resets
        its state — the rollout story: a replaced pod comes back clean."""
        rep = Replica(
            name=name, url=url.rstrip("/"),
            # Private breaker instance (not the shared registry): each
            # replica's failure count is its own; state still lands on
            # /metrics under breaker_state{name="replica_<name>"}.
            breaker=resilience.CircuitBreaker(
                f"replica_{name}", self._breaker_failures,
                self._breaker_cooldown_s))
        with self._lock:
            self._replicas[name] = rep
        self._publish_counts()
        logger.info("router: replica %s -> %s added", name, rep.url)
        return rep

    def remove(self, name: str) -> bool:
        with self._lock:
            found = self._replicas.pop(name, None) is not None
        self._publish_counts()
        if found:
            logger.info("router: replica %s removed", name)
        return found

    def get(self, name: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(name)

    def replicas(self) -> list[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def snapshot(self) -> list[dict]:
        return [r.snapshot() for r in self.replicas()]

    # ----------------------------------------------------------- affinity

    def affinity_blocks(self, text: str) -> list[BlockHash]:
        return affinity_blocks(text, self.block_bytes, self.head_bytes)

    def _match(self, rep: Replica, blocks: Sequence[BlockHash]) -> int:
        """Leading blocks of ``blocks`` present in the replica's sketch —
        the contiguous shared prefix its engine cache can plausibly
        serve. Chained hashes make any gap a hard stop: block k in the
        sketch without block k-1 belongs to a different prefix."""
        n = 0
        for h in blocks:
            if h not in rep.sketch:
                break
            n += 1
        return n

    def record_placement(self, rep: Replica,
                         blocks: Sequence[BlockHash]) -> int:
        """Commit a successful placement: learn the prompt's blocks into
        the replica's sketch (LRU refresh), bump counters. Returns the
        affinity match the placement had (for the hit counter)."""
        with self._lock:
            matched = self._match(rep, blocks)
            for h in blocks:
                rep.sketch.pop(h, None)     # refresh recency
                rep.sketch[h] = None
            while len(rep.sketch) > self.sketch_cap:
                rep.sketch.pop(next(iter(rep.sketch)))
            rep.placements += 1
        router_metrics.counter("router_placed_total", rep.name).inc()
        if matched:
            router_metrics.counter("router_affinity_hits").inc()
        return matched

    # ---------------------------------------------------------- placement

    def _load_penalty(self, rep: Replica) -> float:
        load = rep.load
        return (self.queue_weight * float(load.get("queue_depth", 0))
                + self.inflight_weight * float(load.get("in_flight", 0))
                + self.shed_weight * rep.recent_rejects)

    def _score(self, rep: Replica, blocks: Sequence[BlockHash]) -> float:
        return self.affinity_weight * self._match(rep, blocks) \
            - self._load_penalty(rep)

    def place(self, blocks: Sequence[BlockHash] = (),
              exclude: Sequence[str] = ()) -> Optional[Replica]:
        """Choose the replica for a request whose prompt head hashes to
        ``blocks``. ``exclude`` names replicas already tried this
        request (the retry loop). Returns None when no placeable replica
        remains — the caller's 503."""
        rep, _ = self.place_explained(blocks, exclude)
        return rep

    def place_explained(self, blocks: Sequence[BlockHash] = (),
                        exclude: Sequence[str] = (),
                        include_draining: bool = False
                        ) -> tuple[Optional[Replica], dict]:
        """``place`` plus the decision evidence the router's flight
        recorder stamps on the request timeline: every candidate's
        score, affinity match, and load penalty inputs, and the chosen
        replica's leading-block match — computed under the same lock as
        the choice, so the explanation is exactly what the scorer saw.

        ``include_draining`` widens the pool to reachable DRAINING
        replicas (breaker still respected) — the mid-stream failover
        resume leg uses it: the rollout contract keeps a draining
        replica serving its accepted streams, and a resume is the
        continuation of an already-accepted stream, not new work, so a
        draining sibling is a legitimate rescue target when it is the
        only one left."""
        with self._lock:
            # Prefill-role replicas never take normal traffic: their
            # admission rejects decode-bound requests anyway (engine
            # RoleMismatchError), so offering them here would only buy
            # retries. The router reaches them exclusively through the
            # handoff leg (FleetRouter._disagg_handoff). A role-less
            # fleet has no prefill replicas and this filter matches
            # nothing — placement is byte-for-byte today's.
            candidates = [r for r in self._replicas.values()
                          if r.name not in exclude
                          and (r.placeable()
                               or (include_draining and r.reachable
                                   and r.draining
                                   and r.breaker.state != resilience.OPEN))
                          and r.role != "prefill"]
            decision: dict = {"policy": self.policy,
                              "excluded": list(exclude),
                              "candidates": []}
            if not candidates:
                return None, decision
            # Score each candidate ONCE; the selection and the decision
            # evidence read the same tuples (no hot-path recompute).
            scored = [(r, self._match(r, blocks)) for r in candidates]
            scored = [(r, m, self.affinity_weight * m
                       - self._load_penalty(r)) for r, m in scored]
            if self.policy == "round_robin":
                chosen, chosen_match, _ = min(
                    scored, key=lambda t: (t[0].selections, t[0].name))
            else:
                # Max score; ties rotate to the least-selected candidate
                # so a no-affinity workload degenerates to
                # least-loaded-then-RR instead of pinning the
                # dict-order-first replica.
                chosen, chosen_match, _ = max(
                    scored, key=lambda t: (t[2], -t[0].selections,
                                           t[0].name))
            for r, match, score in scored:
                decision["candidates"].append({
                    "replica": r.name,
                    "score": round(score, 3),
                    "affinity_blocks": match,
                    "queue_depth": int(r.load.get("queue_depth", 0)),
                    "in_flight": int(r.load.get("in_flight", 0)),
                })
            decision["replica"] = chosen.name
            decision["affinity_blocks"] = chosen_match
            chosen.selections += 1
            return chosen, decision

    def transfer_donor(self, blocks: Sequence[BlockHash], chosen: str,
                       min_blocks: int = 2) -> Optional[str]:
        """Cross-replica KV-transfer hint: when the CHOSEN replica's
        sketch misses this prompt's head but a reachable sibling's
        covers it (strictly better, and by at least ``min_blocks`` —
        a one-block match is not worth a network fetch), return the
        sibling's URL. The chosen replica then pulls the prefix pages
        from the donor over ``GET /control/kv_pages`` instead of
        re-prefilling (docs/kv-tiering.md). Draining donors still
        qualify — their control plane keeps serving while admission is
        closed, which is exactly the rollout case where the pages would
        otherwise die with the pod."""
        with self._lock:
            me = self._replicas.get(chosen)
            my_match = self._match(me, blocks) if me is not None else 0
            best, best_match = None, 0
            for rep in self._replicas.values():
                if rep.name == chosen or not rep.reachable:
                    continue
                m = self._match(rep, blocks)
                if m > best_match:
                    best, best_match = rep, m
            if best is not None and best_match >= max(1, min_blocks) \
                    and best_match > my_match:
                return best.url
        return None

    # ------------------------------------------------------------- health

    def update_health(self, name: str, *, ok: bool, ready: bool = True,
                      body: Optional[dict] = None) -> None:
        """Apply one heartbeat observation. ``ok`` is reachability (the
        probe got an HTTP answer at all); ``ready`` is whether that
        answer was a 200 (the chain server 503s while draining or
        breaker-open — readiness truthfulness); the body's ``draining``
        / ``load`` fields refine it. A replica whose probe failed is
        unplaceable IMMEDIATELY — within one heartbeat of a kill,
        placement has stopped."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            rep.last_heartbeat_t = time.monotonic()
            rep.reachable = ok
            rep.ready = ok and ready
            if not ok:
                # A failed probe must not flip the replica silently:
                # count it where dashboards
                # can see a partition (or a stalled replica) building.
                rep.heartbeat_failures += 1
            if ok and body is not None:
                rep.draining = bool(body.get("draining", False))
                # Role defaults to "unified" when the heartbeat body
                # carries no role key (older replicas, engineless
                # chains) — a role-less fleet must behave exactly like
                # today's.
                role = str(body.get("role") or "unified")
                rep.role = role if role in ("unified", "prefill",
                                            "decode") else "unified"
                # Fleet-observability blocks ride the same heartbeat;
                # absent blocks (engineless chains, older replicas)
                # clear so /debug/fleet never shows stale telemetry.
                rep.rounds = dict(body.get("rounds") or {})
                rep.kv_tier = dict(body.get("kv_tier") or {})
                rep.capacity = dict(body.get("capacity") or {})
                load = body.get("load") or {}
                # recent_rejects is a between-heartbeats DIFF, so the
                # first observation is baseline only — a long-running
                # replica's lifetime rejected_total must not count as
                # "recent" shed and sink its placement score.
                prev = rep.load.get("rejected_total")
                if prev is None:
                    rep.recent_rejects = 0.0
                else:
                    cur = float(load.get("rejected_total", prev))
                    rep.recent_rejects = max(0.0, cur - float(prev))
                rep.load = dict(load)
        if ok:
            if body is not None:
                router_metrics.record_replica_load(name,
                                                   body.get("load") or {})
        else:
            # Mirrors Replica.heartbeat_failures exactly: only probes
            # that got NO HTTP answer count (a reachable replica with a
            # non-JSON body is a different problem, not a partition).
            router_metrics.counter(
                "router_heartbeat_failures_total", name).inc()
        self._publish_counts()
        self.publish_heartbeat_ages()

    def publish_heartbeat_ages(self) -> None:
        """Refresh ``router_heartbeat_age_seconds{replica=}`` from the
        live table — called on every heartbeat observation AND at
        /metrics scrape time, so a STALLED poller shows as a growing
        age instead of a frozen gauge."""
        now = time.monotonic()
        for rep in self.replicas():
            age = (now - rep.last_heartbeat_t) if rep.last_heartbeat_t \
                else -1.0
            router_metrics.gauge(
                "router_heartbeat_age_seconds", rep.name).set(
                round(age, 3))

    def scale_down_candidate(self, exclude: Sequence[str] = (),
                             exclude_roles: Sequence[str] = ()
                             ) -> Optional[str]:
        """The replica a scale-down should drain first: the PLACEABLE
        one with the least in-flight work (fewest edge streams, then
        shallowest queue, then fewest lifetime placements — the
        cheapest drain and the smallest affinity-sketch loss). Draining
        or dead replicas are never proposed (they are already leaving
        or already gone); ``exclude_roles`` lets the autoscaler protect
        a pool (draining the only prefill replica over a quiet DECODE
        signal would kill every in-flight handoff); None when no
        eligible replica remains."""
        with self._lock:
            candidates = [r for r in self._replicas.values()
                          if r.name not in exclude and r.placeable()
                          and r.role not in exclude_roles]
            if not candidates:
                return None
            return min(candidates, key=lambda r: (
                int(r.load.get("in_flight", 0)),
                int(r.load.get("queue_depth", 0)),
                r.placements, r.name)).name

    def prefill_candidate(self) -> Optional[Replica]:
        """The prefill-role replica a handoff leg should target: the
        least-loaded placeable one (shallowest queue, then fewest
        in-flight, then fewest selections so equal-load prefill
        replicas rotate). None when the fleet has no placeable prefill
        replica — the router then serves the long prompt in place
        (chunked prefill on the chosen decode/unified replica), which
        is exactly today's behavior."""
        with self._lock:
            candidates = [r for r in self._replicas.values()
                          if r.placeable() and r.role == "prefill"]
            if not candidates:
                return None
            chosen = min(candidates, key=lambda r: (
                int(r.load.get("queue_depth", 0)),
                int(r.load.get("in_flight", 0)),
                r.selections, r.name))
            chosen.selections += 1
            return chosen

    def mark_unreachable(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.reachable = False
        self._publish_counts()

    def mark_draining(self, name: str, value: bool = True) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.draining = bool(value)
        self._publish_counts()

    def _publish_counts(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
            healthy = sum(1 for r in reps if r.placeable())
            drain_in_flight = sum(
                int(r.load.get("in_flight", 0)) for r in reps if r.draining)
            by_role = {role: sum(1 for r in reps if r.role == role)
                       for role in ("unified", "prefill", "decode")}
        router_metrics.gauge("router_replicas_total").set(len(reps))
        router_metrics.gauge("router_replicas_healthy").set(healthy)
        router_metrics.gauge("router_drain_in_flight").set(drain_in_flight)
        for role, n in by_role.items():
            router_metrics.gauge("router_replicas_role", role).set(n)


def handoff_beats_prefill(capacity: Optional[dict], prompt_bytes: int,
                          bytes_per_token: float = 4.0) -> bool:
    """The router-side disaggregation pricing rule: does shipping this
    prompt's finished prefix pages (prefill replica → decode replica,
    both transfer legs) beat the decode replica chunk-prefilling it in
    place? ``capacity`` is the DECODE replica's heartbeat capacity
    block (chains/server.py) — the same calibrated
    ``prefill_ms_per_token`` / ``h2d``/``d2h`` per-page costs its own
    engine prices restores with; ``prompt_bytes`` is the router's only
    length signal (no tokenizer), converted at a coarse
    ``bytes_per_token``. Unmeasured transfer legs (0 — the calibrator
    has no evidence yet) answer True, mirroring
    ``StepCostModel.restore_cheaper``; an unmeasured prefill cost with
    MEASURED transfer legs answers False (recompute is priced free —
    nothing to beat)."""
    cap = capacity or {}
    page_size = max(1, int(cap.get("page_size", 128) or 128))
    est_tokens = max(1, int(prompt_bytes / max(1.0, bytes_per_token)))
    pages = max(1, -(-est_tokens // page_size))
    per_page = (float(cap.get("d2h_ms_per_page", 0.0) or 0.0)
                + float(cap.get("h2d_ms_per_page", 0.0) or 0.0))
    if per_page <= 0:
        return True
    prefill_ms = float(cap.get("prefill_ms_per_token", 0.0) or 0.0)
    if prefill_ms <= 0:
        return False
    return pages * per_page < est_tokens * prefill_ms
