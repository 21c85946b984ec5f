"""SLO-driven fleet autoscaler + surge admission: the loop that CLOSES
the control loop the fleet snapshot instruments.

The fleet snapshot (``GET /debug/fleet``, router/fleet.py) already
carries everything a conductor needs — per-replica queue depth, the
rolling SLO window, calibrated ``capacity_tokens_per_sec`` from the same
step-cost model the open-loop goodput bench fits, and the derived
capacity headroom. Until now nothing ACTED on it: the fleet could see an
overload coming and could only shed. This module is the actor
(Mooncake's overload-oriented conductor, DistServe's pool sizing,
adapted to this stack):

- :class:`AutoscaleController` — a periodic control cycle over the
  fleet snapshot. Scale **up** on LEADING indicators (headroom
  consumption, queue depth per replica and its trend across the rolling
  window, SLO-slack exhaustion) *before* ``shed_total`` starts climbing;
  sheds themselves are kept only as the lagging backstop. Scale **down**
  only through the drain protocol — a streaming replica is never
  killed. Every cycle appends a :data:`decision record <DECISION_SCHEMA>`
  with its full evidence to a bounded ring (``GET /debug/autoscale``),
  so "why did the fleet scale at 14:03" is a join against
  ``/debug/fleet``, not archaeology.
- :class:`SurgeGate` — router-level surge admission for the at-max
  fleet: a bounded wait queue in front of placement whose rejections are
  honest backpressure (429 + ``Retry-After`` derived from the MEASURED
  service-time estimate, fast 429 ``deadline_unmeetable`` when the
  caller's budget cannot survive the queue) instead of cascading
  timeouts.
- Executors — :class:`LocalExecutor` activates/parks in-process
  replicas through the router's own membership API (the bench and the
  chaos tests drive this one); :class:`KubeOperatorExecutor`, the
  operator's reconcile path, waits for the operator (ROADMAP A18) and
  refuses at construction. The controller gates every execution behind
  a ``leader`` callable so an active/standby router pair has exactly one
  writer.

The decision-record and ``/debug/autoscale`` contracts are pinned by
:data:`AUTOSCALE_SCHEMA` / :data:`DECISION_SCHEMA` /
:data:`EVIDENCE_SCHEMA` and enforced element-wise by
:func:`validate_autoscale_snapshot` — ``tools/preflight.py`` runs it
over a synthetic-but-real controller (proven able to fail in tier 1),
the same way the fleet snapshot contract is pinned.
"""

from __future__ import annotations

import asyncio
import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import aiohttp

from ..utils import faults
from ..utils.errors import ConfigError
from ..utils.logging import get_logger
from . import metrics as router_metrics
from .fleet import _TYPES, _check
from .flight import _env_float

logger = get_logger(__name__)

#: Everything a decision's ``action`` field may say. ``hold`` is the
#: no-op cycle (evidence still recorded); ``surge_on``/``surge_off`` are
#: the at-max admission-mode transitions; ``blocked`` is a wanted scale
#: action that could not run (cooldown, not leader, no executor).
ACTIONS = ("scale_up", "scale_down", "hold", "surge_on", "surge_off",
           "blocked")


# --------------------------------------------------------------- policy


@dataclass
class AutoscalePolicy:
    """The control law's knobs (docs/autoscaling.md has the full table).

    Scale-up triggers are LEADING indicators; any one suffices:
    utilization ≥ ``up_util``, queue depth per placeable replica ≥
    ``queue_high`` (or ≥ half of it while the trend is rising), windowed
    TTFT p50 past ``slack_frac`` of the SLO, or — the lagging backstop —
    a nonzero shed rate. Scale-down needs ``down_stable_ticks``
    consecutive quiet cycles (utilization ≤ ``down_util``, empty queue,
    zero sheds) and proceeds one replica at a time via drain.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    target_util: float = 0.75     # sizing target for the demand model
    up_util: float = 0.85         # headroom-consumption trigger
    queue_high: float = 4.0       # queued requests per placeable replica
    slack_frac: float = 0.8       # windowed ttft_p50 / SLO trigger
    down_util: float = 0.30
    down_stable_ticks: int = 3
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 30.0
    interval_s: float = 2.0       # control-cycle period
    trend_window: int = 5         # cycles kept for the queue trend
    drain_wait_s: float = 60.0    # scale-down drain budget

    @classmethod
    def from_env(cls, *, min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None) -> "AutoscalePolicy":
        """``ROUTER_AUTOSCALE_*`` env knobs over the defaults above."""
        e = _env_float
        return cls(
            min_replicas=int(min_replicas if min_replicas is not None
                             else e("ROUTER_AUTOSCALE_MIN", 1)),
            max_replicas=int(max_replicas if max_replicas is not None
                             else e("ROUTER_AUTOSCALE_MAX", 1)),
            target_util=e("ROUTER_AUTOSCALE_TARGET_UTIL", 0.75),
            up_util=e("ROUTER_AUTOSCALE_UP_UTIL", 0.85),
            queue_high=e("ROUTER_AUTOSCALE_QUEUE_HIGH", 4.0),
            slack_frac=e("ROUTER_AUTOSCALE_SLACK_FRAC", 0.8),
            down_util=e("ROUTER_AUTOSCALE_DOWN_UTIL", 0.30),
            down_stable_ticks=int(
                e("ROUTER_AUTOSCALE_DOWN_STABLE_TICKS", 3)),
            up_cooldown_s=e("ROUTER_AUTOSCALE_UP_COOLDOWN_S", 5.0),
            down_cooldown_s=e("ROUTER_AUTOSCALE_DOWN_COOLDOWN_S", 30.0),
            interval_s=e("ROUTER_AUTOSCALE_INTERVAL_S", 2.0),
            trend_window=int(e("ROUTER_AUTOSCALE_TREND_WINDOW", 5)),
            drain_wait_s=e("ROUTER_AUTOSCALE_DRAIN_WAIT_S", 60.0))

    def snapshot(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "target_util": self.target_util,
            "up_util": self.up_util,
            "queue_high": self.queue_high,
            "slack_frac": self.slack_frac,
            "down_util": self.down_util,
            "down_stable_ticks": self.down_stable_ticks,
            "up_cooldown_s": self.up_cooldown_s,
            "down_cooldown_s": self.down_cooldown_s,
            "interval_s": self.interval_s,
            "trend_window": self.trend_window,
            "drain_wait_s": self.drain_wait_s,
        }


# ----------------------------------------------------------- surge gate


class SurgeGate:
    """Bounded-queue admission at the router's front door.

    In-flight forwards and their hold times are counted ALWAYS (two
    integer ops per request), so the moment the controller flips the
    gate ``active`` — fleet at max and still overloaded — the
    concurrency accounting and the service-time EWMA are already warm.
    While active, a request beyond the concurrency bound waits in a
    bounded FIFO; the three rejection paths are all honest backpressure:

    - ``deadline_unmeetable`` — the caller's ``X-Deadline-Ms`` is below
      the estimated queue wait: fast 429 before any queueing.
    - ``surge_queue_full`` — the wait queue is at ``queue_cap``.
    - ``surge_timeout`` — the request waited ``max_wait_s`` without a
      slot freeing.

    Every rejection's ``Retry-After`` derives from the MEASURED estimate
    ``(position + 1) × service_ewma_ms / concurrency`` — the queue-wait
    a retry would actually face, not a constant. Single-event-loop only
    (the router's); no locks by construction.
    """

    def __init__(self, *, queue_cap: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 concurrency: Optional[int] = None,
                 service_prior_ms: float = 500.0):
        self.queue_cap = int(queue_cap if queue_cap is not None
                             else _env_float("ROUTER_SURGE_QUEUE_CAP", 64))
        self.max_wait_s = float(
            max_wait_s if max_wait_s is not None
            else _env_float("ROUTER_SURGE_MAX_WAIT_S", 5.0))
        self.concurrency = max(1, int(
            concurrency if concurrency is not None
            else _env_float("ROUTER_SURGE_CONCURRENCY", 16)))
        # An EXPLICIT bound (constructor arg or env) is an operator
        # decision: the controller's per-replica tracking must not
        # overwrite it (AutoscaleController.tick consults this).
        self.concurrency_pinned = (
            concurrency is not None
            or bool(os.environ.get("ROUTER_SURGE_CONCURRENCY")))
        self.active = False
        self._in_flight = 0
        self._waiters: deque = deque()
        self._service_ewma_ms = float(service_prior_ms)
        self.admitted_total = 0
        self.rejected: dict[str, int] = {}

    # ------------------------------------------------------------ control

    def set_active(self, value: bool) -> None:
        self.active = bool(value)
        if not self.active:
            # Draining the wait queue on deactivation: the overload is
            # over, everyone queued gets through.
            while self._waiters:
                fut = self._waiters.popleft()
                if not fut.done():
                    self._in_flight += 1
                    fut.set_result(True)
            self._publish_depth()

    def set_concurrency(self, value: int) -> None:
        self.concurrency = max(1, int(value))
        # A RAISED bound frees slots NOW: grant queued waiters up to it
        # (otherwise they sit out max_wait_s against free capacity,
        # since grants otherwise only happen on exit()).
        self._grant_waiters()

    # ------------------------------------------------------------- admit

    def estimate_wait_ms(self, position: Optional[int] = None) -> float:
        """Measured queue-wait estimate for a request entering at
        ``position`` (default: the back of the current queue)."""
        pos = len(self._waiters) if position is None else position
        return (pos + 1) * self._service_ewma_ms / self.concurrency

    async def enter(self, deadline_ms: Optional[float] = None
                    ) -> tuple[Optional[float],
                               Optional[tuple[str, float]]]:
        """Admit one forward. Returns ``(ticket, None)`` on admission
        (pass the ticket to :meth:`exit` in a finally) or
        ``(None, (err_type, est_wait_ms))`` on rejection."""
        if not self.active:
            self._in_flight += 1
            return time.monotonic(), None
        if self._in_flight < self.concurrency and not self._waiters:
            self._in_flight += 1
            self.admitted_total += 1
            return time.monotonic(), None
        est = self.estimate_wait_ms()
        if deadline_ms is not None and est > float(deadline_ms):
            self._reject("deadline_unmeetable")
            return None, ("deadline_unmeetable", est)
        if len(self._waiters) >= self.queue_cap:
            self._reject("surge_queue_full")
            return None, ("surge_queue_full", est)
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        self._publish_depth()
        try:
            await asyncio.wait_for(fut, timeout=self.max_wait_s)
        except asyncio.TimeoutError:
            try:
                self._waiters.remove(fut)
            except ValueError:
                # Already popped by a grantor. On 3.12+ wait_for can
                # surface TimeoutError even though the grant landed
                # first (the cancel races set_result) — the slot is
                # OURS; admitting is both correct and the only path
                # that doesn't leak the _in_flight increment.
                if fut.done() and not fut.cancelled():
                    self._publish_depth()
                    self.admitted_total += 1
                    return time.monotonic(), None
            self._publish_depth()
            self._reject("surge_timeout")
            return None, ("surge_timeout", self.estimate_wait_ms())
        except BaseException:
            # Caller cancelled while queued: leave honestly.
            try:
                self._waiters.remove(fut)
            except ValueError:
                # Already granted (raced a grant): give the slot back.
                if fut.done() and not fut.cancelled():
                    self._release_slot()
            self._publish_depth()
            raise
        self._publish_depth()
        self.admitted_total += 1
        return time.monotonic(), None

    def exit(self, ticket: Optional[float]) -> None:
        """Release one forward's slot; feeds the service-time EWMA."""
        if ticket is None:
            return
        held_ms = (time.monotonic() - ticket) * 1e3
        self._service_ewma_ms = (0.8 * self._service_ewma_ms
                                 + 0.2 * held_ms)
        self._release_slot()

    def _release_slot(self) -> None:
        self._in_flight = max(0, self._in_flight - 1)
        self._grant_waiters()

    def _grant_waiters(self) -> None:
        while self._waiters and self._in_flight < self.concurrency:
            fut = self._waiters.popleft()
            if not fut.done():
                self._in_flight += 1
                fut.set_result(True)
        self._publish_depth()

    def _reject(self, reason: str) -> None:
        self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def _publish_depth(self) -> None:
        router_metrics.gauge("router_surge_queue_depth").set(
            len(self._waiters))

    def snapshot(self) -> dict:
        return {
            "active": self.active,
            "queue_depth": len(self._waiters),
            "queue_cap": self.queue_cap,
            "concurrency": self.concurrency,
            "in_flight": self._in_flight,
            "max_wait_s": self.max_wait_s,
            "est_wait_ms": round(self.estimate_wait_ms(), 1),
            "service_ewma_ms": round(self._service_ewma_ms, 1),
            "admitted_total": self.admitted_total,
            "rejected": dict(self.rejected),
        }


# ------------------------------------------------------------ executors


class LocalExecutor:
    """Activate/park pre-built in-process replicas through the router's
    own membership path — the executor the bench and the chaos tests
    drive. ``pool`` is the PARKED (name, url) pairs; scale-up activates
    from it (``table.add`` + an immediate probe so the replica takes
    traffic without waiting a heartbeat), scale-down drains via
    :meth:`FleetRouter.remove_replica` and parks the pair again."""

    def __init__(self, router, pool: Sequence[tuple[str, str]] = (),
                 drain_wait_s: float = 30.0):
        self.router = router
        self._parked: deque = deque(pool)
        self.drain_wait_s = float(drain_wait_s)

    @property
    def parked(self) -> list[tuple[str, str]]:
        return list(self._parked)

    async def scale_to(self, target: int, *, current: int, action: str,
                       victim: Optional[str] = None) -> dict:
        added: list[str] = []
        removed: list[str] = []
        while current + len(added) < target and self._parked:
            name, url = self._parked.popleft()
            # A parked replica was DRAINED on its way out (scale-down);
            # re-activation must reopen its admission or it answers 429
            # draining forever. Bounded like every other control call —
            # a wedged parked replica must not stall the control loop.
            try:
                assert self.router._session is not None
                async with self.router._session.post(
                        url + "/control/undrain",
                        timeout=aiohttp.ClientTimeout(
                            total=self.router.heartbeat_timeout_s)) \
                        as resp:
                    await resp.read()
            except Exception:  # noqa: BLE001 — fresh replicas have no drain
                pass
            rep = self.router.table.add(name, url)
            # Probe now: the new replica serves the burst that caused
            # the scale-up, not the one after next heartbeat.
            await self.router._probe(rep)
            added.append(name)
        while current - len(removed) > target:
            name = victim or self.router.table.scale_down_candidate(
                exclude_roles=("prefill",))
            victim = None
            if name is None:
                break
            rep = self.router.table.get(name)
            url = rep.url if rep is not None else None
            ok = await self.router.remove_replica(
                name, drain=True, wait_s=self.drain_wait_s)
            if not ok:
                break
            removed.append(name)
            if url is not None:
                self._parked.append((name, url))
        detail = f"local: parked={len(self._parked)}"
        return {"ok": True, "added": added, "removed": removed,
                "error": None, "detail": detail}


class KubeOperatorExecutor:
    """Scale through the Kubernetes operator's reconcile path (patching
    the HelmPipeline CR's chart values). The operator (``deploy/``) is not
    in this package yet (ROADMAP A18), so construction refuses with
    ``ConfigError`` instead of failing at the first scale decision; use
    :class:`LocalExecutor` or no executor (dry run)."""

    def __init__(self, kube=None, *, namespace: str = "",
                 pipeline: str = "", release: str = "",
                 values_path: Sequence[str] = ()):
        raise ConfigError(
            "KubeOperatorExecutor needs the Kubernetes operator "
            "(deploy.operator), which this package does not have yet "
            "(ROADMAP A18); use LocalExecutor or run without an executor")


# ----------------------------------------------------------- controller


class AutoscaleController:
    """The periodic control cycle (see module docstring). ``router`` is
    a :class:`~.server.FleetRouter` (or anything with ``refresh_fleet``
    + ``table``); ``executor`` may be None (decisions are still
    recorded — a dry-run conductor); ``leader`` gates every execution
    (active/standby single-writer)."""

    def __init__(self, router, *, policy: Optional[AutoscalePolicy] = None,
                 executor=None, surge: Optional[SurgeGate] = None,
                 leader: Optional[Callable[[], bool]] = None,
                 slo_ttft_ms: Optional[float] = None,
                 ring_cap: int = 256):
        self.router = router
        self.policy = policy or AutoscalePolicy.from_env()
        self.executor = executor
        self.surge = surge or SurgeGate()
        self.leader = leader or (lambda: True)
        # The slack-exhaustion trigger compares the windowed TTFT p50
        # against the SAME SLO the window scores attainment with.
        if slo_ttft_ms is None:
            window = getattr(getattr(router, "flight", None), "slo", None)
            slo_ttft_ms = getattr(window, "slo_ttft_ms", None) \
                or _env_float("ROUTER_SLO_TTFT_MS", 2000.0)
        self.slo_ttft_ms = float(slo_ttft_ms)
        self._decisions: deque = deque(maxlen=ring_cap)
        self._decisions_total: dict[str, int] = {}
        self._queue_history: deque = deque(
            maxlen=max(2, self.policy.trend_window))
        self._seq = 0
        self._last_up_t = 0.0
        self._last_down_t = 0.0
        self._quiet_ticks = 0
        self.target_replicas: Optional[int] = None
        self._now = time.monotonic   # tests pin the clock here

    # ----------------------------------------------------------- evidence

    def _evidence(self, snap: dict) -> dict:
        fleet = snap.get("fleet") or {}
        placeable = int(fleet.get("replicas_placeable", 0))
        queue_depth = int(fleet.get("queue_depth", 0))
        tps = float(fleet.get("tokens_per_sec", 0.0) or 0.0)
        cap = float(fleet.get("capacity_tokens_per_sec", 0.0) or 0.0)
        util = round(tps / cap, 4) if cap > 0 else None
        self._queue_history.append(queue_depth)
        hist = list(self._queue_history)
        trend = ((hist[-1] - hist[0]) / max(1, len(hist) - 1)
                 if len(hist) >= 2 else 0.0)
        return {
            "snapshot_unix_ms": int(snap.get("generated_unix_ms", 0)),
            "replicas_total": int(fleet.get("replicas_total", 0)),
            "replicas_placeable": placeable,
            "in_flight": int(fleet.get("in_flight", 0)),
            "queue_depth": queue_depth,
            "queue_per_replica": round(
                queue_depth / max(1, placeable), 3),
            "queue_trend": round(trend, 3),
            "utilization": util,
            "tokens_per_sec": tps,
            "capacity_tokens_per_sec": cap,
            "headroom_tokens_per_sec": float(
                fleet.get("headroom_tokens_per_sec", 0.0) or 0.0),
            "shed_rate": float(fleet.get("shed_rate", 0.0) or 0.0),
            "slo_attainment": fleet.get("slo_attainment"),
            "ttft_p50_ms": fleet.get("ttft_p50_ms"),
            "surge_queue_depth": len(self.surge._waiters),
            # Disaggregation role census (docs/disaggregation.md): a
            # role-ful fleet's capacity is per-pool, and the decision
            # record must show WHICH pool the evidence describes — a
            # role-less fleet reads {"unified": N}.
            "roles": dict(fleet.get("roles") or {}),
        }

    def _up_reasons(self, ev: dict) -> list[str]:
        p = self.policy
        reasons = []
        util = ev["utilization"]
        if util is not None and util >= p.up_util:
            reasons.append(f"utilization {util:.2f} >= {p.up_util:g}")
        qpr = ev["queue_per_replica"]
        if qpr >= p.queue_high:
            reasons.append(f"queue/replica {qpr:g} >= {p.queue_high:g}")
        elif ev["queue_trend"] > 0 and qpr >= p.queue_high / 2:
            reasons.append(
                f"queue rising ({ev['queue_trend']:+g}/tick) at "
                f"{qpr:g}/replica")
        ttft = ev["ttft_p50_ms"]
        if ttft is not None and self.slo_ttft_ms \
                and ttft >= p.slack_frac * self.slo_ttft_ms:
            reasons.append(
                f"slack exhaustion: ttft_p50 {ttft:.0f} ms >= "
                f"{p.slack_frac:g} x SLO {self.slo_ttft_ms:g} ms")
        if ev["shed_rate"] > 0:
            # The LAGGING backstop: if this fires first, the leading
            # indicators were mistuned — the decision record says so.
            reasons.append(f"sheds observed (rate "
                           f"{ev['shed_rate']:g}) — late")
        return reasons

    def _desired_up(self, ev: dict) -> int:
        """Demand model: size the fleet so observed load would sit at
        ``target_util`` of the calibrated capacity. The open-loop
        goodput curves are monotone in offered load up to the knee, and
        ``capacity_tokens_per_sec`` IS the knee's capacity estimate —
        so load / (per-replica capacity × target) is the replica count
        that keeps the fleet left of it."""
        p = self.policy
        placeable = max(1, ev["replicas_placeable"])
        cap_per = ev["capacity_tokens_per_sec"] / placeable \
            if ev["capacity_tokens_per_sec"] > 0 else 0.0
        if cap_per > 0 and ev["tokens_per_sec"] > 0:
            desired = math.ceil(
                ev["tokens_per_sec"] / (cap_per * p.target_util))
        else:
            desired = ev["replicas_total"] + 1
        return max(desired, ev["replicas_total"] + 1)

    # ------------------------------------------------------------- decide

    def _decide(self, ev: dict) -> tuple[str, str, int]:
        """Pure control law: ``(action, reason, target_replicas)``."""
        p = self.policy
        total = ev["replicas_total"]
        now = self._now()
        if total < p.min_replicas:
            self._quiet_ticks = 0
            return ("scale_up", f"below min_replicas {p.min_replicas}",
                    p.min_replicas)
        up_reasons = self._up_reasons(ev)
        if up_reasons:
            self._quiet_ticks = 0
            reason = "; ".join(up_reasons)
            if total >= p.max_replicas:
                if not self.surge.active:
                    return ("surge_on",
                            f"at max_replicas {p.max_replicas}: {reason}",
                            total)
                return ("hold", f"at max (surge active): {reason}", total)
            if now - self._last_up_t < p.up_cooldown_s:
                return ("blocked", f"scale-up cooldown: {reason}", total)
            target = min(p.max_replicas, self._desired_up(ev))
            return ("scale_up", reason, target)
        if self.surge.active:
            return ("surge_off", "overload cleared", total)
        util = ev["utilization"]
        quiet = ((util is None or util <= p.down_util)
                 and ev["queue_depth"] == 0 and ev["shed_rate"] == 0
                 and ev["surge_queue_depth"] == 0)
        if quiet:
            self._quiet_ticks += 1
        else:
            self._quiet_ticks = 0
        if quiet and total > p.min_replicas \
                and self._quiet_ticks >= p.down_stable_ticks:
            if now - self._last_down_t < p.down_cooldown_s:
                return ("blocked", "scale-down cooldown", total)
            return ("scale_down",
                    f"{self._quiet_ticks} quiet ticks "
                    f"(util {util if util is not None else 'n/a'} <= "
                    f"{p.down_util:g}, empty queue, no sheds)",
                    total - 1)
        return ("hold", "within bounds", total)

    # --------------------------------------------------------------- tick

    async def tick(self) -> dict:
        """One control cycle: observe → decide → (maybe) act → record.
        Never raises: executor failures land in the record's
        ``executor.error`` and retry naturally next cycle."""
        snap = self.router.refresh_fleet()
        ev = self._evidence(snap)
        action, reason, target = self._decide(ev)
        leader = bool(self.leader())
        executed = False
        executor_result: Optional[dict] = None
        if action in ("scale_up", "scale_down"):
            victim = None
            if action == "scale_down":
                # Never drain the prefill pool on a quiet-fleet signal:
                # the quiet evidence is DECODE-side, and losing the only
                # prefill replica kills every in-flight handoff leg
                # (docs/disaggregation.md).
                victim = self.router.table.scale_down_candidate(
                    exclude_roles=("prefill",))
                if victim is None:
                    action, reason = "blocked", ("no drainable scale-down "
                                                 f"candidate ({reason})")
            if action != "blocked" and not leader:
                action, reason = "blocked", f"not leader ({reason})"
            if action != "blocked" and self.executor is None:
                action, reason = "blocked", f"no executor ({reason})"
            if action in ("scale_up", "scale_down"):
                try:
                    faults.inject("autoscale.execute")
                    executor_result = await self.executor.scale_to(
                        target, current=ev["replicas_total"],
                        action=action, victim=victim)
                    executed = bool(executor_result.get("ok", True))
                except Exception as exc:  # noqa: BLE001 — recorded, retried
                    logger.warning("autoscale executor failed: %s", exc)
                    executor_result = {"ok": False, "added": [],
                                       "removed": [], "error": str(exc),
                                       "detail": ""}
                if executed:
                    if action == "scale_up":
                        self._last_up_t = self._now()
                    else:
                        self._last_down_t = self._now()
        if action == "surge_on":
            self.surge.set_active(True)
        elif action == "surge_off":
            self.surge.set_active(False)
        # Concurrency tracks the live fleet so the gate's bound means
        # "what the placeable replicas can hold", not a stale constant —
        # unless the operator PINNED it (an explicit constructor bound
        # or ROUTER_SURGE_CONCURRENCY is an incident-control override
        # the controller must not fight).
        if ev["replicas_placeable"] > 0 \
                and not self.surge.concurrency_pinned:
            self.surge.set_concurrency(
                ev["replicas_placeable"]
                * int(_env_float("ROUTER_SURGE_CONCURRENCY_PER_REPLICA",
                                 8)))
        self.target_replicas = target
        record = {
            "seq": self._seq,
            "unix_ms": int(time.time() * 1e3),
            "action": action,
            "reason": reason,
            "current_replicas": ev["replicas_total"],
            "target_replicas": target,
            "surge_active": self.surge.active,
            "leader": leader,
            "executed": executed,
            "executor": executor_result,
            "evidence": ev,
        }
        self._seq += 1
        self._decisions.append(record)
        self._decisions_total[action] = \
            self._decisions_total.get(action, 0) + 1
        router_metrics.gauge("router_autoscale_target_replicas").set(
            target)
        router_metrics.counter(
            "router_autoscale_decisions_total", action).inc()
        if action not in ("hold",):
            logger.info("autoscale: %s -> %d replicas (%s)", action,
                        target, reason)
        return record

    async def run(self) -> None:
        """The background loop ``create_router_app`` starts. Survives
        everything except cancellation."""
        while True:
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("autoscale cycle failed")
            await asyncio.sleep(self.policy.interval_s)

    # ----------------------------------------------------------- snapshot

    def snapshot(self, limit: int = 50) -> dict:
        """The ``GET /debug/autoscale`` payload (schema-pinned)."""
        decisions = list(self._decisions)
        if limit:
            decisions = decisions[-int(limit):]
        return {
            "enabled": True,
            "leader": bool(self.leader()),
            "executor": (type(self.executor).__name__
                         if self.executor is not None else None),
            "slo_ttft_ms": float(self.slo_ttft_ms),
            "policy": self.policy.snapshot(),
            "target_replicas": self.target_replicas,
            "surge": self.surge.snapshot(),
            "decisions_total": dict(self._decisions_total),
            "decisions": decisions,
        }


# -------------------------------------------------------------- schemas

#: Top-level ``GET /debug/autoscale`` contract.
AUTOSCALE_SCHEMA: dict[str, list[str]] = {
    "enabled": ["bool"],
    "leader": ["bool"],
    "executor": ["str", "null"],
    "slo_ttft_ms": ["num"],
    "policy": ["obj"],
    "target_replicas": ["int", "null"],
    "surge": ["obj"],
    "decisions_total": ["obj"],
    "decisions": ["list"],
}

#: One decision record in the ring.
DECISION_SCHEMA: dict[str, list[str]] = {
    "seq": ["int"],
    "unix_ms": ["int"],
    "action": ["str"],
    "reason": ["str"],
    "current_replicas": ["int"],
    "target_replicas": ["int"],
    "surge_active": ["bool"],
    "leader": ["bool"],
    "executed": ["bool"],
    "executor": ["obj", "null"],
    "evidence": ["obj"],
}

#: The per-decision evidence block — the join against ``/debug/fleet``.
EVIDENCE_SCHEMA: dict[str, list[str]] = {
    "snapshot_unix_ms": ["int"],
    "replicas_total": ["int"],
    "replicas_placeable": ["int"],
    "in_flight": ["int"],
    "queue_depth": ["int"],
    "queue_per_replica": ["num"],
    "queue_trend": ["num"],
    "utilization": ["num", "null"],
    "tokens_per_sec": ["num"],
    "capacity_tokens_per_sec": ["num"],
    "headroom_tokens_per_sec": ["num"],
    "shed_rate": ["num"],
    "slo_attainment": ["num", "null"],
    "ttft_p50_ms": ["num", "null"],
    "surge_queue_depth": ["int"],
    "roles": ["obj"],
}

#: The ``surge`` sub-block.
SURGE_SCHEMA: dict[str, list[str]] = {
    "active": ["bool"],
    "queue_depth": ["int"],
    "queue_cap": ["int"],
    "concurrency": ["int"],
    "in_flight": ["int"],
    "max_wait_s": ["num"],
    "est_wait_ms": ["num"],
    "service_ewma_ms": ["num"],
    "admitted_total": ["int"],
    "rejected": ["obj"],
}


def validate_autoscale_snapshot(snap: dict) -> list[str]:
    """Every mismatch between ``snap`` and the ``/debug/autoscale``
    contract; empty on a clean snapshot. Element-wise: each decision
    record and its evidence block are checked individually, and actions
    must come from :data:`ACTIONS`."""
    errors: list[str] = []
    _check("autoscale", snap, AUTOSCALE_SCHEMA, errors)
    if isinstance(snap.get("surge"), dict):
        _check("autoscale.surge", snap["surge"], SURGE_SCHEMA, errors)
    for i, rec in enumerate(snap.get("decisions") or []):
        section = f"autoscale.decisions[{i}]"
        _check(section, rec, DECISION_SCHEMA, errors)
        if not isinstance(rec, dict):
            continue
        if rec.get("action") not in ACTIONS:
            errors.append(f"{section}.action: {rec.get('action')!r} not "
                          f"in {ACTIONS}")
        if isinstance(rec.get("evidence"), dict):
            _check(f"{section}.evidence", rec["evidence"],
                   EVIDENCE_SCHEMA, errors)
    if isinstance(snap.get("decisions_total"), dict):
        for action, count in snap["decisions_total"].items():
            if action not in ACTIONS or not _TYPES["int"](count):
                errors.append(f"autoscale.decisions_total: bad entry "
                              f"{action!r}={count!r}")
    return errors


__all__ = [
    "ACTIONS", "AUTOSCALE_SCHEMA", "DECISION_SCHEMA", "EVIDENCE_SCHEMA",
    "SURGE_SCHEMA", "AutoscaleController", "AutoscalePolicy",
    "KubeOperatorExecutor", "LocalExecutor", "SurgeGate",
    "validate_autoscale_snapshot",
]
