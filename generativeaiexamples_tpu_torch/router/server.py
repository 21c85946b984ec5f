"""Fleet router: the asyncio HTTP front that turns N chain-server/engine
replicas into one serving endpoint.

Request path (``POST /generate``, ``/documentSearch``, and the
OpenAI-compat ``/v1/*`` surfaces):

1. read the JSON body once, hash the prompt head into chained affinity
   blocks (``table.affinity_blocks``);
2. place via :class:`~.table.ReplicaTable` (affinity + load + health —
   docs/router.md has the policy);
3. forward the raw body with the caller's correlation headers
   (``X-Request-ID``, ``X-Deadline-Ms``, ``traceparent``) intact;
4. stream the replica's response back byte-for-byte.

Failure semantics (the part routers get wrong):

- **Connect-phase failures only are retried on the next replica** —
  the ``is_connect_failure`` contract: if the connection was never
  established, the replica cannot have started generating, so a replay
  cannot double-run a generation. One bounded budget
  (``ROUTER_RETRY_ATTEMPTS``) across replicas; each failed attempt
  feeds that replica's breaker.
- A **429 ``draining``** answer is also safe to retry (the replica
  refused before doing any work) and additionally marks the replica
  draining immediately — the router need not wait for the next
  heartbeat to stop placing on it.
- **Mid-stream replica loss is RESUMED, not retried** (docs/
  robustness.md): a replay of the whole request could double-run the
  generation, but the router holds the full generation transcript
  (every byte it forwarded, held to clean UTF-8 boundaries —
  ``flight.Transcript``), so it re-places on a sibling (dead replica
  excluded, DRAINING siblings eligible — a resume is the continuation
  of an already-accepted stream) and re-submits the original body plus
  the transcript as a ``resume`` continuation block. The sibling admits
  it as prompt + generated prefix and streams only what comes AFTER the
  transcript — the transcript is the dedupe boundary; the caller sees
  no error frame, no duplicated and no dropped token. Bounded by
  ``ROUTER_RESUME_ATTEMPTS`` (default 1; 0 restores the classic
  behavior byte-for-byte). Exhausted budget / no sibling / sibling
  rejection falls back to the classic machine-readable error-frame
  contract (``\\n[error] ...`` + ``event: error`` JSON with
  ``type=replica_lost``) so clients parse a real failure instead of
  seeing a silent truncation. Either way the dead replica's breaker
  records the failure and it is marked unreachable so the NEXT request
  places elsewhere at once.
- Any other upstream HTTP status is relayed as-is — the replica's 429 /
  503 / 504 taxonomy (docs/robustness.md) already says the right thing;
  the router adds only ``503 no_replicas`` (nothing placeable) and
  ``502 replica_error`` (retry budget exhausted).

A background **heartbeat** polls each replica's ``GET /health`` every
``ROUTER_HEARTBEAT_S``: the chain server's truthful readiness body
(drain state, breaker state, the ``load`` block, and
the round-telemetry / KV-tier / capacity blocks) is the router's
entire fleet view — no engine or metrics-scrape coupling. Fault points
``router.forward`` / ``replica.heartbeat`` (tag = replica name) let
chaos plans fail or partition individual replicas (docs/robustness.md).

**Fleet observability spine** (docs/observability.md): every
routed request gets a flight timeline (``router/flight.py`` — the
placement decision with scored candidates, each connect/retry attempt,
the first upstream byte as router-observed TTFT, stream end or
mid-stream loss) behind ``GET /debug/requests``, joinable to the
replica/engine records by the forwarded ``X-Request-ID``; outcomes feed
a rolling per-replica SLO window; and ``GET /debug/fleet``
(``router/fleet.py``) folds heartbeat state, round aggregates, KV-tier
counters, the SLO window, and a step-cost-model capacity-headroom
estimate into the one snapshot an autoscaler or operator reads.

**Disaggregated prefill/decode** (docs/disaggregation.md): when the
fleet advertises a ``prefill``-role replica, long ``/generate`` prompts
(>= ``ROUTER_DISAGG_MIN_PROMPT_BYTES``, no retrieval) take a two-leg
path the router conducts: leg 1 POSTs the body to the prefill replica's
``/control/prefill`` with ``X-KV-Push-To`` naming the already-chosen
decode replica, which prefills and pushes the finished prefix pages
host-to-host; leg 2 forwards the request pinned to that decode replica
with ``X-KV-Transfer-From`` as the pull fallback, so it admits as a
near-full prefix-cache hit. The handoff is priced first
(``table.handoff_beats_prefill`` against the decode replica's
heartbeat-advertised step-cost model) and every leg-1 failure falls
back to normal in-place placement — recompute, never an error frame.
A role-less fleet never enters this path.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import random
import time
from typing import Optional, Sequence

import aiohttp
from aiohttp import web

from ..obs import alerts as obs_alerts
from ..obs import flight as obs_flight
from ..obs import history as obs_history
from ..obs import incidents as obs_incidents
from ..obs import metrics as obs_metrics
from ..utils import faults
from ..utils.logging import get_logger
from . import autoscale as router_autoscale
from . import fleet as router_fleet
from . import metrics as router_metrics
from .flight import RouterFlightRecorder, Transcript
from .table import ReplicaTable, handoff_beats_prefill

logger = get_logger(__name__)

#: Paths the router forwards, mapped to how the affinity text is pulled
#: out of the JSON body. The affinity text is the PROMPT HEAD as the
#: replica will see it lead — context/system first, then the question —
#: so a multi-turn session keeps hashing to the same leading blocks.
FORWARD_PATHS = ("/generate", "/documentSearch", "/v1/completions",
                 "/v1/chat/completions", "/v1/embeddings")

#: Correlation/robustness headers forwarded verbatim to the replica.
_FORWARD_HEADERS = ("X-Request-ID", "X-Deadline-Ms", "traceparent",
                    "Content-Type", "Accept")

#: Replica response headers relayed back to the caller.
_RELAY_HEADERS = ("Content-Type", "X-Request-ID", "Retry-After",
                  "Cache-Control")


def affinity_text(path: str, body: dict) -> str:
    """The text whose head determines placement, per forwarded route."""
    if path == "/generate":
        context = str(body.get("context", "") or "")
        question = str(body.get("question", "") or "")
        return f"{context}\n{question}" if context else question
    if path == "/v1/completions":
        prompt = body.get("prompt", "")
        return "\n".join(map(str, prompt)) if isinstance(prompt, list) \
            else str(prompt)
    if path == "/v1/chat/completions":
        msgs = body.get("messages") or []
        return "\n".join(str(m.get("content", "")) for m in msgs
                         if isinstance(m, dict))
    if path == "/v1/embeddings":
        inp = body.get("input", "")
        return "\n".join(map(str, inp)) if isinstance(inp, list) \
            else str(inp)
    return str(body.get("content", ""))  # /documentSearch


def is_connect_failure(exc: BaseException) -> bool:
    """aiohttp twin of ``serving.client.is_connect_failure``: True only
    when the failure happened ESTABLISHING the connection, so the
    request cannot have executed replica-side. ``ServerDisconnectedError``
    and payload errors arrive after the connection existed — the replica
    may have done the work; never replayed."""
    if isinstance(exc, (aiohttp.ClientConnectorError,
                        ConnectionRefusedError)):
        return True
    if isinstance(exc, ConnectionError):
        # exact builtin type only (incl. injected faults): subclasses
        # Reset/Aborted/BrokenPipe mean bytes were in flight
        return type(exc) is ConnectionError
    return False


def _error_response(status: int, err_type: str, message: str, rid: str,
                    retry_after_s: Optional[float] = None) -> web.Response:
    headers = {"X-Request-ID": rid}
    if retry_after_s is not None:
        headers["Retry-After"] = str(max(1, int(retry_after_s + 0.999)))
    return web.json_response(
        {"error": {"type": err_type, "message": message},
         "request_id": rid},
        status=status, headers=headers)


class FleetRouter:
    """Owns the table, the client session, and the heartbeat task."""

    def __init__(self, table: ReplicaTable, *,
                 heartbeat_s: float = 2.0,
                 heartbeat_timeout_s: float = 2.0,
                 retry_attempts: int = 3,
                 connect_timeout_s: float = 5.0,
                 forward_timeout_s: float = 300.0,
                 kv_transfer: bool = False,
                 kv_transfer_min_blocks: int = 2,
                 disagg_min_prompt_bytes: int = 4096,
                 disagg_prefill_timeout_s: float = 30.0,
                 heartbeat_jitter: float = 0.2,
                 resume_attempts: int = 1,
                 heartbeat_max_backoff_s: float = 30.0,
                 flight: Optional[RouterFlightRecorder] = None,
                 surge: Optional[router_autoscale.SurgeGate] = None):
        self.table = table
        # Router flight recorder + rolling SLO window (router/flight.py):
        # per-router instance, so the fleet bench's per-arm routers and
        # parallel test routers never interleave timelines or windows.
        self.flight = flight or RouterFlightRecorder()
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.retry_attempts = max(1, int(retry_attempts))
        self.connect_timeout_s = float(connect_timeout_s)
        self.forward_timeout_s = float(forward_timeout_s)
        # Cross-replica KV-page transfer (docs/kv-tiering.md): on a
        # placement whose replica misses the prompt's prefix while a
        # sibling's sketch covers it, forward an X-KV-Transfer-From
        # donor hint so the replica pulls the pages instead of
        # re-prefilling. Requires tiering (KV_HOST_POOL_TOKENS>0) on
        # the replicas; the hint is ignored where tiering is off.
        self.kv_transfer = bool(kv_transfer)
        self.kv_transfer_min_blocks = max(1, int(kv_transfer_min_blocks))
        # Disaggregated prefill/decode (docs/disaggregation.md): the
        # enable gate is the FLEET — the handoff path only triggers
        # when a prefill-role replica is placeable, so a role-less
        # fleet routes byte-for-byte as before. These knobs only tune
        # when a role-ful fleet bothers with the two-leg dance.
        self.disagg_min_prompt_bytes = max(1, int(disagg_min_prompt_bytes))
        self.disagg_prefill_timeout_s = float(disagg_prefill_timeout_s)
        # Sweep desynchronization: each heartbeat cycle sleeps
        # heartbeat_s * U(1-j, 1+j), so N routers polling one fleet (or
        # one router's restarts) never phase-lock their probe bursts.
        self.heartbeat_jitter = min(0.9, max(0.0, float(heartbeat_jitter)))
        # Mid-stream failover (docs/robustness.md): how many times ONE
        # request's stream may be resumed on a sibling after its replica
        # died on a 200. 0 = off (classic replica_lost error frame,
        # byte-for-byte — no transcript is even kept).
        self.resume_attempts = max(0, int(resume_attempts))
        # Heartbeat crash-loop backoff: consecutive probe failures to
        # one replica space its probes out exponentially (cap below)
        # instead of hammering a dead host every sweep. Router-side
        # state, not table state: the table's heartbeat_failures counter
        # is CUMULATIVE by contract (the doc-fenced metric mirrors it)
        # and must not reset on recovery.
        self.heartbeat_max_backoff_s = max(
            0.0, float(heartbeat_max_backoff_s))
        self._hb_fail_streak: dict[str, int] = {}
        self._hb_next_t: dict[str, float] = {}
        # Surge admission (router/autoscale.py): counts in-flight
        # forwards always; gates only while the autoscaler (or an
        # operator) flips it active.
        self.surge = surge or router_autoscale.SurgeGate()
        #: The attached AutoscaleController, if any (create_router_app).
        self.autoscale: Optional[router_autoscale.AutoscaleController] = \
            None
        self._session: Optional[aiohttp.ClientSession] = None
        self._hb_task: Optional[asyncio.Task] = None
        self._as_task: Optional[asyncio.Task] = None
        self._fleet: Optional[dict] = None   # last refresh_fleet() result

    # ---------------------------------------------------------- lifecycle

    async def start(self, run_heartbeat: bool = True,
                    run_autoscale: bool = True) -> None:
        if self._session is None:
            self._session = aiohttp.ClientSession()
        if run_heartbeat and self._hb_task is None:
            self._hb_task = asyncio.create_task(self._heartbeat_loop())
        if run_autoscale and self.autoscale is not None \
                and self._as_task is None:
            self._as_task = asyncio.create_task(self.autoscale.run())

    async def stop(self) -> None:
        for attr in ("_hb_task", "_as_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
                setattr(self, attr, None)
        if self._session is not None:
            await self._session.close()
            self._session = None

    # ---------------------------------------------------------- heartbeat

    async def _heartbeat_loop(self) -> None:
        while True:
            try:
                await self.heartbeat_once()
                # Background fleet aggregation: fold the fresh heartbeat
                # state + SLO window into the cached snapshot and push
                # the window/headroom gauges — /metrics stays live even
                # when nobody reads /debug/fleet.
                self.refresh_fleet()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("router heartbeat cycle failed")
            await asyncio.sleep(self._next_heartbeat_delay())

    def _next_heartbeat_delay(self) -> float:
        """Jittered sweep period: ``heartbeat_s * U(1-j, 1+j)``."""
        j = self.heartbeat_jitter
        return self.heartbeat_s * random.uniform(1.0 - j, 1.0 + j)

    async def heartbeat_once(self, force: bool = False) -> None:
        """Probe every DUE replica's /health concurrently. Each probe is
        bounded by its OWN timeout (the HTTP client timeout plus slack
        for injected stalls), so one wedged replica costs the sweep at
        most that bound — its siblings' health lands the moment their
        probes return, never behind the straggler's.

        A replica whose probes keep failing is in exponential backoff
        (``_hb_update_backoff``) and is skipped until its next-probe
        time arrives; ``force=True`` (the ``/control/heartbeat``
        endpoint — an operator asking NOW) probes everyone regardless."""
        reps = self.table.replicas()
        if not reps:
            return
        now = time.monotonic()
        due = [r for r in reps
               if force or self._hb_next_t.get(r.name, 0.0) <= now]
        if not due:
            return
        await asyncio.gather(*(self._probe_bounded(r) for r in due))
        for r in due:
            self._hb_update_backoff(r)

    def _hb_update_backoff(self, rep) -> None:
        """Crash-loop backoff bookkeeping after one probe: a failure
        doubles the spacing to this replica (``heartbeat_s * 2^(n-1)``,
        capped at ``heartbeat_max_backoff_s``); any successful probe
        resets it to the normal sweep cadence. Skipped sweeps do NOT
        advance ``last_heartbeat_t``, so ``router_heartbeat_age_seconds``
        keeps growing for a backed-off replica — the age gauge's
        semantics (seconds since the last OBSERVATION) are unchanged."""
        if rep.reachable:
            self._hb_fail_streak.pop(rep.name, None)
            self._hb_next_t.pop(rep.name, None)
            return
        streak = self._hb_fail_streak.get(rep.name, 0) + 1
        self._hb_fail_streak[rep.name] = streak
        backoff = min(self.heartbeat_max_backoff_s,
                      self.heartbeat_s * (2 ** (streak - 1)))
        self._hb_next_t[rep.name] = time.monotonic() + backoff

    async def _probe_bounded(self, rep) -> None:
        try:
            await asyncio.wait_for(self._probe(rep),
                                   timeout=self.heartbeat_timeout_s + 1.0)
        except asyncio.TimeoutError:
            logger.debug("heartbeat to %s exceeded the poll bound",
                         rep.name)
            self.table.update_health(rep.name, ok=False, ready=False)

    async def _probe(self, rep) -> None:
        try:
            # Injected faults run OFF the event loop: a delay/hang plan
            # on one replica's heartbeat must stall that one probe's
            # thread, not the loop every sibling's probe shares.
            if faults.active():
                await asyncio.get_running_loop().run_in_executor(
                    None, functools.partial(
                        faults.inject, "replica.heartbeat", tag=rep.name))
            assert self._session is not None
            async with self._session.get(
                    rep.url + "/health",
                    timeout=aiohttp.ClientTimeout(
                        total=self.heartbeat_timeout_s)) as resp:
                try:
                    body = await resp.json()
                except Exception:  # noqa: BLE001 — non-JSON health answer
                    body = None
                self.table.update_health(
                    rep.name, ok=True, ready=resp.status == 200, body=body)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — any probe failure
            logger.debug("heartbeat to %s failed: %s", rep.name, exc)
            self.table.update_health(rep.name, ok=False, ready=False)

    # --------------------------------------------------------- membership

    async def remove_replica(self, name: str, *, drain: bool = True,
                             wait_s: float = 30.0,
                             poll_s: float = 0.1) -> bool:
        """Remove a replica from the table — the scale-down/rollout
        path. With ``drain`` (the default), placement stops IMMEDIATELY
        (the table marks it draining), the replica's own admission is
        closed via ``POST /control/drain``, and the removal waits up to
        ``wait_s`` for its in-flight streams to finish — a streaming
        replica is never dropped mid-token. The replica's SLO-window
        rows are forgotten with it, so a later re-add under the same
        name starts with clean attainment (and a fresh sketch + breaker,
        via ``table.add``'s reset semantics)."""
        rep = self.table.get(name)
        if rep is None:
            return False
        if drain:
            self.table.mark_draining(name)
            assert self._session is not None
            try:
                async with self._session.post(
                        rep.url + "/control/drain",
                        timeout=aiohttp.ClientTimeout(
                            total=self.heartbeat_timeout_s)) as resp:
                    await resp.read()
            except Exception as exc:  # noqa: BLE001 — dead replica: done
                logger.info("drain of %s unreachable (%s); removing",
                            name, exc)
            else:
                deadline = time.monotonic() + max(0.0, float(wait_s))
                while time.monotonic() < deadline:
                    in_flight = await self._drain_in_flight(rep)
                    if in_flight is None or in_flight <= 0:
                        break
                    await asyncio.sleep(poll_s)
                else:
                    logger.warning(
                        "drain of %s still has streams in flight after "
                        "%.1fs budget; removing anyway", name, wait_s)
        self.table.remove(name)
        self.flight.slo.forget(name)
        self._hb_fail_streak.pop(name, None)
        self._hb_next_t.pop(name, None)
        return True

    async def _drain_in_flight(self, rep) -> Optional[int]:
        """The draining replica's in-flight stream count from /health
        (a drained replica answers 503 — the BODY is the signal)."""
        try:
            assert self._session is not None
            async with self._session.get(
                    rep.url + "/health",
                    timeout=aiohttp.ClientTimeout(
                        total=self.heartbeat_timeout_s)) as resp:
                body = await resp.json()
            return int((body.get("load") or {}).get("in_flight", 0))
        except Exception:  # noqa: BLE001 — unreachable: nothing to wait on
            return None

    # -------------------------------------------------------------- fleet

    def refresh_fleet(self) -> dict:
        """Build the fleet snapshot (``GET /debug/fleet``) from the
        table's heartbeat-carried state + the SLO window, and publish
        the derived gauges. Pure local fold — cheap enough to also run
        on demand for the endpoint, so the view is never staler than
        the last heartbeat."""
        self.flight.slo.publish(
            [r.name for r in self.table.replicas()])
        self.table.publish_heartbeat_ages()
        snap = router_fleet.build_fleet_snapshot(
            self.table, self.flight.slo, heartbeat_s=self.heartbeat_s)
        router_fleet.publish_fleet_gauges(snap)
        self._fleet = snap
        return snap

    # ------------------------------------------------------------ forward

    async def forward(self, request: web.Request) -> web.StreamResponse:
        # Router flight timeline (router/flight.py): keyed by the SAME
        # X-Request-ID forwarded below, so the router's record joins the
        # replica's /debug/requests timeline and the engine's round
        # grants by one ID. Begun BEFORE surge admission so a surge 429
        # still has a timeline and an SLO-window row.
        tl = self.flight.begin_request(request.headers, request.path)
        # Surge admission (docs/autoscaling.md): while the autoscaler
        # holds the gate active (fleet at max and overloaded), a bounded
        # wait queue fronts placement and the rejections are honest
        # backpressure — Retry-After from the measured queue-wait
        # estimate, fast 429 for deadlines the queue would eat whole.
        try:
            ticket, rejection = await self.surge.enter(
                deadline_ms=tl.meta.get("deadline_ms"))
        except asyncio.CancelledError:
            # Caller hung up while QUEUED in the surge gate (the
            # overload case exactly): the gate cleaned its own slot up;
            # the timeline must still retire or the in-flight map leaks
            # one entry per impatient caller.
            self.flight.complete_request(tl, outcome="disconnect")
            raise
        except BaseException:
            self.flight.complete_request(tl, outcome="error")
            raise
        if rejection is not None:
            err_type, est_wait_ms = rejection
            self.flight.complete_request(tl, outcome="shed", status=429)
            return _error_response(
                429, err_type,
                f"fleet is at capacity ({err_type}); estimated queue "
                f"wait {est_wait_ms:.0f} ms", tl.request_id,
                retry_after_s=est_wait_ms / 1e3)
        try:
            raw = await request.read()
            try:
                body = json.loads(raw) if raw else {}
            except (ValueError, UnicodeDecodeError):
                body = {}
            blocks = self.table.affinity_blocks(
                affinity_text(request.path, body if isinstance(body, dict)
                              else {}))
            handed = await self._try_disagg(request, raw, body, blocks,
                                            tl)
            if handed is not None:
                return handed
            return await self._forward_attempts(request, raw, blocks, tl)
        except asyncio.CancelledError:
            # Caller hung up while we were placing/connecting/streaming:
            # retire the timeline (idempotent — a relay that already
            # completed it wins) so the in-flight map can never leak.
            self.flight.complete_request(tl, outcome="disconnect")
            raise
        except BaseException:
            self.flight.complete_request(tl, outcome="error")
            raise
        finally:
            self.surge.exit(ticket)

    async def _try_disagg(self, request: web.Request, raw: bytes,
                          body, blocks: Sequence[bytes],
                          tl) -> Optional[web.StreamResponse]:
        """The disaggregated prefill/decode handoff, or None to take
        the normal path (docs/disaggregation.md).

        Eligibility: a ``/generate`` body at least
        ``disagg_min_prompt_bytes`` long, no retrieval (the replica
        augments the prompt server-side, so the router cannot pre-run
        it on a different chip), a placeable prefill-role replica, and
        the priced rule saying moving the finished pages beats
        re-prefilling on the decode replica. The decode replica is
        chosen FIRST — the prefill replica pushes straight to it — and
        every leg-1 failure degrades to plain placement on that same
        replica: recompute costs TTFT, never correctness."""
        if request.path != "/generate" or not isinstance(body, dict):
            return None
        if body.get("use_knowledge_base"):
            return None
        if len(raw) < self.disagg_min_prompt_bytes:
            return None
        prefill = self.table.prefill_candidate()
        if prefill is None:
            return None
        rep, decision = self.table.place_explained(blocks)
        if rep is None:
            return None
        pinned = (rep, decision)
        if not handoff_beats_prefill(rep.capacity, len(raw)):
            # Priced out (tiny pages / fast prefill): same placement,
            # no handoff leg. Reuse the decision — re-placing would
            # double-count the selection.
            return await self._forward_attempts(request, raw, blocks,
                                                tl, pinned=pinned)
        reason = ""
        t0 = time.monotonic()
        try:
            assert self._session is not None
            async with self._session.post(
                    prefill.url + "/control/prefill", data=raw,
                    headers={"X-KV-Push-To": rep.url,
                             "X-Request-ID": tl.request_id,
                             "Content-Type": "application/json"},
                    timeout=aiohttp.ClientTimeout(
                        total=self.disagg_prefill_timeout_s)) as up:
                if up.status == 200:
                    try:
                        info = await up.json()
                    except Exception:  # noqa: BLE001 — not the contract
                        info = {}
                    if int(info.get("blocks", 0) or 0) > 0 \
                            and info.get("pushed"):
                        prefill.breaker.record_success()
                    else:
                        reason = "no_pages"
                else:
                    reason = "prefill_error"
        except asyncio.CancelledError:
            raise
        except asyncio.TimeoutError:
            reason = "prefill_timeout"
        except Exception as exc:  # noqa: BLE001 — any leg-1 failure
            logger.info("disagg prefill leg via %s failed (%s); "
                        "falling back to recompute", prefill.name, exc)
            reason = "prefill_error"
        tl.stage("router_disagg_prefill", time.monotonic() - t0)
        if reason:
            router_metrics.counter(
                "router_disagg_fallbacks_total", reason).inc()
            tl.event("disagg_fallback", f"{prefill.name}:{reason}")
            return await self._forward_attempts(request, raw, blocks,
                                                tl, pinned=pinned)
        router_metrics.counter("router_disagg_handoffs_total").inc()
        tl.event("disagg_handoff", prefill.name)
        return await self._forward_attempts(
            request, raw, blocks, tl, pinned=pinned,
            donor_override=prefill.url)

    async def _forward_attempts(self, request: web.Request, raw: bytes,
                                blocks: Sequence[bytes],
                                tl, *,
                                pinned: Optional[tuple] = None,
                                donor_override: Optional[str] = None
                                ) -> web.StreamResponse:
        rid = tl.request_id
        fwd_headers = {"X-Request-ID": rid}
        for h in _FORWARD_HEADERS:
            if h in request.headers and h not in fwd_headers:
                fwd_headers[h] = request.headers[h]

        tried: list[str] = []
        last_err: Optional[str] = None
        fallback: Optional[web.Response] = None
        fallback_rep = ""
        for _ in range(self.retry_attempts):
            t_place = time.monotonic()
            if pinned is not None:
                # Disagg handoff (docs/disaggregation.md): the decode
                # replica was chosen BEFORE the prefill leg so the pages
                # could be pushed to it — first attempt lands there;
                # retries fall back to normal placement.
                rep, decision = pinned
                pinned = None
            else:
                rep, decision = self.table.place_explained(blocks,
                                                           exclude=tried)
            if rep is None:
                break
            tried.append(rep.name)
            # Fleet-wide cache: a placement miss with a covering sibling
            # carries a donor hint — recomputed per attempt, since the
            # donor depends on who was chosen.
            fwd_headers.pop("X-KV-Transfer-From", None)
            donor: Optional[str] = None
            if donor_override is not None:
                # The handoff's pull fallback: if the prefill replica's
                # push raced admission, the decode replica fetches the
                # pages from it by the ordinary transfer leg.
                donor = donor_override
                fwd_headers["X-KV-Transfer-From"] = donor
                donor_override = None
            elif self.kv_transfer and blocks:
                donor = self.table.transfer_donor(
                    blocks, chosen=rep.name,
                    min_blocks=self.kv_transfer_min_blocks)
                if donor is not None:
                    fwd_headers["X-KV-Transfer-From"] = donor
                    router_metrics.counter(
                        "router_kv_transfer_hints_total").inc()
            self.flight.placement(
                tl, replica=rep.name,
                affinity_blocks=int(decision.get("affinity_blocks", 0)),
                candidates=decision.get("candidates", []),
                t_start=t_place, kv_donor=donor)
            t_conn = time.monotonic()
            try:
                faults.inject("router.forward", tag=rep.name)
                assert self._session is not None
                upstream = await self._session.post(
                    rep.url + request.path, data=raw, headers=fwd_headers,
                    timeout=aiohttp.ClientTimeout(
                        total=self.forward_timeout_s,
                        sock_connect=self.connect_timeout_s))
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # noqa: BLE001 — classified below
                if not is_connect_failure(exc):
                    # The connection existed; the replica may have run
                    # the request. Never replayed.
                    rep.breaker.record_failure()
                    logger.warning("forward to %s failed post-connect: %s",
                                   rep.name, exc)
                    self.flight.attempt_failed(
                        tl, replica=rep.name, reason="post_connect",
                        retried=False)
                    self.flight.complete_request(
                        tl, outcome="error", replica=rep.name, status=502)
                    return _error_response(
                        502, "replica_error",
                        f"replica {rep.name} failed: {exc}", rid)
                rep.breaker.record_failure()
                router_metrics.counter(
                    "router_retries_total", "connect").inc()
                self.flight.attempt_failed(
                    tl, replica=rep.name, reason="connect", retried=True)
                last_err = f"{rep.name}: {exc}"
                logger.info("connect to replica %s failed (%s); trying "
                            "next", rep.name, exc)
                continue
            # Connect + time-to-upstream-headers (for /generate the
            # replica pulls the first chunk before committing to a 200,
            # so this stage absorbs the replica-side TTFT work).
            tl.stage("router_connect", time.monotonic() - t_conn)
            try:
                return await self._relay(request, rep, upstream, rid,
                                         blocks, tried, tl,
                                         raw=raw, fwd_headers=fwd_headers)
            except _RetryNextReplica as retry:
                last_err = f"{rep.name}: {retry.reason}"
                fallback = retry.response
                fallback_rep = rep.name
                self.flight.attempt_failed(
                    tl, replica=rep.name, reason=retry.reason,
                    retried=True)
                continue
        if fallback is not None:
            # Every placeable replica refused as draining: relay the 429
            # — a rollout must look like backpressure to callers
            # (Retry-After and all), never a hard 502.
            self.flight.complete_request(
                tl, outcome="shed", replica=fallback_rep,
                status=fallback.status)
            return fallback
        if not tried:
            self.flight.complete_request(tl, outcome="shed", status=503)
            return _error_response(
                503, "no_replicas",
                "no placeable replica (all draining, unreachable, or "
                "breaker-open)", rid, retry_after_s=self.heartbeat_s)
        self.flight.complete_request(tl, outcome="error", status=502)
        return _error_response(
            502, "replica_error",
            f"all forward attempts failed (tried {', '.join(tried)}); "
            f"last: {last_err}", rid, retry_after_s=self.heartbeat_s)

    async def _relay(self, request: web.Request, rep,
                     upstream: aiohttp.ClientResponse, rid: str,
                     blocks: Sequence[bytes],
                     tried: list,
                     tl=None, *,
                     raw: bytes = b"",
                     fwd_headers: Optional[dict] = None
                     ) -> web.StreamResponse:
        """Stream one upstream answer back; raises _RetryNextReplica for
        the one retry-safe HTTP answer (429 draining, pre-work). ``tl``
        is the request's router timeline — first upstream body byte
        stamps the router-observed TTFT, and the terminal transition
        (stream end / mid-stream loss / caller disconnect / relayed
        error status) retires it into the SLO window.

        With failover on (``resume_attempts > 0``) a ``/generate``
        stream keeps a :class:`~.flight.Transcript` of every byte
        forwarded; on mid-stream loss the stream is resumed on a sibling
        (``_attempt_resume``) and the caller never sees the seam —
        ``raw``/``fwd_headers`` are kept for exactly that re-submission.
        A resumed request that completes is an ``ok`` outcome attributed
        to the FINISHING replica, not a ``midstream_loss`` (the dead
        replica still pays breaker + unreachable)."""
        try:
            if upstream.status == 429:
                data = await upstream.read()
                err_type = ""
                try:
                    err_type = json.loads(data)["error"]["type"]
                except Exception:  # noqa: BLE001 — not the JSON contract
                    pass
                if err_type == "draining":
                    # The replica refused BEFORE doing any work, so a
                    # sibling can safely take it; stop placing here now
                    # instead of at the next heartbeat. The rendered 429
                    # rides along as the fallback answer for when no
                    # sibling remains.
                    self.table.mark_draining(rep.name)
                    rep.breaker.record_success()  # alive — just draining
                    router_metrics.counter(
                        "router_retries_total", "draining").inc()
                    raise _RetryNextReplica(
                        "draining",
                        response=self._relay_body(upstream, data))
                # Genuine backpressure (queue_full, deadline_unmeetable):
                # relay — the Retry-After hint is the replica's to give.
                self.flight.complete_request(
                    tl, outcome="shed", replica=rep.name, status=429)
                return self._relay_body(upstream, data)
            rep.breaker.record_success()
            if upstream.status >= 400:
                # 503/504 are backpressure/deadline sheds in the replica
                # taxonomy (docs/robustness.md); everything else relayed
                # at >= 400 is an error outcome.
                self.flight.complete_request(
                    tl, outcome=("shed" if upstream.status in (503, 504)
                                 else "error"),
                    replica=rep.name, status=upstream.status)
                return self._relay_body(upstream, await upstream.read())
            # 2xx: commit the placement (the sketch learns this prompt)
            # and stream the body through as it arrives.
            self.table.record_placement(rep, blocks)
            resp = web.StreamResponse(status=upstream.status)
            for h in _RELAY_HEADERS:
                if h in upstream.headers:
                    resp.headers[h] = upstream.headers[h]
            resp.headers["X-Routed-Replica"] = rep.name
            await resp.prepare(request)
            # Generation transcript (docs/robustness.md): every byte
            # forwarded downstream, held to clean UTF-8 boundaries —
            # the resume continuation AND its dedupe boundary. Only
            # kept when failover could use it; with resume off the
            # stream path below is byte-for-byte the classic one.
            transcript = (Transcript()
                          if (self.resume_attempts > 0
                              and request.path == "/generate")
                          else None)
            resume_attempt = 0
            # Upstream reads and downstream writes fail for OPPOSITE
            # reasons and must not share an except: a read failure is
            # the REPLICA dying (breaker + unreachable + error frame); a
            # write failure is the CALLER hanging up, which says nothing
            # about the replica's health — misfiling it would let a few
            # impatient clients trip a healthy replica's breaker.
            t_stream = time.monotonic()
            outcome = "ok"
            chunks = upstream.content.iter_any()
            while True:
                try:
                    chunk = await chunks.__anext__()
                except StopAsyncIteration:
                    break
                except (aiohttp.ClientError, ConnectionError,
                        asyncio.TimeoutError) as exc:
                    # Replica died mid-stream: tokens already went out
                    # on a 200, so NO replay of the whole request. The
                    # dead replica pays either way: breaker failure +
                    # unreachable, so the NEXT request places elsewhere
                    # immediately.
                    rep.breaker.record_failure()
                    self.table.mark_unreachable(rep.name)
                    logger.warning("replica %s lost mid-stream: %s",
                                   rep.name, exc)
                    if tl is not None:
                        tl.event("midstream_loss", rep.name)
                    # Failover (docs/robustness.md): resume the stream
                    # on a sibling from the transcript. On success the
                    # caller's stream simply continues — swap upstream
                    # and keep relaying.
                    if transcript is not None:
                        resume_attempt += 1
                        new_up, new_rep = await self._attempt_resume(
                            rep, rid, raw, fwd_headers or {}, blocks,
                            tried, transcript, resume_attempt, tl)
                        if new_up is not None:
                            upstream.release()
                            upstream, rep = new_up, new_rep
                            chunks = upstream.content.iter_any()
                            continue
                    # No resume: degrade with the machine-readable
                    # error frame (chat_client parses it into
                    # last_error), flushing the transcript's held-back
                    # tail first — the caller gets every byte the dead
                    # replica generated, then the failure.
                    outcome = "midstream_loss"
                    tail = (transcript.flush() if transcript is not None
                            else b"")
                    frame = (f"\n[error] replica {rep.name} lost "
                             f"mid-stream"
                             + "\n\nevent: error\ndata: " + json.dumps(
                                 {"error": "replica_lost",
                                  "message": f"replica {rep.name} lost "
                                             f"mid-stream: {exc}",
                                  "replica": rep.name,
                                  "request_id": rid}) + "\n\n")
                    try:
                        await resp.write(tail + frame.encode("utf-8"))
                    except (ConnectionError, ConnectionResetError):
                        pass  # caller gone too
                    break
                # First upstream body byte = the router-observed TTFT
                # (idempotent; only the first chunk stamps it).
                self.flight.first_byte(tl)
                if transcript is not None:
                    # Forward only up to a clean UTF-8 boundary; the
                    # held-back tail (<= 3 bytes) goes out on EOF.
                    chunk = transcript.push(chunk)
                    if not chunk:
                        continue
                try:
                    await resp.write(chunk)
                except (ConnectionError, ConnectionResetError) as exc:
                    logger.debug("caller disconnected mid-stream: %s",
                                 exc)
                    # Abort the upstream stream (don't drain it): the
                    # replica sees the disconnect and cancels the
                    # generation instead of decoding to a dead socket.
                    upstream.close()
                    outcome = "disconnect"
                    break
            if transcript is not None and outcome == "ok":
                tail = transcript.flush()
                if tail:
                    try:
                        await resp.write(tail)
                    except (ConnectionError, ConnectionResetError):
                        outcome = "disconnect"
            try:
                await resp.write_eof()
            except (ConnectionError, ConnectionResetError):
                pass
            if tl is not None:
                tl.stage("router_stream", time.monotonic() - t_stream)
            self.flight.complete_request(
                tl, outcome=outcome, replica=rep.name,
                status=upstream.status)
            return resp
        finally:
            upstream.release()

    async def _attempt_resume(self, dead_rep, rid: str, raw: bytes,
                              fwd_headers: dict, blocks: Sequence[bytes],
                              tried: list, transcript: Transcript,
                              attempt: int, tl
                              ) -> tuple[
                                  Optional[aiohttp.ClientResponse],
                                  Optional[object]]:
        """One mid-stream resume attempt: place a sibling (draining
        included — a resume continues an already-accepted stream, the
        rollout contract), re-submit the original body plus the
        transcript as a ``resume`` continuation block, and return the
        new 200 upstream to keep relaying from. ``(None, None)`` means
        the caller falls back to the classic error frame. Every attempt
        lands a ``router_resume_total{outcome=}`` count and a ``resume``
        timeline event — the failure legs are observable, never
        silent."""
        def _fail(outcome: str, **extra) -> tuple[None, None]:
            router_metrics.counter("router_resume_total", outcome).inc()
            if tl is not None:
                tl.event("resume", dict(extra, outcome=outcome,
                                        attempt=attempt,
                                        **{"from": dead_rep.name}))
            logger.info("resume of %s after %s died mid-stream: %s",
                        rid, dead_rep.name, outcome)
            return None, None

        if attempt > self.resume_attempts:
            return _fail("budget_exhausted")
        if transcript.overflowed:
            return _fail("overflow")
        rep, decision = self.table.place_explained(
            blocks, exclude=tried, include_draining=True)
        if rep is None:
            return _fail("no_replica")
        tried.append(rep.name)
        try:
            body = json.loads(raw) if raw else {}
        except (ValueError, UnicodeDecodeError):
            body = {}
        if not isinstance(body, dict):
            body = {}
        body["resume"] = {"text": transcript.text, "attempt": attempt}
        headers = dict(fwd_headers)
        headers["Content-Type"] = "application/json"
        # Deadline carried over, not restarted: the sibling gets what
        # is LEFT of the caller's budget.
        deadline_ms = (tl.meta.get("deadline_ms")
                       if tl is not None else None)
        if deadline_ms is not None:
            elapsed_ms = (time.monotonic() - tl.t_start) * 1e3
            headers["X-Deadline-Ms"] = str(
                max(1, int(deadline_ms - elapsed_ms)))
        # Donor hint recomputed for the NEW placement (the dead replica
        # can't serve pulls): a warm sibling makes the replayed prefix
        # a priced page fetch instead of a re-prefill.
        headers.pop("X-KV-Transfer-From", None)
        if self.kv_transfer and blocks:
            donor = self.table.transfer_donor(
                blocks, chosen=rep.name,
                min_blocks=self.kv_transfer_min_blocks)
            if donor is not None:
                headers["X-KV-Transfer-From"] = donor
        t0 = time.monotonic()
        try:
            assert self._session is not None
            upstream = await self._session.post(
                rep.url + "/generate",
                data=json.dumps(body).encode("utf-8"), headers=headers,
                timeout=aiohttp.ClientTimeout(
                    total=self.forward_timeout_s,
                    sock_connect=self.connect_timeout_s))
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — any resume-leg failure
            rep.breaker.record_failure()
            return _fail("connect_fail", to=rep.name, error=str(exc))
        if upstream.status != 200:
            reason = ""
            try:
                reason = json.loads(
                    await upstream.read())["error"]["type"]
            except Exception:  # noqa: BLE001 — not the JSON contract
                pass
            upstream.release()
            return _fail("rejected", to=rep.name, status=upstream.status,
                         reason=reason)
        rep.breaker.record_success()
        self.table.record_placement(rep, blocks)
        if tl is not None:
            tl.stage("router_resume", time.monotonic() - t0)
        replayed = 0
        try:
            replayed = int(upstream.headers.get("X-Resume-Replayed", 0))
        except ValueError:
            pass
        router_metrics.counter("router_resume_total", "ok").inc()
        router_metrics.gauge("router_resume_replay_tokens").set(
            float(replayed))
        if tl is not None:
            tl.event("resume", {"outcome": "ok", "from": dead_rep.name,
                                "to": rep.name, "attempt": attempt,
                                "replayed_tokens": replayed})
            tl.annotate(resumed=attempt, resume_to=rep.name)
        # The held-back tail belongs to a token the sibling regenerates
        # (it replays from the transcript, which never included it).
        transcript.discard_pending()
        logger.info("resumed %s on %s after %s died mid-stream "
                    "(%d chars replayed as %d tokens)", rid, rep.name,
                    dead_rep.name, len(transcript.text), replayed)
        return upstream, rep

    @staticmethod
    def _relay_body(upstream: aiohttp.ClientResponse,
                    data: Optional[bytes] = None) -> web.Response:
        headers = {h: upstream.headers[h] for h in _RELAY_HEADERS
                   if h in upstream.headers}
        # web.Response sets Content-Type via its own keyword; passing it
        # in headers too raises.
        ctype = headers.pop("Content-Type", "application/octet-stream")
        return web.Response(status=upstream.status, body=data or b"",
                            content_type=ctype.split(";")[0],
                            headers=headers)


class _RetryNextReplica(Exception):
    def __init__(self, reason: str,
                 response: Optional[web.Response] = None):
        super().__init__(reason)
        self.reason = reason
        self.response = response  # relayed if no sibling can take it


try:  # typed app-state key (aiohttp >= 3.9); tests reach the router by it
    ROUTER = web.AppKey("fleet_router", FleetRouter)
except AttributeError:  # older aiohttp: plain string key
    ROUTER = "fleet_router"  # type: ignore[assignment]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def create_router_app(replicas: Sequence[tuple[str, str]] = (), *,
                      table: Optional[ReplicaTable] = None,
                      policy: Optional[str] = None,
                      heartbeat_s: Optional[float] = None,
                      retry_attempts: Optional[int] = None,
                      kv_transfer: Optional[bool] = None,
                      resume_attempts: Optional[int] = None,
                      run_heartbeat: bool = True,
                      autoscale: Optional[
                          "router_autoscale.AutoscaleController"] = None,
                      autoscale_factory: Optional[callable] = None,
                      run_autoscale: bool = True) -> web.Application:
    """Build the router app. ``replicas`` is (name, url) pairs; pass a
    pre-built ``table`` instead to control scoring knobs. Env defaults:
    ``ROUTER_POLICY``, ``ROUTER_HEARTBEAT_S`` /
    ``ROUTER_HEARTBEAT_JITTER``, ``ROUTER_RETRY_ATTEMPTS``,
    ``ROUTER_AFFINITY_BLOCK_BYTES`` / ``ROUTER_AFFINITY_HEAD_BYTES`` /
    ``ROUTER_SKETCH_CAP``, ``ROUTER_BREAKER_FAILURES`` /
    ``ROUTER_BREAKER_COOLDOWN_S``, ``ROUTER_CONNECT_TIMEOUT_S`` /
    ``ROUTER_FORWARD_TIMEOUT_S``, ``ROUTER_KV_TRANSFER`` /
    ``ROUTER_KV_TRANSFER_MIN_BLOCKS`` (docs/router.md),
    ``ROUTER_DISAGG_MIN_PROMPT_BYTES`` /
    ``ROUTER_DISAGG_PREFILL_TIMEOUT_S`` (docs/disaggregation.md),
    ``ROUTER_RESUME_ATTEMPTS`` / ``ROUTER_TRANSCRIPT_MAX_BYTES`` /
    ``ROUTER_HEARTBEAT_MAX_BACKOFF_S`` (docs/robustness.md), and the
    autoscaler/surge knobs (``ROUTER_AUTOSCALE*`` / ``ROUTER_SURGE_*``,
    docs/autoscaling.md). ``autoscale_factory`` builds a controller
    bound to the finished router (``factory(router) -> controller``);
    ``autoscale`` attaches one already built; ``ROUTER_AUTOSCALE=1``
    builds the env-configured default (dry-run decisions + surge
    admission unless an executor is configured)."""
    if table is None:
        table = ReplicaTable(
            policy=policy or os.environ.get("ROUTER_POLICY", "affinity"),
            block_bytes=int(_env_float("ROUTER_AFFINITY_BLOCK_BYTES", 64)),
            head_bytes=int(_env_float("ROUTER_AFFINITY_HEAD_BYTES", 4096)),
            sketch_cap=int(_env_float("ROUTER_SKETCH_CAP", 2048)),
            breaker_failures=int(_env_float("ROUTER_BREAKER_FAILURES", 3)),
            breaker_cooldown_s=_env_float("ROUTER_BREAKER_COOLDOWN_S", 10))
    elif policy is not None:
        table.policy = policy
    for name, url in replicas:
        table.add(name, url)
    router = FleetRouter(
        table,
        heartbeat_s=(heartbeat_s if heartbeat_s is not None
                     else _env_float("ROUTER_HEARTBEAT_S", 2.0)),
        heartbeat_timeout_s=_env_float("ROUTER_HEARTBEAT_TIMEOUT_S", 2.0),
        retry_attempts=(retry_attempts if retry_attempts is not None
                        else int(_env_float("ROUTER_RETRY_ATTEMPTS", 3))),
        connect_timeout_s=_env_float("ROUTER_CONNECT_TIMEOUT_S", 5.0),
        forward_timeout_s=_env_float("ROUTER_FORWARD_TIMEOUT_S", 300.0),
        kv_transfer=(kv_transfer if kv_transfer is not None
                     else os.environ.get("ROUTER_KV_TRANSFER", "")
                     not in ("", "0", "false", "off")),
        kv_transfer_min_blocks=int(
            _env_float("ROUTER_KV_TRANSFER_MIN_BLOCKS", 2)),
        disagg_min_prompt_bytes=int(
            _env_float("ROUTER_DISAGG_MIN_PROMPT_BYTES", 4096)),
        disagg_prefill_timeout_s=_env_float(
            "ROUTER_DISAGG_PREFILL_TIMEOUT_S", 30.0),
        heartbeat_jitter=_env_float("ROUTER_HEARTBEAT_JITTER", 0.2),
        resume_attempts=(resume_attempts if resume_attempts is not None
                         else int(_env_float("ROUTER_RESUME_ATTEMPTS",
                                             1))),
        heartbeat_max_backoff_s=_env_float(
            "ROUTER_HEARTBEAT_MAX_BACKOFF_S", 30.0))

    if autoscale is None and autoscale_factory is not None:
        autoscale = autoscale_factory(router)
    if autoscale is None and os.environ.get(
            "ROUTER_AUTOSCALE", "") not in ("", "0", "false", "off"):
        autoscale = router_autoscale.AutoscaleController(
            router,
            policy=router_autoscale.AutoscalePolicy.from_env(
                max_replicas=max(1, len(table.replicas()))
                if not os.environ.get("ROUTER_AUTOSCALE_MAX") else None),
            executor=None, surge=router.surge)
    if autoscale is not None:
        router.autoscale = autoscale
        router.surge = autoscale.surge

    app = web.Application(client_max_size=100 * 1024 ** 2)
    app[ROUTER] = router

    async def health(request: web.Request) -> web.Response:
        reps = table.snapshot()
        healthy = sum(1 for r in reps if r["placeable"])
        return web.json_response(
            {"status": "ok" if healthy else "no_replicas",
             "replicas_healthy": healthy, "replicas_total": len(reps)},
            status=200 if healthy else 503)

    async def metrics_endpoint(request: web.Request) -> web.Response:
        # Scrape-time refresh: heartbeat ages recompute from the live
        # table, so a STALLED poller reads as a growing age — a frozen
        # gauge would hide exactly the failure it exists to show.
        table.publish_heartbeat_ages()
        obs_metrics.record_process_stats()
        return web.Response(text=obs_metrics.REGISTRY.render_prometheus(),
                            content_type="text/plain")

    async def debug_requests(request: web.Request) -> web.Response:
        # Router flight recorder: in-flight + last-N routed-request
        # timelines (router/flight.py; same endpoint contract as the
        # chain/model servers via the shared handler body).
        return obs_flight.debug_requests_response(
            request, recorder=router.flight)

    async def debug_fleet(request: web.Request) -> web.Response:
        # The fleet snapshot (router/fleet.py): per-replica rows + fleet
        # totals + capacity headroom. Rebuilt from local state on every
        # GET — never staler than the last heartbeat.
        return web.json_response(router.refresh_fleet())

    async def list_replicas(request: web.Request) -> web.Response:
        return web.json_response({"replicas": table.snapshot(),
                                  "policy": table.policy})

    async def control_replicas(request: web.Request) -> web.Response:
        """Runtime table edits — dynamic membership, the rollout AND
        autoscale story's API:
        ``{"op": "add", "name": "r2", "url": "http://..."}`` /
        ``{"op": "remove", "name": "r2", "drain": true,
        "wait_s": 30}``. Adds probe immediately (traffic flows without
        waiting a heartbeat); removes default to DRAIN-ON-REMOVE —
        placement stops at once, the replica's admission closes, and
        the call returns after its in-flight streams finish (or the
        wait budget expires). ``"drain": false`` is the hard-remove
        escape hatch for an already-dead replica."""
        body = await request.json()
        op, name = body.get("op"), body.get("name", "")
        if op == "add":
            if not name or not body.get("url"):
                raise web.HTTPUnprocessableEntity(
                    text="add needs 'name' and 'url'")
            rep = table.add(name, body["url"])
            # A re-add under a known name is a NEW pod: its window rows
            # (like its sketch and breaker, reset by table.add) must not
            # carry the old pod's history — nor its heartbeat backoff.
            router.flight.slo.forget(name)
            router._hb_fail_streak.pop(name, None)
            router._hb_next_t.pop(name, None)
            # Probe now: an added replica that is already up starts
            # taking traffic without waiting a full heartbeat period.
            await router._probe(rep)
            return web.json_response({"status": "added",
                                      "replica": rep.snapshot()})
        if op == "remove":
            drain = bool(body.get("drain", True))
            wait_s = float(body.get("wait_s", 30.0))
            found = await router.remove_replica(name, drain=drain,
                                                wait_s=wait_s)
            return web.json_response(
                {"status": ("removed" if found else "absent"),
                 "drained": bool(found and drain)},
                status=200 if found else 404)
        raise web.HTTPUnprocessableEntity(text="op must be add|remove")

    async def debug_autoscale(request: web.Request) -> web.Response:
        """The autoscaler's decision ring + surge state
        (docs/autoscaling.md; schema-pinned by
        ``router.autoscale.validate_autoscale_snapshot``)."""
        if router.autoscale is None:
            return web.json_response(
                {"enabled": False, "surge": router.surge.snapshot()})
        limit = obs_history.query_int(request, "limit", 50, minimum=0)
        return web.json_response(router.autoscale.snapshot(limit=limit))

    async def control_autoscale(request: web.Request) -> web.Response:
        """Ops/test surface: ``{"op": "tick"}`` runs one control cycle
        NOW and returns its decision record; ``{"op": "surge",
        "active": bool}`` overrides the surge gate by hand (incident
        control when the autoscaler is not attached)."""
        body = await request.json()
        op = body.get("op")
        if op == "tick":
            if router.autoscale is None:
                raise web.HTTPConflict(text="no autoscaler attached")
            return web.json_response(await router.autoscale.tick())
        if op == "surge":
            router.surge.set_active(bool(body.get("active", False)))
            return web.json_response(router.surge.snapshot())
        raise web.HTTPUnprocessableEntity(text="op must be tick|surge")

    async def control_heartbeat(request: web.Request) -> web.Response:
        """Force one heartbeat cycle now (ops/tests) — probes every
        replica, crash-loop backoff notwithstanding."""
        await router.heartbeat_once(force=True)
        router.refresh_fleet()
        return web.json_response({"replicas": table.snapshot()})

    async def forward(request: web.Request) -> web.StreamResponse:
        return await router.forward(request)

    # Retained telemetry (docs/observability.md): the router's history
    # ring samples the fleet gauges the heartbeat publishes (ages
    # refreshed per sample, same as per scrape), the alert engine runs
    # the FLEET rule set (SLO burn rate, heartbeat staleness), and
    # incident capture is ASYNC — the sampler thread fires, a loop
    # coroutine gathers each replica's /debug/requests + /debug/rounds
    # slice alongside the local evidence, then the bundle write runs
    # off-loop. Inert as a unit when HISTORY_INTERVAL_S=0.
    _obs_loop: dict = {}

    async def _capture_with_fleet(trigger: dict) -> None:
        limit = obs_incidents.INCIDENT_SLICE_LIMIT
        extras: dict = {"fleet": None, "autoscale": None, "replicas": {}}
        try:
            extras["fleet"] = router.refresh_fleet()
        except Exception:  # noqa: BLE001 — evidence is best-effort
            logger.debug("incident fleet snapshot failed", exc_info=True)
        if router.autoscale is not None:
            try:
                extras["autoscale"] = router.autoscale.snapshot(
                    limit=limit)
            except Exception:  # noqa: BLE001
                logger.debug("incident autoscale snapshot failed",
                             exc_info=True)
        session = router._session
        if session is not None:
            for rep in table.replicas():
                row: dict = {}
                for ep in ("requests", "rounds"):
                    try:
                        async with session.get(
                                f"{rep.url}/debug/{ep}?limit={limit}",
                                timeout=aiohttp.ClientTimeout(
                                    total=router.heartbeat_timeout_s)
                                ) as resp:
                            row[ep] = await resp.json()
                    except Exception:  # noqa: BLE001 — replica may be
                        row[ep] = None  # the incident; keep the rest
                extras["replicas"][rep.name] = row
        await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(obs_stack.capture, trigger, extras))

    def _capture_async(rule, trigger: dict) -> None:
        loop = _obs_loop.get("loop")
        if loop is None or loop.is_closed():
            # No running app loop (tests driving tick() by hand):
            # capture the local evidence, skip the replica pulls.
            obs_stack.capture(trigger)
            return
        asyncio.run_coroutine_threadsafe(_capture_with_fleet(trigger),
                                         loop)

    obs_stack = obs_incidents.ObservabilityStack(
        "router",
        pre_sample=[table.publish_heartbeat_ages,
                    obs_metrics.record_process_stats],
        flight=router.flight,
        capture_async=_capture_async)

    async def debug_history(request: web.Request) -> web.Response:
        return obs_history.debug_history_response(request,
                                                  obs_stack.history)

    async def debug_alerts(request: web.Request) -> web.Response:
        return obs_alerts.debug_alerts_response(request, obs_stack.alerts)

    async def debug_incidents(request: web.Request) -> web.Response:
        return obs_incidents.debug_incidents_response(request, obs_stack)

    async def control_incident(request: web.Request) -> web.Response:
        return await obs_incidents.control_incident_response(request,
                                                             obs_stack)

    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/debug/requests", debug_requests)
    app.router.add_get("/debug/fleet", debug_fleet)
    app.router.add_get("/debug/autoscale", debug_autoscale)
    app.router.add_get("/debug/history", debug_history)
    app.router.add_get("/debug/alerts", debug_alerts)
    app.router.add_get("/debug/incidents", debug_incidents)
    app.router.add_get("/router/replicas", list_replicas)
    app.router.add_post("/control/replicas", control_replicas)
    app.router.add_post("/control/heartbeat", control_heartbeat)
    app.router.add_post("/control/autoscale", control_autoscale)
    app.router.add_post("/control/incident", control_incident)
    for path in FORWARD_PATHS:
        app.router.add_post(path, forward)

    async def on_startup(app_: web.Application) -> None:
        _obs_loop["loop"] = asyncio.get_running_loop()
        await router.start(run_heartbeat=run_heartbeat,
                           run_autoscale=run_autoscale)
        obs_stack.start()

    async def on_cleanup(app_: web.Application) -> None:
        obs_stack.stop()
        _obs_loop.pop("loop", None)
        await router.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app
