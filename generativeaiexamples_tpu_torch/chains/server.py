"""The chain server: 3-endpoint HTTP API over a pluggable example — port
of the reference package's ``chains/server.py``.

  POST /uploadDocument   multipart file upload → example.ingest_docs
  POST /generate         {question, context, use_knowledge_base, num_tokens}
                         → streaming text/event-stream response
  POST /documentSearch   {content, num_docs} → [{score, source, content}]

plus ``GET /health``, ``/metrics``, ``/debug/{requests,rounds,history,
alerts,incidents}``, ``POST /control/incident``, ``/control/drain``,
``/control/undrain``, the KV-tier session routes ``/control/kv_suspend``
and ``/control/kv_resume``, the fleet routes ``/control/kv_pages`` (a
sibling pulls prefix pages) and ``/control/prefill`` (the prefill leg of
the disaggregated handoff, docs/disaggregation.md), the router's
``X-KV-Transfer-From`` donor hint on ``/generate``, and mid-stream resume
(a ``/generate`` body with a ``resume`` block carrying the text already
streamed). Examples are discovered by module path
(``discover_example``).

Sync chain generators run on a worker thread; chunks cross into the event
loop through an asyncio queue, so one slow generation never blocks other
requests (the aiohttp equivalent of FastAPI's StreamingResponse-over-
threadpool).

Robustness contract (docs/robustness.md):

- failures BEFORE the first generated chunk return real HTTP statuses
  with a JSON body and ``X-Request-ID`` — 429 + ``Retry-After`` for an
  overloaded engine queue or an unmeetable deadline, 503 for a
  down/breaker-open engine, 504 for a hung store, 500 otherwise — never
  a 200 SSE carrying ``[error]`` text;
- failures AFTER streaming has begun keep the in-stream degrade (the
  partial answer already went out on a 200) but append a
  machine-readable ``event: error`` frame clients can parse;
- per-request deadlines (``X-Deadline-Ms``, config/env default) ride the
  flight-recorder contextvar into the engine, which drops expired queued
  requests before prefill and stops decode when the deadline passes.

Drain protocol (docs/router.md): ``POST /control/drain`` flips admission
to reject-new — every work endpoint answers 429 + ``Retry-After`` with
``type=draining`` while IN-FLIGHT streams run to completion — and
``GET /health`` turns 503 so k8s readiness and the fleet router stop
placing here. ``POST /control/undrain`` re-opens admission (rollback).
``/health`` is truthful the same way when the ``chain_generate`` breaker
is open: a replica that would fast-503 every generate is NOT ready, and
the probe must say so instead of letting the router/k8s keep routing to
it. The health body doubles as the router's heartbeat payload: a
``load`` block with the edge's in-flight stream count and the engine's
reject/deadline-drop counters (per-app state only — safe for N
in-process replicas sharing one metrics registry), plus ``rounds``
(round-telemetry rolling aggregates incl. the wall-clock token rate) and
``capacity`` (the step-cost model's decode ceiling) blocks.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import json
import math
import os
import threading
import time
from typing import Optional

from aiohttp import web

from ..obs import alerts as obs_alerts
from ..obs import flight as obs_flight
from ..obs import history as obs_history
from ..obs import incidents as obs_incidents
from ..obs import metrics as obs_metrics
from ..obs import rounds as obs_rounds
from ..obs.tracing import instrumented
from ..serving.streaming import iterate_in_thread
from ..utils import resilience
from ..utils.errors import (BreakerOpenError, ChainError, EngineError,
                            RoleMismatchError, SchedulerFullError)
from ..utils.logging import get_logger
from .base import BaseExample

logger = get_logger(__name__)


def error_response(status: int, err_type: str, message: str, rid: str,
                   retry_after_s: Optional[float] = None) -> web.Response:
    """Structured error: JSON body + ``X-Request-ID`` (quote it to
    /debug/requests) + ``Retry-After`` when the failure is retryable."""
    headers = {"X-Request-ID": rid}
    if retry_after_s is not None:
        headers["Retry-After"] = str(max(1, int(math.ceil(retry_after_s))))
    return web.json_response(
        {"error": {"type": err_type, "message": message},
         "request_id": rid},
        status=status, headers=headers)


def _shed(reason: str) -> None:
    obs_metrics.REGISTRY.counter(
        "shed_total", "requests rejected at admission, by reason",
        labelnames=("reason",)).labels(reason).inc()


class DrainState:
    """Admission switch + in-flight stream accounting for one app.

    ``draining`` flips via ``POST /control/drain``; ``in_flight`` counts
    /generate streams between the chain generator starting and its
    terminal transition (run_chain's finally — which runs on EVERY exit:
    completion, mid-stream error, client disconnect), so a rollout can
    watch it reach 0 before killing the process. Thread-safe: the
    counter is bumped from chain worker threads while the flag flips
    from the event loop (or test threads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.draining = False
        self._in_flight = 0

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def inc(self) -> None:
        with self._lock:
            self._in_flight += 1

    def dec(self) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)

    def set_draining(self, value: bool) -> None:
        with self._lock:
            self.draining = bool(value)


try:  # typed app-state keys (aiohttp >= 3.9); tests reach them by these
    GENERATE_BREAKER = web.AppKey("generate_breaker",
                                  resilience.CircuitBreaker)
    DRAIN_STATE = web.AppKey("drain_state", DrainState)
except AttributeError:  # older aiohttp: plain string keys
    GENERATE_BREAKER = "generate_breaker"  # type: ignore[assignment]
    DRAIN_STATE = "drain_state"  # type: ignore[assignment]


def discover_example(spec: str) -> type[BaseExample]:
    """Resolve an example class from a module spec.

    ``spec`` is a module path (``generativeaiexamples_tpu_torch.chains.
    examples.developer_rag``) or a shorthand name of a built-in example
    (``developer_rag``). The module is scanned for concrete BaseExample
    subclasses.
    """
    if "." not in spec:
        spec = f"{__package__}.examples.{spec}"
    module = importlib.import_module(spec)
    for _, obj in inspect.getmembers(module, inspect.isclass):
        if (issubclass(obj, BaseExample) and obj is not BaseExample
                and not inspect.isabstract(obj)):
            return obj
    raise ChainError(f"no BaseExample implementation found in {spec}")


def _max_body_bytes(example) -> int:
    """The largest request body the app reads: 100 MiB, or the served
    engine's host KV tier plus 1 MiB of blob header when that is more, so
    ``/control/kv_resume`` takes any blob the tier could hold (a 2000-token
    prefix of a 7B int8 pool is about 0.5 GB)."""
    engine = getattr(getattr(example, "llm", None), "engine", None)
    tier = getattr(engine, "_kv_tier", None)
    cap = tier.store.capacity_bytes if tier is not None else 0
    return max(100 * 1024 ** 2, cap + (1 << 20))


def create_app(example: BaseExample,
               upload_dir: str = "./uploaded_files",
               config=None) -> web.Application:
    app = web.Application(client_max_size=_max_body_bytes(example))

    # Robustness knobs: app-config `serving` section, env-overridable
    # (REQUEST_DEADLINE_MS / CHAIN_EXECUTOR_TIMEOUT_S win over the file —
    # chaos runs flip them without a config edit).
    try:
        if config is None:
            from ..utils.app_config import get_config
            config = get_config()
        rcfg = config.serving
    except Exception:  # noqa: BLE001 — config problems must not kill boot
        from ..utils.app_config import ServingRobustnessConfig
        rcfg = ServingRobustnessConfig()
    default_deadline_ms = float(os.environ.get(
        "REQUEST_DEADLINE_MS", rcfg.default_deadline_ms) or 0) or None
    executor_timeout_s = float(os.environ.get(
        "CHAIN_EXECUTOR_TIMEOUT_S", rcfg.request_timeout_s) or 0) or None
    ingest_timeout_s = float(os.environ.get(
        "CHAIN_INGEST_TIMEOUT_S",
        getattr(rcfg, "ingest_timeout_s", 300.0)) or 0) or None
    admission_min = int(rcfg.admission_min_samples)
    # Private breaker instance (not the shared registry): each app's
    # failure count is its own, so one test server's tripped breaker
    # can't fast-503 the next. State still lands on /metrics by name.
    breaker = resilience.CircuitBreaker(
        "chain_generate", rcfg.breaker_failures, rcfg.breaker_cooldown_s)
    app[GENERATE_BREAKER] = breaker
    drain = DrainState()
    app[DRAIN_STATE] = drain

    def _load_block() -> dict:
        """Per-replica load signals for the router heartbeat. Only
        per-APP state (the drain counter, THIS example's engine) — the
        process-wide metrics registry is shared when several replicas
        run in one process (tests, fleet bench), so its counters cannot
        tell replicas apart."""
        load = {"in_flight": drain.in_flight}
        engine = getattr(getattr(example, "llm", None), "engine", None)
        if engine is not None:
            try:
                stats = engine.stats
                # Queued WORK, not just in-flight device rounds: the
                # engine's queue_waiting stat (admission intake +
                # scheduler backlog) is the leading congestion signal
                # the router's load score and the autoscaler's queue
                # trigger both need — device rounds alone saturate at
                # dispatch_depth and read "2" on a replica drowning in
                # queued prefills.
                load["queue_depth"] = int(
                    stats.get("dispatch_queue_depth", 0)
                    + stats.get("queue_waiting", 0))
                # Admission-pressure counters: the router diffs these
                # between heartbeats into a recent shed rate.
                load["rejected_total"] = int(
                    stats.get("rejected_full", 0)
                    + stats.get("deadline_queue_drops", 0))
                load["prefix_hit_rate"] = round(float(
                    stats.get("prefix_cache_hit_rate", 0.0)), 4)
            except Exception:  # noqa: BLE001 — health must never 500
                logger.debug("engine stats unavailable", exc_info=True)
        return load

    def _obs_blocks() -> dict:
        """Fleet-observability blocks riding the heartbeat body:
        round-telemetry rolling aggregates (plus the wall-clock token
        rate), the modeled decode capacity from the scheduler's step-cost
        model with the handoff's pricing inputs, and the KV tier's
        counters. Absent engine → absent blocks; each block degrades to
        absence on its own (a health answer must never 500 over
        telemetry)."""
        out: dict = {}
        engine = getattr(getattr(example, "llm", None), "engine", None)
        if engine is None:
            return out
        try:
            agg = engine.rounds.snapshot(
                limit=0, engine_tag=engine.engine_tag)["aggregates"]
            if agg.get("rounds_completed"):
                # Observed decode load: tokens over the aggregation
                # window's WALL span (the ring-relative tokens_per_sec
                # is a device-busy rate, near capacity whenever busy).
                span_s = max(1e-3, time.time()
                             - agg["window_start_unix_ms"] / 1e3)
                out["rounds"] = {
                    "rounds_completed": int(agg["rounds_completed"]),
                    "tokens_per_sec": float(agg.get("tokens_per_sec", 0.0)),
                    "wall_tokens_per_sec": round(
                        agg.get("tokens_emitted", 0) / span_s, 2),
                    "avg_device_ms": float(agg.get("avg_device_ms", 0.0)),
                    "avg_bw_util": float(agg.get("avg_bw_util", 0.0)),
                    "avg_drift_ratio": float(
                        agg.get("avg_drift_ratio", 0.0)),
                    "interleaved_share": float(
                        agg.get("interleaved_share", 0.0)),
                }
        except Exception:  # noqa: BLE001 — health must never 500
            logger.debug("rounds block unavailable", exc_info=True)
        try:
            sched = getattr(engine, "_sched", None)
            if sched is not None:
                # At full occupancy one decode step emits one token per
                # slot, so capacity = slots / step seconds.
                cost = sched.cost
                step_ms = max(1e-6, float(cost.decode_step_ms))
                out["capacity"] = {
                    "slots": int(engine.cfg.max_slots),
                    "decode_step_ms": round(step_ms, 4),
                    "model_source": str(cost.source),
                    "capacity_tokens_per_sec": round(
                        engine.cfg.max_slots * 1e3 / step_ms, 1),
                    # The router's handoff price
                    # (table.handoff_beats_prefill) reads these: the
                    # numbers this engine's own priced restore uses.
                    "prefill_ms_per_token": round(
                        float(cost.prefill_ms_per_token), 6),
                    "h2d_ms_per_page": round(
                        float(cost.h2d_ms_per_page), 4),
                    "d2h_ms_per_page": round(
                        float(cost.d2h_ms_per_page), 4),
                    "page_size": int(engine.cfg.page_size),
                }
        except Exception:  # noqa: BLE001
            logger.debug("capacity block unavailable", exc_info=True)
        try:
            if getattr(engine, "_kv_tier", None) is not None:
                stats = engine.stats
                out["kv_tier"] = {
                    "host_pages": int(stats.get("kv_tier_host_pages", 0)),
                    "offload_pages": int(
                        stats.get("kv_tier_offload_pages", 0)),
                    "restore_pages": int(
                        stats.get("kv_tier_restore_pages", 0)),
                    "transfer_pages": int(
                        stats.get("kv_tier_transfer_pages", 0)),
                }
        except Exception:  # noqa: BLE001
            logger.debug("kv_tier block unavailable", exc_info=True)
        return out

    async def health(request: web.Request) -> web.Response:
        # Readiness is TRUTHFUL: draining, a tripped generate breaker,
        # or a stalled engine (liveness watchdog — work queued but no
        # round completing for ENGINE_WATCHDOG_STALL_S) means every
        # /generate would be rejected or hang, so k8s and the fleet
        # router must both see not-ready (503) — the two placement
        # authorities can never disagree about this replica.
        engine = getattr(getattr(example, "llm", None), "engine", None)
        if drain.draining:
            status, code = "draining", 503
        elif breaker.state == resilience.OPEN:
            status, code = "breaker_open", 503
        elif getattr(engine, "stalled", False):
            status, code = "engine_stalled", 503
        else:
            status, code = "ok", 200
        return web.json_response(
            {"status": status, "draining": drain.draining,
             "breaker": breaker.state,
             # Disaggregation role, heartbeat-advertised: the router's
             # role-aware placement and the per-role autoscale targets
             # both read it from here (docs/disaggregation.md).
             "role": getattr(engine, "role", "unified") or "unified",
             "load": _load_block(), **_obs_blocks()},
            status=code)

    async def control_drain(request: web.Request) -> web.Response:
        """Flip admission to reject-new; in-flight streams finish. The
        k8s preStop hook POSTs here, then the rollout waits for
        ``in_flight`` to reach 0 (deploy/README.md)."""
        drain.set_draining(True)
        logger.info("draining: admission closed, %d stream(s) in flight",
                    drain.in_flight)
        return web.json_response({"status": "draining",
                                  "in_flight": drain.in_flight})

    async def control_undrain(request: web.Request) -> web.Response:
        drain.set_draining(False)
        return web.json_response({"status": "ok",
                                  "in_flight": drain.in_flight})

    def _drain_reject(rid: str) -> web.Response:
        _shed("draining")
        # Retry-After from the flight recorder's MEASURED queue-wait
        # estimate (the same signal edge admission sheds on), not a
        # constant: a drained-but-idle replica tells retries to come
        # back in a second, a congested one spaces them to its actual
        # drain time.
        _, wait_ms = obs_flight.RECORDER.recent_stage_ms(
            "engine_admit_pickup")
        return error_response(
            429, "draining",
            "replica is draining; retry against another replica", rid,
            retry_after_s=max(1.0, wait_ms / 1e3))

    @instrumented("upload_document")
    async def upload_document(request: web.Request) -> web.Response:
        if drain.draining:
            return _drain_reject(
                obs_flight.adopt_request_id(request.headers))
        # reference: server.py:91-118 — save then ingest
        reader = await request.multipart()
        field = await reader.next()
        while field is not None and field.name != "file":
            field = await reader.next()
        if field is None:
            raise web.HTTPUnprocessableEntity(text="no 'file' field")
        filename = os.path.basename(field.filename or "upload.bin")
        os.makedirs(upload_dir, exist_ok=True)
        path = os.path.join(upload_dir, filename)
        with open(path, "wb") as f:
            while True:
                chunk = await field.read_chunk()
                if not chunk:
                    break
                f.write(chunk)
        rid = obs_flight.adopt_request_id(request.headers)
        try:
            # Bounded: a hung store must cost the caller 504, not pin
            # this worker thread forever. (The executor thread itself
            # cannot be killed; the timeout frees the HTTP slot.)
            await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, example.ingest_docs, path, filename),
                timeout=ingest_timeout_s)
        except asyncio.TimeoutError:
            logger.error("ingest timed out for %s after %ss", filename,
                         ingest_timeout_s)
            return error_response(
                504, "timeout",
                f"ingest of {filename} exceeded {ingest_timeout_s}s",
                rid)
        except Exception as exc:  # noqa: BLE001 — degrade like the reference
            logger.exception("ingest failed for %s", filename)
            return error_response(500, "ingest_error",
                                  f"ingest failed: {exc}", rid)
        obs_metrics.REGISTRY.counter(
            "documents_ingested_total",
            "documents ingested via /uploadDocument").inc()
        return web.json_response({"filename": filename, "status": "ingested"})

    @instrumented("generate_answer")
    async def generate_answer(request: web.Request) -> web.StreamResponse:
        # reference: server.py:121-142 — Prompt schema + SSE streaming
        body = await request.json()
        question = body.get("question", "")
        context = body.get("context", "")
        use_kb = bool(body.get("use_knowledge_base", True))
        num_tokens = int(body.get("num_tokens", 256))
        if not question:
            raise web.HTTPUnprocessableEntity(text="'question' is required")

        # Flight recorder: adopt the caller's X-Request-ID (or W3C
        # trace-id) — this ID names the request's timeline in
        # /debug/requests, the engine's stream, and the slow-request
        # dump. Echoed back so callers can correlate without sending one.
        rid = obs_flight.adopt_request_id(request.headers)

        # Cross-replica KV transfer (docs/kv-tiering.md): the router's
        # placement-miss hint naming a sibling that holds this prompt's
        # prefix pages, bound into the request's context below so
        # Engine.submit fetches them (a no-op with the tier off).
        kv_donor = request.headers.get("X-KV-Transfer-From") or None

        # Mid-stream failover continuation: a router re-submits a
        # request whose replica died mid-stream with a ``resume`` block
        # carrying the generated-so-far text. It is tokenized here and
        # bound into the request's context (engine/resume.py);
        # Engine.submit admits it as prompt + those ids and streams only
        # what follows.
        resume_block = (body.get("resume")
                        if isinstance(body.get("resume"), dict) else None)
        resume_ids: Optional[list] = None
        resume_attempt = 0

        # Drain gate FIRST: a draining replica admits nothing new (the
        # 429 tells the router/caller to go elsewhere) while the streams
        # already in flight below run to completion. A resume is not new
        # work, so a draining replica still takes it.
        if drain.draining and resume_block is None:
            return _drain_reject(rid)

        if resume_block is not None:
            engine = getattr(getattr(example, "llm", None), "engine", None)
            if engine is None or use_kb:
                # No engine to replay into, or retrieval would run again
                # and could diverge: refuse, so the router falls back to
                # its error frame instead of a wrong continuation.
                _shed("resume_unsupported")
                return error_response(
                    409, "resume_unsupported",
                    "this replica cannot resume the stream ("
                    + ("no engine" if engine is None
                       else "retrieval-augmented request") + ")", rid)
            resume_attempt = int(resume_block.get("attempt", 1) or 1)
            text = str(resume_block.get("text", "") or "")
            resume_ids = (engine.tokenizer.encode(text, add_bos=False)
                          if text else [])
            if len(resume_ids) >= num_tokens:
                _shed("resume_exhausted")
                return error_response(
                    409, "resume_exhausted",
                    f"resume replays {len(resume_ids)} tokens but the "
                    f"request budget is {num_tokens}", rid)

        # Breaker fast-path: a generation path that keeps failing is
        # DOWN — reject in microseconds instead of queueing doomed work
        # behind a dead engine. Half-open lets one probe through.
        if not breaker.allow():
            _shed("breaker_open")
            return error_response(
                503, "engine_unavailable",
                "generation is failing; circuit breaker open", rid,
                retry_after_s=breaker.retry_after_s()
                or rcfg.breaker_cooldown_s)
        # Breaker outcome must be resolved on EVERY exit path, or a
        # half-open probe would stay in flight forever and wedge the
        # breaker. Three resolutions: success/failure when the engine
        # was actually exercised (only engine connectivity counts as
        # failure), release when it wasn't — a shed, a chain-side bug,
        # or a client cancellation proves nothing about the engine and
        # must not close a half-open breaker.
        reported = [False]

        def report(ok: bool) -> None:
            if not reported[0]:
                reported[0] = True
                (breaker.record_success if ok
                 else breaker.record_failure)()

        def release() -> None:
            if not reported[0]:
                reported[0] = True
                breaker.release_probe()

        # fresh: a retry racing its original under the same client ID
        # gets its own (#N-suffixed) timeline, never the original's.
        timeline = obs_flight.RECORDER.begin(rid, fresh=True)
        rid = timeline.request_id
        timeline.annotate(route="/generate", use_kb=use_kb,
                          num_tokens=num_tokens)
        deadline_ms = obs_flight.adopt_deadline_ms(request.headers,
                                                   default_deadline_ms)
        if deadline_ms is not None:
            timeline.set_deadline(deadline_ms)
            # Admission control: if recent requests waited longer in the
            # engine queue than this caller's whole budget, admitting it
            # is hopeless — shed NOW with an honest Retry-After instead
            # of streaming a deadline_queue drop seconds later.
            n, wait_ms = obs_flight.RECORDER.recent_stage_ms(
                "engine_admit_pickup")
            if n >= admission_min and wait_ms > deadline_ms:
                _shed("deadline_unmeetable")
                timeline.annotate(finish="shed", shed="deadline_unmeetable",
                                  est_queue_wait_ms=round(wait_ms, 1))
                obs_flight.RECORDER.complete(timeline)
                release()  # engine never probed
                return error_response(
                    429, "deadline_unmeetable",
                    f"estimated queue wait {wait_ms:.0f} ms exceeds the "
                    f"request deadline {deadline_ms:.0f} ms", rid,
                    retry_after_s=wait_ms / 1e3)

        def run_chain():
            """Generator wrapping the chain: per-token metrics; failures
            BEFORE the first chunk re-raise (the handler maps them to
            real HTTP statuses); failures after degrade in-stream
            (reference: server.py:136-142) plus a machine-readable final
            event. Runs on a worker thread under the request's copied
            context (iterate_in_thread), so the timeline bound here is
            visible to every stage below it — including Engine.submit."""
            token = obs_flight.bind(timeline)
            kv_token = None
            if kv_donor is not None:
                # Lazy: a chain without an engine never loads it.
                from ..engine import kv_tier
                kv_token = kv_tier.bind_transfer_source(kv_donor)
            resume_token = None
            if resume_ids is not None:
                from ..engine import resume as engine_resume
                resume_token = engine_resume.bind_resume(
                    {"ids": resume_ids, "attempt": resume_attempt})
            timer = obs_metrics.RequestTimer("chain_generate")
            emitted = False
            drain.inc()
            try:
                gen = (example.rag_chain(question, num_tokens) if use_kb
                       else example.llm_chain(context, question, num_tokens))
                for chunk in gen:
                    timer.token(1)
                    emitted = True
                    yield chunk
            except GeneratorExit:
                # Consumer abandoned the stream (client disconnect):
                # record the truth — this request did NOT complete.
                timeline.meta.setdefault("finish", "disconnected")
                raise
            except Exception as exc:  # noqa: BLE001
                # setdefault: an engine-recorded reason (e.g. the
                # queue-full 'rejected') is more precise — keep it.
                timeline.meta.setdefault("finish", "error")
                timeline.meta.setdefault("error", str(exc))
                if not emitted:
                    raise  # pre-stream: becomes a real HTTP status
                logger.exception("generation failed mid-stream")
                yield f"\n[error] {exc}"
                yield ("\n\nevent: error\ndata: " + json.dumps(
                    {"error": type(exc).__name__, "message": str(exc),
                     "request_id": rid}) + "\n\n")
            finally:
                drain.dec()
                timer.finish()
                if resume_token is not None:
                    from ..engine import resume as engine_resume
                    engine_resume.unbind_resume(resume_token)
                if kv_token is not None:
                    from ..engine import kv_tier
                    kv_tier.unbind_transfer_source(kv_token)
                obs_flight.unbind(token)
                # Engine-served requests were already completed at the
                # stream's terminal transition (complete() is idempotent);
                # this covers chains that never reach an engine.
                timeline.meta.setdefault("finish", "done")
                obs_flight.RECORDER.complete(timeline)

        # Pull the FIRST chunk before committing to a 200: everything
        # that can go wrong pre-stream (queue full, dead engine, broken
        # chain) surfaces here as a typed exception with a real status.
        agen = iterate_in_thread(run_chain())
        try:
            first: Optional[str] = await agen.__anext__()
        except StopAsyncIteration:
            first = None  # empty generation
            # A deadline enforced before ANY output (dropped in queue,
            # or stopped at the very first token) produced nothing the
            # caller can use — that is a 504, not an empty 200.
            if timeline.meta.get("finish") in ("deadline_queue", "deadline"):
                report(True)  # engine answered (by dropping) — not down
                return error_response(
                    504, "deadline_exceeded",
                    f"request deadline ({timeline.meta.get('deadline_ms')}"
                    f" ms) expired before any output "
                    f"({timeline.meta['finish']})", rid)
        except SchedulerFullError as exc:
            report(True)  # the engine is alive — just saturated
            _shed("queue_full")
            _, wait_ms = obs_flight.RECORDER.recent_stage_ms(
                "engine_admit_pickup")
            return error_response(429, "queue_full", str(exc), rid,
                                  retry_after_s=max(1.0, wait_ms / 1e3))
        except BreakerOpenError as exc:
            release()  # a DOWNSTREAM breaker tripped; engine not probed
            _shed("breaker_open")
            return error_response(503, "dependency_unavailable", str(exc),
                                  rid, retry_after_s=exc.retry_after_s)
        except RoleMismatchError as exc:
            # Misrouted, not broken: a prefill-role engine refusing a
            # decode-bound request. The engine is fine, so the probe is
            # released and the answer is a retryable 429, never a
            # breaker-feeding 503.
            release()
            _shed("role_mismatch")
            return error_response(429, "role_mismatch", str(exc), rid,
                                  retry_after_s=1.0)
        except EngineError as exc:
            report(False)  # engine down/failing: feeds the fast-503 breaker
            return error_response(503, "engine_error", str(exc), rid)
        except ChainError as exc:
            release()  # chain-side failure says nothing about the engine
            return error_response(500, "chain_error", str(exc), rid)
        except Exception as exc:  # noqa: BLE001
            release()
            logger.exception("generation failed before first chunk")
            return error_response(500, "internal_error", str(exc), rid)
        except BaseException:
            # Client cancellation (or worse) while waiting on the first
            # chunk: release the probe — NOT an outcome — and close the
            # generator so run_chain's finally retires the timeline.
            release()
            await agen.aclose()
            raise
        report(True)

        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache",
                     "X-Request-ID": rid})
        if resume_ids is not None:
            # How much generated work the failover kept.
            resp.headers["X-Resume-Replayed"] = str(len(resume_ids))
        try:
            await resp.prepare(request)
        except BaseException:
            # Client vanished before headers went out: closing the
            # generator runs run_chain's finally, which retires the
            # timeline (finish=disconnected via GeneratorExit).
            await agen.aclose()
            raise
        try:
            if first is not None:
                await resp.write(first.encode("utf-8"))
            async for chunk in agen:
                await resp.write(chunk.encode("utf-8"))
            await resp.write_eof()
        except (ConnectionResetError, ConnectionError):
            logger.info("client disconnected mid-stream")
        return resp

    @instrumented("document_search")
    async def document_search(request: web.Request) -> web.Response:
        # reference: server.py:145-159 — duck-typed document_search
        if drain.draining:
            return _drain_reject(
                obs_flight.adopt_request_id(request.headers))
        body = await request.json()
        content = body.get("content", "")
        num_docs = int(body.get("num_docs", 4))
        search = getattr(example, "document_search", None)
        if search is None:
            return web.json_response([])
        rid = obs_flight.adopt_request_id(request.headers)
        try:
            # Bounded: a hung vector store returns 504 instead of
            # blocking this endpoint (and its executor slot) forever.
            result = await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, search, content, num_docs),
                timeout=executor_timeout_s)
        except asyncio.TimeoutError:
            logger.error("document search timed out after %ss",
                         executor_timeout_s)
            return error_response(
                504, "timeout",
                f"document search exceeded {executor_timeout_s}s", rid)
        except Exception as exc:  # noqa: BLE001
            logger.exception("document search failed")
            return error_response(500, "search_error", str(exc), rid)
        return web.json_response(result)

    def _tier_engine():
        """The served engine, or (status, error type, message) when the
        KV-tier control routes cannot work here."""
        engine = getattr(getattr(example, "llm", None), "engine", None)
        if engine is None:
            return None, (404, "no_engine",
                          "this chain serves no in-process engine")
        if getattr(engine, "_kv_tier", None) is None:
            return None, (409, "kv_tier_disabled",
                          "KV tiering is disabled on this replica "
                          "(KV_HOST_POOL_TOKENS=0)")
        return engine, None

    # Donor-side export bound: at most KV_EXPORT_CONCURRENCY
    # /control/kv_pages exports at once. Each is a page gather on the
    # serve thread, taking time from decode rounds, so pulls past the cap
    # are shed (429 + Retry-After, counted in kv_export_shed) instead of
    # stalling every stream here. A counter, not a semaphore: refusing is
    # the point.
    kv_export_limit = max(1, int(os.environ.get(
        "KV_EXPORT_CONCURRENCY", "2") or 2))
    kv_export_active = [0]

    async def kv_pages(request: web.Request) -> web.Response:
        """``GET /control/kv_pages?hashes=<hex,...>``: the donor side of
        the cross-replica prefix-page transfer (docs/kv-tiering.md). The
        leading requested blocks held in either tier, as one KV-tier blob
        capped at the engine's transfer page cap. A chain held nowhere
        answers 200 with a blob of no blocks: absence is an answer."""
        rid = obs_flight.adopt_request_id(request.headers)
        engine, err = _tier_engine()
        if err is not None:
            return error_response(err[0], err[1], err[2], rid)
        raw = request.query.get("hashes", "")
        try:
            hashes = [bytes.fromhex(h) for h in raw.split(",") if h]
        except ValueError:
            raise web.HTTPUnprocessableEntity(
                text="hashes must be comma-separated hex block hashes")
        if not hashes:
            raise web.HTTPUnprocessableEntity(
                text="at least one block hash is required")
        if kv_export_active[0] >= kv_export_limit:
            engine._bump("kv_export_shed")
            return error_response(
                429, "kv_export_busy",
                f"{kv_export_active[0]} KV export(s) already in flight "
                f"(cap {kv_export_limit}); retry or place cold", rid,
                retry_after_s=1.0)
        kv_export_active[0] += 1
        try:
            blob, n = await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, engine.export_blob, hashes),
                timeout=executor_timeout_s)
        except asyncio.TimeoutError:
            return error_response(504, "timeout", "kv page export timed out",
                                  rid)
        except EngineError as exc:
            return error_response(503, "engine_error", str(exc), rid)
        finally:
            kv_export_active[0] -= 1
        return web.Response(body=blob, content_type="application/octet-stream",
                            headers={"X-KV-Blocks": str(n),
                                     "X-Request-ID": rid})

    async def kv_suspend(request: web.Request) -> web.Response:
        """``POST /control/kv_suspend`` ``{"text": ...}`` (or
        ``{"token_ids": [...]}``): demote an idle conversation's prefix
        chain out of both KV tiers into a blob the caller keeps;
        ``/control/kv_resume`` seeds it back later without recompute. 404
        when nothing of the chain is cached."""
        rid = obs_flight.adopt_request_id(request.headers)
        engine, err = _tier_engine()
        if err is not None:
            return error_response(err[0], err[1], err[2], rid)
        body = await request.json()
        ids = body.get("token_ids")
        if ids is None:
            text = body.get("text", "")
            if not text:
                raise web.HTTPUnprocessableEntity(
                    text="'text' or 'token_ids' is required")
            ids = engine.tokenizer.encode(text)
        try:
            blob = await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, engine.suspend_session, [int(i) for i in ids]),
                timeout=executor_timeout_s)
        except asyncio.TimeoutError:
            return error_response(504, "timeout", "kv suspend timed out",
                                  rid)
        except EngineError as exc:
            return error_response(503, "engine_error", str(exc), rid)
        if blob is None:
            return error_response(
                404, "not_cached",
                "no block of this conversation is cached", rid)
        return web.Response(body=blob, content_type="application/octet-stream",
                            headers={"X-Request-ID": rid})

    async def kv_resume(request: web.Request) -> web.Response:
        """``POST /control/kv_resume`` with a suspend blob as the body:
        seeds the session's blocks into the host tier; the conversation's
        next turn restores them instead of prefilling."""
        rid = obs_flight.adopt_request_id(request.headers)
        engine, err = _tier_engine()
        if err is not None:
            return error_response(err[0], err[1], err[2], rid)
        blob = await request.read()
        try:
            # Off the event loop: parsing a large blob must not stall the
            # streams in flight.
            n = await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, engine.resume_session, blob),
                timeout=executor_timeout_s)
        except asyncio.TimeoutError:
            return error_response(504, "timeout", "kv resume timed out",
                                  rid)
        except (EngineError, ValueError) as exc:
            return error_response(422, "bad_blob", str(exc), rid)
        return web.json_response({"blocks": n, "request_id": rid})

    async def control_prefill(request: web.Request) -> web.Response:
        """``POST /control/prefill``: the prefill leg of the disaggregated
        handoff (docs/disaggregation.md). Takes a ``/generate``-shaped
        body, assembles the same prompt the decode replica's chain will
        (the config's chat template), runs it as a 1-token greedy
        generation, exports the finished prefix chain and pushes it to
        the replica named by ``X-KV-Push-To`` (its ``/control/kv_resume``).
        The decode replica then admits the real request as a prefix hit.
        Every failure degrades to recompute there: the router takes any
        non-200 as "skip the handoff", never as a request error."""
        rid = obs_flight.adopt_request_id(request.headers)
        engine, err = _tier_engine()
        if err is not None:
            return error_response(err[0], err[1], err[2], rid)
        if drain.draining:
            return _drain_reject(rid)
        body = await request.json()
        question = body.get("question", "")
        context = body.get("context", "")
        if not question:
            raise web.HTTPUnprocessableEntity(text="'question' is required")
        push_to = request.headers.get("X-KV-Push-To") or None
        from ..engine import kv_tier
        if push_to is not None and not kv_tier.donor_allowed(push_to):
            return error_response(
                403, "push_target_not_allowed",
                f"push target {push_to} is outside KV_TRANSFER_ALLOW", rid)
        # The prompt the decode replica's llm_chain assembles, byte for
        # byte: the exported chain must hash the same token ids.
        try:
            prompt = example.config.prompts.chat_template.format(
                context_str=context or "", query_str=question)
        except Exception:  # noqa: BLE001 - an example without a template
            prompt = f"{context}\n{question}" if context else question

        def run_prefill() -> tuple[int, bool]:
            from ..engine.sampling_params import SamplingParams
            stream = engine.stream_text(
                prompt, SamplingParams(max_tokens=1, top_k=1),
                request_id=rid)
            for _ in stream:   # the prefix pages are final after it
                pass
            out = engine.export_handoff(engine.tokenizer.encode(prompt))
            if out is None:
                return 0, False
            blob, n = out
            pushed = False
            if push_to is not None:
                pushed = kv_tier.push_blob(
                    push_to, blob,
                    timeout_s=engine._kv_tier.transfer_timeout_s)
            return n, pushed

        try:
            n, pushed = await asyncio.wait_for(
                asyncio.get_running_loop().run_in_executor(
                    None, run_prefill),
                timeout=executor_timeout_s)
        except asyncio.TimeoutError:
            return error_response(504, "timeout", "prefill handoff timed out",
                                  rid)
        except SchedulerFullError as exc:
            return error_response(429, "queue_full", str(exc), rid,
                                  retry_after_s=1.0)
        except EngineError as exc:
            return error_response(503, "engine_error", str(exc), rid)
        return web.json_response(
            {"blocks": n, "pushed": pushed, "request_id": rid})

    def _mirror_engine_stats() -> None:
        engine = getattr(getattr(example, "llm", None), "engine", None)
        if engine is not None:
            obs_metrics.record_engine_stats(engine.stats)

    async def metrics_endpoint(request: web.Request) -> web.Response:
        # Scrape-time engine snapshot: when the example serves an
        # in-process engine (EngineLLM), surface its counters — decode
        # steps, prefills, prefix-cache hit tokens/rate/evictions — as
        # engine_* gauges next to the chain-level request metrics, plus
        # the process resource gauges (RSS/fds/threads).
        try:
            _mirror_engine_stats()
        except Exception:  # noqa: BLE001 — metrics must never 500
            logger.debug("engine stats unavailable", exc_info=True)
        obs_metrics.record_process_stats()
        return web.Response(text=obs_metrics.REGISTRY.render_prometheus(),
                            content_type="text/plain")

    async def debug_requests(request: web.Request) -> web.Response:
        # Per-request flight recorder: in-flight + last-N completed
        # timelines (obs/flight.py; ?limit= caps the completed list).
        return obs_flight.debug_requests_response(request)

    async def debug_rounds(request: web.Request) -> web.Response:
        # Engine-level round telemetry: per-round plan + execution
        # records and rolling aggregates (obs/rounds.py; ?limit= caps
        # the record list).
        return obs_rounds.debug_rounds_response(request)

    # Retained telemetry (obs/history.py, obs/alerts.py,
    # obs/incidents.py): the history ring samples the registry (engine
    # stats + process gauges mirrored each tick), the alert engine ticks
    # per sample, and firing rules freeze an incident bundle joining the
    # history window with this server's flight/round rings. Inert as a
    # unit when HISTORY_INTERVAL_S=0.
    obs_stack = obs_incidents.ObservabilityStack(
        "chain",
        pre_sample=[_mirror_engine_stats, obs_metrics.record_process_stats],
        flight=obs_flight.RECORDER, rounds=obs_rounds.RECORDER)

    async def _obs_start(_app) -> None:
        obs_stack.start()

    async def _obs_stop(_app) -> None:
        obs_stack.stop()

    app.on_startup.append(_obs_start)
    app.on_cleanup.append(_obs_stop)

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
    app.router.add_get("/debug/rounds", debug_rounds)
    app.router.add_get("/debug/history", debug_history)
    app.router.add_get("/debug/alerts", debug_alerts)
    app.router.add_get("/debug/incidents", debug_incidents)
    app.router.add_post("/control/incident", control_incident)
    app.router.add_post("/uploadDocument", upload_document)
    app.router.add_post("/generate", generate_answer)
    app.router.add_post("/documentSearch", document_search)
    app.router.add_post("/control/drain", control_drain)
    app.router.add_post("/control/undrain", control_undrain)
    app.router.add_get("/control/kv_pages", kv_pages)
    app.router.add_post("/control/kv_suspend", kv_suspend)
    app.router.add_post("/control/kv_resume", kv_resume)
    app.router.add_post("/control/prefill", control_prefill)
    return app


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: ``python -m generativeaiexamples_tpu_torch.chains.server``
    (an in-process engine is passed to ``create_app`` by code; the CLI
    serves the configured ``openai-compat`` or ``echo`` LLM)."""
    import argparse

    parser = argparse.ArgumentParser(description="RAG chain server")
    parser.add_argument("--example", default=os.environ.get(
        "APP_EXAMPLE", "developer_rag"))
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8081)
    parser.add_argument("--upload-dir", default="./uploaded_files")
    args = parser.parse_args(argv)

    # Config-file tracing switch: tracing.enabled in the app config turns
    # the OTel spine on without the ENABLE_TRACING env var (set_enabled
    # re-evaluates at call time — no module reimport needed).
    try:
        from ..obs import tracing as obs_tracing
        from ..utils.app_config import get_config
        tcfg = get_config().tracing
        if tcfg.enabled and not obs_tracing.enabled():
            os.environ.setdefault("OTEL_EXPORTER_OTLP_ENDPOINT",
                                  tcfg.otlp_endpoint)
            obs_tracing.set_enabled(True)
    except Exception:  # noqa: BLE001 — config problems must not kill boot
        logger.debug("tracing config not applied", exc_info=True)

    # Pid file under the run dir (GAIE_RUN_DIR, default under TMPDIR).
    from ..utils.logging import write_pid_file
    pid_path = write_pid_file(f"chain-server-{args.port}")
    if pid_path:
        logger.info("pid file: %s", pid_path)

    example_cls = discover_example(args.example)
    example = example_cls()
    web.run_app(create_app(example, args.upload_dir),
                host=args.host, port=args.port)


if __name__ == "__main__":
    main()
