"""Async job API: submit-then-poll generation (202 semantics), a port of
the reference package's ``serving/jobs_api.py``.

A cloud-function client posts a request, gets HTTP 202 and a request id,
and polls a status URL until the result is ready (the NVCF
``pexec/functions`` / ``pexec/status`` pair). This server speaks the
same contract first-party, which is what long generations behind load
balancers and their timeouts need:

  POST /v1/jobs                -> 202 {"id": ...} (or 200 with the result
                                  if it finished within ``sync_wait``)
  GET  /v1/jobs/{id}           -> 202 {"status": "running", partial} |
                                  200 {"status": "done", result}
  DELETE /v1/jobs/{id}         -> cancel + forget

Bodies use the OpenAI completion schema (prompt + sampling fields).
Finished jobs linger ``_TTL_SEC`` for late polls; the table holds at
most ``_MAX_JOBS`` (429 past it, checked under the lock).
"""

from __future__ import annotations

import asyncio
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from aiohttp import web

from ..utils.errors import EngineError
from .openai_api import _sampling_from_body

_TTL_SEC = 600.0       # finished jobs linger this long for late polls
_MAX_JOBS = 256


@dataclass
class _Job:
    id: str
    stream: object                      # engine TokenStream
    chunks: list[str] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    finished_at: Optional[float] = None

    def snapshot(self) -> dict:
        return {"id": self.id,
                "status": ("failed" if self.error else
                           "done" if self.done else "running"),
                "text": "".join(self.chunks),
                "finish_reason": getattr(self.stream, "finish_reason",
                                         None),
                "error": self.error}


def add_jobs_routes(app: web.Application, engine, model_name: str,
                    max_output: int = 512, sync_wait: float = 1.0) -> None:
    jobs: dict[str, _Job] = {}
    lock = threading.Lock()

    def _reap() -> None:
        now = time.monotonic()
        with lock:
            stale = [jid for jid, j in jobs.items()
                     if j.finished_at and now - j.finished_at > _TTL_SEC]
            for jid in stale:
                del jobs[jid]

    def _collector(job: _Job) -> None:
        try:
            for chunk in job.stream:        # type: ignore[attr-defined]
                job.chunks.append(chunk)
        except Exception as exc:  # noqa: BLE001 — recorded on the job
            job.error = str(exc)
        job.done = True
        job.finished_at = time.monotonic()

    async def submit(request: web.Request) -> web.Response:
        _reap()
        # Best-effort early reject (unlocked, so overload bursts don't
        # burn body parsing + engine prefill on doomed requests); the
        # authoritative check-and-insert below holds the lock.
        if len(jobs) >= _MAX_JOBS:
            raise web.HTTPTooManyRequests(text="job table full")
        body = await request.json()
        prompt = str(body.get("prompt", ""))
        if not prompt:
            raise web.HTTPUnprocessableEntity(text="'prompt' is required")
        req_model = str(body.get("model", ""))
        if req_model and req_model != model_name:
            # a resolved-but-wrong model must fail loudly, not silently
            # generate with whatever this server happens to serve
            raise web.HTTPNotFound(
                text=f"model {req_model!r} is not served here "
                     f"(serving {model_name!r})")
        try:
            params = _sampling_from_body(body, max_output)
            engine.start()
            stream = engine.stream_text(prompt, params)
        except (ValueError, EngineError) as exc:
            raise web.HTTPBadRequest(text=str(exc)) from exc
        job = _Job(id=f"job-{uuid.uuid4().hex[:16]}", stream=stream)
        # Capacity check and insert under ONE lock hold: checking before
        # the (awaited) body parse let concurrent submits race past the
        # cap and overfill the table.
        with lock:
            if len(jobs) >= _MAX_JOBS:
                stream.cancel()
                raise web.HTTPTooManyRequests(text="job table full")
            jobs[job.id] = job
        threading.Thread(target=_collector, args=(job,), daemon=True,
                         name=f"job-{job.id}").start()
        # NVCF-style fast path: a short grace period lets quick jobs
        # return 200 immediately (the reference's first poll often does)
        deadline = time.monotonic() + sync_wait
        while not job.done and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        snap = job.snapshot()
        return web.json_response(
            snap, status=200 if job.done and not job.error else
            500 if job.error else 202)

    def _get_job(request: web.Request) -> _Job:
        job = jobs.get(request.match_info["job_id"])
        if job is None:
            raise web.HTTPNotFound(text="unknown or expired job id")
        return job

    async def poll(request: web.Request) -> web.Response:
        job = _get_job(request)
        snap = job.snapshot()
        return web.json_response(
            snap, status=500 if job.error else 200 if job.done else 202)

    async def cancel(request: web.Request) -> web.Response:
        job = _get_job(request)
        job.stream.cancel()             # type: ignore[attr-defined]
        with lock:
            jobs.pop(job.id, None)
        return web.json_response({"id": job.id, "status": "cancelled"})

    app.router.add_post("/v1/jobs", submit)
    app.router.add_get("/v1/jobs/{job_id}", poll)
    app.router.add_delete("/v1/jobs/{job_id}", cancel)
