"""OpenAI-style HTTP API over the port's engine — the reference package's
``serving/openai_api.py``: ``/v1/completions`` and ``/v1/chat/completions``
(SSE streams of true deltas, or one JSON body), ``/v1/models``, and
``/v1/embeddings``, which answers 501 until the port has an embedder.

Each generation adopts the caller's ``X-Request-ID`` (or W3C
``traceparent`` trace id) as its flight-recorder request ID, minting a
``cmpl-`` one otherwise, and echoes the ID the timeline got (a duplicate
in-flight ID gets a ``#N`` suffix). ``X-Deadline-Ms`` (default
``REQUEST_DEADLINE_MS``) becomes the engine request's deadline. A full
queue answers 429 with ``Retry-After`` from the recent queue waits.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import time
import uuid
from typing import Optional

from aiohttp import web

from ..engine.sampling_params import SamplingParams
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs.tracing import instrumented
from ..utils.errors import SchedulerFullError
from .streaming import iterate_in_thread

OWNED_BY = "generativeaiexamples-tpu"


def _openai_error(status: int, err_type: str, message: str,
                  retry_after_s: Optional[float] = None) -> web.Response:
    """OpenAI-shaped error body; ``Retry-After`` on retryable statuses."""
    headers = {}
    if retry_after_s is not None:
        headers["Retry-After"] = str(max(1, int(math.ceil(retry_after_s))))
    return web.json_response(
        {"error": {"type": err_type, "message": message, "code": status}},
        status=status, headers=headers)


def _sampling_from_body(body: dict, max_output: int) -> SamplingParams:
    """The reference's body fields, same defaults (OpenAI semantics:
    top_k unlimited unless the caller sends it)."""
    max_tokens = min(int(body.get("max_tokens", 256)), max_output)
    stop = body.get("stop") or []
    if isinstance(stop, str):  # OpenAI allows a bare string
        stop = [stop]
    return SamplingParams(
        max_tokens=max_tokens,
        temperature=float(body.get("temperature", 1.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        random_seed=int(body.get("seed", body.get("random_seed", 0))),
        stop_words=[str(s) for s in stop],
    )


def _completion_payload(rid: str, model: str, text: str,
                        finish: Optional[str], *, kind: str,
                        created: int, usage: Optional[dict] = None,
                        stream_delta: bool = False) -> dict:
    if kind == "chat":
        if stream_delta:
            choice: dict = {"index": 0, "delta": {"content": text},
                            "finish_reason": finish}
        else:
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      "finish_reason": finish}
        obj = "chat.completion.chunk" if stream_delta else "chat.completion"
    else:
        choice = {"index": 0, "text": text, "finish_reason": finish}
        obj = "text_completion"
    out = {"id": rid, "object": obj, "created": created, "model": model,
           "choices": [choice]}
    if usage:
        out["usage"] = usage
    return out


def render_chat(messages: list[dict]) -> str:
    """Llama-2 ``[INST]`` chat rendering, character for character the
    reference's: a system message wraps in ``<<SYS>>`` ahead of the next
    user turn."""
    system = ""
    turns: list[str] = []
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "system":
            system = f"<<SYS>>\n{content}\n<</SYS>>\n\n"
        elif role == "user":
            turns.append(f"<s>[INST] {system}{content} [/INST]")
            system = ""
        elif role == "assistant":
            turns.append(f" {content} </s>")
    return "".join(turns)


def add_openai_routes(app: web.Application, engine, model_name: str,
                      max_output: int = 512) -> None:
    """Mount the ``/v1/*`` routes for one engine."""

    async def _generate(request: web.Request, kind: str) -> web.StreamResponse:
        body = await request.json()
        if kind == "chat":
            prompt = render_chat(body.get("messages", []))
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
        if not prompt:
            raise web.HTTPUnprocessableEntity(text="empty prompt/messages")
        try:
            params = _sampling_from_body(body, max_output)
        except (ValueError, TypeError) as exc:
            raise web.HTTPBadRequest(
                text=f"invalid sampling parameters: {exc}") from exc
        # The completion id is the flight-recorder request ID, passed to
        # the engine explicitly (an executor does not carry the context),
        # as is the deadline.
        rid = obs_flight.adopt_request_id(
            request.headers, mint=lambda: f"cmpl-{uuid.uuid4().hex[:24]}")
        deadline_ms = obs_flight.adopt_deadline_ms(
            request.headers,
            float(os.environ.get("REQUEST_DEADLINE_MS", "0") or 0) or None)
        deadline_t = (time.monotonic() + deadline_ms / 1e3
                      if deadline_ms is not None else None)
        created = int(time.time())
        timer = obs_metrics.RequestTimer(f"serve_{kind}")

        engine.start()
        loop = asyncio.get_running_loop()
        try:
            # Tokenization off the event loop: a long prompt must not
            # stall other in-flight requests.
            stream = await loop.run_in_executor(
                None, lambda: engine.stream_text(prompt, params,
                                                 request_id=rid,
                                                 deadline_t=deadline_t))
        except SchedulerFullError as exc:
            # Overload is a 429 with a retry hint: the recent requests'
            # measured queue wait.
            _, wait_ms = obs_flight.RECORDER.recent_stage_ms(
                "engine_admit_pickup")
            return _openai_error(429, "rate_limit_error", str(exc),
                                 retry_after_s=max(1.0, wait_ms / 1e3))
        except Exception as exc:  # noqa: BLE001
            return _openai_error(503, "service_unavailable", str(exc))
        # The response id is the timeline's key (a '#N' suffix on a
        # duplicate in-flight id).
        rid = stream.request_id

        if body.get("stream"):
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream",
                         "Cache-Control": "no-cache",
                         "X-Request-ID": rid})
            await resp.prepare(request)
            try:
                async for chunk in iterate_in_thread(
                        iter(stream), on_cancel=stream.cancel):
                    timer.token(1)
                    payload = _completion_payload(
                        rid, model_name, chunk, None, kind=kind,
                        created=created, stream_delta=True)
                    await resp.write(
                        f"data: {json.dumps(payload)}\n\n".encode())
                final = _completion_payload(rid, model_name, "",
                                            stream.finish_reason, kind=kind,
                                            created=created,
                                            stream_delta=True)
                await resp.write(f"data: {json.dumps(final)}\n\n".encode())
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
            except (ConnectionResetError, ConnectionError):
                pass  # client went away mid-stream
            finally:
                timer.finish()
            return resp

        text = "".join([c async for c in iterate_in_thread(
            iter(stream), on_cancel=stream.cancel)])
        timer.token(len(stream.token_ids))
        timer.finish()
        n_prompt = len(await loop.run_in_executor(
            None, engine.tokenizer.encode, prompt))
        usage = {"prompt_tokens": n_prompt,
                 "completion_tokens": len(stream.token_ids),
                 "total_tokens": n_prompt + len(stream.token_ids)}
        return web.json_response(_completion_payload(
            rid, model_name, text, stream.finish_reason, kind=kind,
            created=created, usage=usage), headers={"X-Request-ID": rid})

    @instrumented("v1_completions")
    async def completions(request: web.Request) -> web.StreamResponse:
        return await _generate(request, "completion")

    @instrumented("v1_chat_completions")
    async def chat_completions(request: web.Request) -> web.StreamResponse:
        return await _generate(request, "chat")

    @instrumented("v1_embeddings")
    async def embeddings(request: web.Request) -> web.Response:
        raise web.HTTPNotImplemented(text="no embedding model loaded")

    @instrumented("v1_models")
    async def models(request: web.Request) -> web.Response:
        return web.json_response({"object": "list", "data": [
            {"id": model_name, "object": "model", "owned_by": OWNED_BY}]})

    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/embeddings", embeddings)
    app.router.add_get("/v1/models", models)
