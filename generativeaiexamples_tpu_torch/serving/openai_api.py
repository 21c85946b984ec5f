"""OpenAI-style ``/v1/completions`` over the port's engine — the
completions route of the reference's ``serving/openai_api.py`` (SSE
stream of true deltas, or one JSON body). Chat, embeddings and models
routes wait for a later slice."""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from typing import Optional

from aiohttp import web

from ..engine.sampling_params import SamplingParams
from ..utils.errors import SchedulerFullError
from .streaming import iterate_in_thread


def _openai_error(status: int, err_type: str, message: str) -> web.Response:
    return web.json_response(
        {"error": {"type": err_type, "message": message, "code": status}},
        status=status)


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
                        finish: Optional[str], *, created: int,
                        usage: Optional[dict] = None) -> dict:
    out = {"id": rid, "object": "text_completion", "created": created,
           "model": model,
           "choices": [{"index": 0, "text": text, "finish_reason": finish}]}
    if usage:
        out["usage"] = usage
    return out


def add_openai_routes(app: web.Application, engine, model_name: str,
                      max_output: int = 512) -> None:
    """Mount ``POST /v1/completions`` for one engine."""

    async def completions(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        if not prompt:
            raise web.HTTPUnprocessableEntity(text="empty prompt")
        try:
            params = _sampling_from_body(body, max_output)
        except (ValueError, TypeError) as exc:
            raise web.HTTPBadRequest(
                text=f"invalid sampling parameters: {exc}") from exc
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        engine.start()
        loop = asyncio.get_running_loop()
        try:
            # Tokenization off the event loop: a long prompt must not
            # stall other in-flight requests.
            stream = await loop.run_in_executor(
                None, lambda: engine.stream_text(prompt, params,
                                                 request_id=rid))
        except SchedulerFullError as exc:
            return _openai_error(429, "rate_limit_error", str(exc))
        except Exception as exc:  # noqa: BLE001
            return _openai_error(503, "service_unavailable", str(exc))

        if body.get("stream"):
            resp = web.StreamResponse(
                headers={"Content-Type": "text/event-stream",
                         "Cache-Control": "no-cache",
                         "X-Request-ID": rid})
            await resp.prepare(request)
            try:
                async for chunk in iterate_in_thread(
                        iter(stream), on_cancel=stream.cancel):
                    payload = _completion_payload(rid, model_name, chunk,
                                                  None, created=created)
                    await resp.write(
                        f"data: {json.dumps(payload)}\n\n".encode())
                final = _completion_payload(rid, model_name, "",
                                            stream.finish_reason,
                                            created=created)
                await resp.write(f"data: {json.dumps(final)}\n\n".encode())
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
            except (ConnectionResetError, ConnectionError):
                pass  # client went away mid-stream
            return resp

        text = "".join([c async for c in iterate_in_thread(
            iter(stream), on_cancel=stream.cancel)])
        n_prompt = len(await loop.run_in_executor(
            None, engine.tokenizer.encode, prompt))
        usage = {"prompt_tokens": n_prompt,
                 "completion_tokens": len(stream.token_ids),
                 "total_tokens": n_prompt + len(stream.token_ids)}
        return web.json_response(_completion_payload(
            rid, model_name, text, stream.finish_reason, created=created,
            usage=usage))

    app.router.add_post("/v1/completions", completions)
