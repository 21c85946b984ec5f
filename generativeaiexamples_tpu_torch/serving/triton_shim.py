"""Triton-compatible HTTP shim: the ensemble tensor API over the port's
engine (a port of the reference package's ``serving/triton_shim.py``).

The public serving surface of the system this stack is modelled on is the
Triton ensemble tensor API: ``text_input``, ``max_tokens``, ``top_k``,
``top_p``, ``temperature``, ``length_penalty``, ``repetition_penalty``,
``random_seed``, ``beam_width``, ``stream``, ``stop_words``, ``bad_words``
in, ``text_output`` out. The shim keeps those names and semantics over
Triton's standard HTTP generate extension (``/v2/models/{model}/generate``
and ``/generate_stream``) plus the health and ready endpoints a Triton
client polls, so existing Triton-generate clients can point at this
server unchanged. A bare body is greedy (``top_k`` defaults to 1).

A request whose client goes away is cancelled, so its decode slot is
released instead of generating to ``max_tokens``.
"""

from __future__ import annotations

import json
from typing import Any

from aiohttp import web

from ..engine.sampling_params import SamplingParams
from ..obs import metrics as obs_metrics
from ..obs.tracing import instrumented
from ..utils.errors import EngineError
from .streaming import iterate_in_thread


def _first(v: Any) -> Any:
    """Triton clients send scalars as [v] or [[v]]; unwrap."""
    while isinstance(v, (list, tuple)) and v:
        v = v[0]
    return v


def _params_from_triton(body: dict, max_output: int) -> SamplingParams:
    def get(name: str, default, cast):
        v = body.get(name)
        return cast(_first(v)) if v is not None else default

    def words(name: str) -> list[str]:
        v = body.get(name) or []
        if isinstance(v, str):
            v = [v]
        return [str(s) for s in v if s]

    beam = get("beam_width", 1, int)
    if beam != 1:
        raise web.HTTPBadRequest(text="beam_width != 1 is not supported")
    try:
        return SamplingParams(
            max_tokens=min(get("max_tokens", 100, int), max_output),
            temperature=get("temperature", 1.0, float),
            top_k=get("top_k", 1, int),
            top_p=get("top_p", 0.0, float),
            repetition_penalty=get("repetition_penalty", 1.0, float),
            length_penalty=get("length_penalty", 1.0, float),
            random_seed=get("random_seed", 0, int),
            stop_words=words("stop_words"),
            bad_words=words("bad_words"),
        )
    except ValueError as exc:  # e.g. length_penalty without beam search
        raise web.HTTPBadRequest(text=str(exc)) from exc


def add_triton_routes(app: web.Application, engine, model_name: str = "ensemble",
                      max_output: int = 512) -> None:
    """Mount the ready endpoints, the model index and ``generate`` /
    ``generate_stream`` for ``model_name`` (and its alias ``ensemble``)."""
    known = {model_name, "ensemble"}

    async def server_ready(request: web.Request) -> web.Response:
        return web.json_response({"ready": True})

    def _check_model(request: web.Request) -> None:
        if request.match_info["model"] not in known:
            raise web.HTTPNotFound(
                text=f"unknown model {request.match_info['model']!r}")

    async def model_ready(request: web.Request) -> web.Response:
        _check_model(request)
        return web.json_response({"ready": True})

    async def model_index(request: web.Request) -> web.Response:
        return web.json_response(
            [{"name": n, "state": "READY"} for n in sorted(known)])

    async def _submit(request: web.Request):
        """(timer, engine stream) of a generate body; 400 on a bad one."""
        _check_model(request)
        body = await request.json()
        text_input = str(_first(body.get("text_input", "")))
        if not text_input:
            raise web.HTTPBadRequest(text="text_input is required")
        try:
            params = _params_from_triton(body, max_output)
        except (ValueError, TypeError) as exc:
            raise web.HTTPBadRequest(
                text=f"invalid parameters: {exc}") from exc
        timer = obs_metrics.RequestTimer("triton_generate")
        engine.start()
        try:
            stream = engine.stream_text(text_input, params)
        except EngineError as exc:  # invalid request (length, bad_words...)
            raise web.HTTPBadRequest(text=str(exc)) from exc
        return timer, stream

    @instrumented("triton_generate")
    async def generate(request: web.Request) -> web.Response:
        timer, stream = await _submit(request)
        chunks = []
        try:
            async for chunk in iterate_in_thread(iter(stream),
                                                 on_cancel=stream.cancel):
                timer.token(1)  # one chunk ≈ one decode step
                chunks.append(chunk)
        finally:
            timer.finish()
        return web.json_response({"model_name": request.match_info["model"],
                                  "text_output": "".join(chunks)})

    @instrumented("triton_generate_stream")
    async def generate_stream(request: web.Request) -> web.StreamResponse:
        timer, stream = await _submit(request)
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await resp.prepare(request)
        model = request.match_info["model"]
        try:
            async for chunk in iterate_in_thread(iter(stream),
                                                 on_cancel=stream.cancel):
                timer.token(1)  # one chunk ≈ one decode step
                # Decoupled-mode deltas; the client stops at the
                # final-response flag.
                payload = {"model_name": model, "text_output": chunk,
                           "triton_final_response": False}
                await resp.write(f"data: {json.dumps(payload)}\n\n".encode())
            final = {"model_name": model, "text_output": "",
                     "triton_final_response": True,
                     "finish_reason": stream.finish_reason}
            await resp.write(f"data: {json.dumps(final)}\n\n".encode())
        except (ConnectionResetError, ConnectionError):
            stream.cancel()  # the client went away mid-stream
            return resp
        finally:
            timer.finish()
        await resp.write_eof()
        return resp

    app.router.add_get("/v2/health/ready", server_ready)
    app.router.add_get("/v2/health/live", server_ready)
    app.router.add_post("/v2/repository/index", model_index)
    app.router.add_get("/v2/models/{model}/ready", model_ready)
    app.router.add_post("/v2/models/{model}/generate", generate)
    app.router.add_post("/v2/models/{model}/generate_stream", generate_stream)
