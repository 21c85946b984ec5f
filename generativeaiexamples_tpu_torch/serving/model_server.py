"""Model server of the port: builds an engine and serves it over aiohttp.

    python -m generativeaiexamples_tpu_torch.serving llama-2-7b-chat \\
        --port 8000 [--model-path DIR] [--device cuda] [--seed 0] \\
        [--kv-pool-tokens N] [--quantization {int8,int4,int4_awq}] \\
        [--kv-quant int8] [--embedder-path DIR | --no-embedder]

With ``--model-path`` (default ``$MODEL_PATH``) ``build_services`` follows
the reference's order: the tokenizer from the directory
(``tokenizer.model``, else ``tokenizer.json``), the weights loaded onto
the device in the engine's dtype (``models/import_hf.py``: safetensors,
``pytorch_model*.bin`` or Meta ``consolidated.*.pth``; quantized and NeMo
directories are refused), then, with ``--quantization``, quantized there.
The geometry is the registry model's, overridden by the directory's
``config.json`` where it has one. Without a path the server makes random
weights on the device from ``--seed`` and serves the byte tokenizer.

The embedder behind ``/v1/embeddings`` (``build_embedder``) is the
e5-large-v2 checkpoint in ``--embedder-path``, else ``encoder-tiny`` with
random weights; ``--no-embedder`` serves none (the route then answers
501).

Routes: ``/health`` (with the weight and KV quantization modes); the
OpenAI routes of ``serving/openai_api.py`` (``/v1/completions``,
``/v1/chat/completions``, ``/v1/models``, ``/v1/embeddings``);
``POST /v1/score`` (per-token NLL and perplexity of a text
or token list, ``models/llama.py`` ``score``); ``/metrics`` (Prometheus
text: the engine's stats as ``engine_*`` gauges, the round metrics, the
stage histograms, the request timers, the process gauges);
``/debug/requests`` (flight-recorder timelines), ``/debug/rounds`` (round
records), ``/debug/history``, ``/debug/alerts``, ``/debug/incidents`` and
``POST /control/incident`` (the retained telemetry, inert with
``HISTORY_INTERVAL_S=0``); ``POST /profiler/start`` (body ``{"dir": ...}``)
and ``POST /profiler/stop``, a ``torch.profiler`` session whose Chrome
trace lands in that directory.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch
from aiohttp import web

from ..engine.engine import _DTYPES, Engine, EngineConfig
from ..models import llama
from ..models.configs import (LlamaConfig, config_for_checkpoint,
                              get_model_config)
from ..models.import_hf import (LOADABLE_FORMATS, UNSUPPORTED_WHY,
                                detect_checkpoint_format, load_checkpoint)
from ..models.tokenizer import get_tokenizer
from ..obs import alerts as obs_alerts
from ..obs import flight as obs_flight
from ..obs import history as obs_history
from ..obs import incidents as obs_incidents
from ..obs import metrics as obs_metrics
from ..obs import rounds as obs_rounds
from ..ops.quant import MODES, quantize_params, weight_mode
from ..utils.device import resolve_device
from ..utils.errors import ConfigError, UnsupportedFormatError
from ..utils.logging import bootstrap_logging, get_logger, write_pid_file

logger = get_logger(__name__)


def awq_group(cfg: LlamaConfig) -> int:
    """The int4_awq group for ``cfg``: AWQ's usual 128, or the largest of
    64 and 32 that divides every reduction dim (the tiny geometries).
    Raises ``ConfigError`` when none does."""
    dims = (cfg.hidden_size, cfg.q_dim, cfg.intermediate_size)
    group = next((g for g in (128, 64, 32)
                  if all(d % g == 0 for d in dims)), None)
    if group is None:
        raise ConfigError(f"no int4_awq group of 128, 64 or 32 divides the "
                          f"reduction dims {dims}; use int4 (per channel)")
    return group


def build_services(model_name: str = "llama-2-7b-chat", *,
                   engine_cfg: EngineConfig = EngineConfig(),
                   seed: int = 0,
                   device: Union[str, torch.device] = "cuda",
                   tokenizer: str = "byte",
                   quantization: str = "",
                   model_path: str = "") -> tuple[Engine, str]:
    """An engine for registry model ``model_name`` in the engine config's
    dtype on ``device``: with ``model_path``, the checkpoint there and its
    own tokenizer (the geometry from its ``config.json`` where it has
    one); else random weights made on the device from ``seed`` and the
    ``tokenizer`` spec. With ``quantization`` (one of
    ``ops.quant.MODES``) the weights are quantized on the device
    (int4_awq groups: ``awq_group``). The KV pool's mode is
    ``engine_cfg.kv_quant``. Returns (engine, model name)."""
    if quantization and quantization not in MODES:
        raise ValueError(f"quantization={quantization!r}: use one of "
                         f"{MODES} or ''")
    dev = resolve_device(device)
    cfg = get_model_config(model_name)
    dtype = _DTYPES[engine_cfg.dtype]
    if model_path:
        # The format first: a refused checkpoint fails before anything
        # else is read.
        fmt = detect_checkpoint_format(model_path)
        if fmt not in LOADABLE_FORMATS:
            raise UnsupportedFormatError(
                f"{model_path} is a {fmt} checkpoint; {UNSUPPORTED_WHY}")
        cfg = config_for_checkpoint(model_path, cfg)
        tok = get_tokenizer(model_path)
        params = load_checkpoint(model_path, cfg, dtype=dtype, device=dev)
    else:
        tok = get_tokenizer(tokenizer)
        params = llama.init_params(cfg, seed=seed, dtype=dtype, device=dev)
    if quantization:
        group = awq_group(cfg) if quantization == "int4_awq" else 128
        params = quantize_params(params, mode=quantization, group_size=group)
    engine = Engine(params, cfg, tok,
                    dataclasses.replace(engine_cfg, seed=seed), device=dev)
    return engine, model_name


def build_embedder(embedder_path: str = "",
                   device: Union[str, torch.device] = "cuda"):
    """The model server's embedder on ``device``: the e5-large-v2
    checkpoint directory ``embedder_path`` (HF BERT safetensors and its
    tokenizer), else ``encoder-tiny`` with random weights, as the
    reference's server defaults."""
    from ..embed.encoder import get_embedder
    if embedder_path:
        return get_embedder("torch-cuda", "e5-large-v2",
                            checkpoint_path=embedder_path, device=device)
    return get_embedder("torch-cuda", "encoder-tiny", device=device)


# The chunk sizes /v1/score accepts (the reference's allowlist: it bounds
# the shapes a client can make the server run, and the one-pass path's
# activation memory).
SCORE_CHUNKS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def add_score_route(app: web.Application, engine: Engine,
                    model_name: str) -> None:
    """Mount ``POST /v1/score`` (the reference's route): body ``{"text":
    ...}`` or ``{"tokens": [...]}``, optional ``"chunk"`` (one of
    ``SCORE_CHUNKS``, default 2048) and ``"per_token"``. Answers the mean
    NLL and the perplexity (and each token's NLL with ``per_token``);
    400 for a body that is not a JSON object, 422 for a missing or bad
    field or fewer than 2 tokens, 413 past ``GAIE_MAX_SCORE_TOKENS``
    (default 32768) tokens, 503 when the device runs out of memory.
    One score runs at a time (each holds a dense cache of the whole
    document beside the engine's pool), in an executor, off the event
    loop."""
    gate = asyncio.Semaphore(1)

    async def score(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except Exception as exc:  # noqa: BLE001 - malformed JSON -> 400
            raise web.HTTPBadRequest(text=f"invalid JSON: {exc}") from exc
        max_score = int(os.environ.get("GAIE_MAX_SCORE_TOKENS", "32768"))
        loop = asyncio.get_running_loop()
        try:
            chunk = int(body.get("chunk", 2048))
            if chunk not in SCORE_CHUNKS:
                raise ValueError(f"chunk must be one of {SCORE_CHUNKS}")
            if "tokens" in body:
                ids = [int(t) for t in body["tokens"]]
            elif body.get("text"):
                text = str(body["text"])
                # A token covers at least one byte: a byte bound refuses
                # a hopeless document before it is tokenized.
                if len(text.encode("utf-8", "ignore")) > max_score * 16:
                    raise web.HTTPRequestEntityTooLarge(
                        max_size=max_score * 16, actual_size=len(text))
                ids = await loop.run_in_executor(
                    None, engine.tokenizer.encode, text)
            else:
                raise ValueError("'text' or 'tokens' is required")
            if len(ids) < 2:
                raise ValueError("scoring needs at least 2 tokens")
            V = engine.model_cfg.vocab_size
            if any(not 0 <= t < V for t in ids):
                raise ValueError(f"token ids must lie in [0, {V})")
        except (ValueError, TypeError) as exc:
            raise web.HTTPUnprocessableEntity(text=str(exc)) from exc
        if len(ids) > max_score:
            raise web.HTTPRequestEntityTooLarge(max_size=max_score,
                                                actual_size=len(ids))

        def run() -> np.ndarray:
            tokens = torch.tensor([ids], dtype=torch.int32,
                                  device=engine.device)
            nll = llama.score(engine.params, engine.model_cfg, tokens,
                              chunk=chunk)
            return nll[0].double().cpu().numpy()

        try:
            async with gate:
                nll = await loop.run_in_executor(None, run)
        except torch.cuda.OutOfMemoryError as exc:
            raise web.HTTPServiceUnavailable(
                text="the scoring cache does not fit beside the serving "
                     "pool; send a shorter document or lower "
                     "GAIE_MAX_SCORE_TOKENS") from exc
        mean = float(nll.mean())
        out = {"model": model_name, "tokens": len(ids),
               "mean_nll": round(mean, 6),
               "perplexity": round(float(np.exp(mean)), 4)}
        if body.get("per_token"):
            out["nll"] = [round(float(x), 6) for x in nll]
        return web.json_response(out)

    app.router.add_post("/v1/score", score)


def add_profiler_routes(app: web.Application, engine: Engine) -> None:
    """Mount ``POST /profiler/start`` and ``/profiler/stop``: one
    ``torch.profiler`` session at a time, recording CPU activity and, when
    the engine runs on the card, CUDA activity. Start (body
    ``{"dir": ...}``, default ``generativeaiexamples_tpu_torch/profile``
    under the temporary directory) answers 409 while a session runs; stop
    writes the session's Chrome trace into that directory and answers 409
    when none runs. Both run on one profiler thread, off the event loop,
    bounded by ``PROFILER_TIMEOUT_S`` (default 120): past it they answer
    504 and keep the session's claim, which a later stop clears."""
    import torch.profiler as tprof

    state: dict = {"dir": None, "prof": None}
    worker = ThreadPoolExecutor(1, thread_name_prefix="profiler")
    timeout_s = float(os.environ.get("PROFILER_TIMEOUT_S", "120"))

    def start(trace_dir: str) -> None:
        activities = [tprof.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(tprof.ProfilerActivity.CUDA)
        prof = tprof.profile(activities=activities)
        prof.start()
        state["prof"] = prof

    def stop(trace_dir: str) -> str:
        prof, state["prof"] = state["prof"], None
        if prof is None:
            raise RuntimeError("no profiler session is running")
        prof.stop()
        path = os.path.join(trace_dir, f"trace-{os.getpid()}-"
                                       f"{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        return path

    async def run(fn, *args):
        return await asyncio.wait_for(
            asyncio.get_running_loop().run_in_executor(worker, fn, *args),
            timeout=timeout_s)

    async def profiler_start(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 - an empty body is fine
            body = {}
        # No await between the check and the claim: concurrent starts
        # answer 409 instead of racing into two sessions.
        if state["dir"]:
            raise web.HTTPConflict(text="profiler already running")
        trace_dir = (body or {}).get("dir") or os.path.join(
            tempfile.gettempdir(), "generativeaiexamples_tpu_torch",
            "profile")
        state["dir"] = trace_dir
        try:
            os.makedirs(trace_dir, exist_ok=True)
            await run(start, trace_dir)
        except asyncio.TimeoutError:
            # The start may still land on its thread: keep the claim.
            raise web.HTTPGatewayTimeout(
                text=f"profiler start exceeded {timeout_s}s; trace state "
                     f"unknown — POST /profiler/stop to clean up")
        except Exception:
            state["dir"] = None
            raise
        return web.json_response({"status": "tracing", "dir": trace_dir})

    async def profiler_stop(request: web.Request) -> web.Response:
        if not state["dir"]:
            raise web.HTTPConflict(text="profiler not running")
        try:
            path = await run(stop, state["dir"])
        except asyncio.TimeoutError:
            # Keep the claim: the stop may still land, and a retry cleans
            # up; a new start must not race it.
            raise web.HTTPGatewayTimeout(
                text=f"profiler stop exceeded {timeout_s}s; retry to "
                     f"attempt cleanup")
        except Exception as exc:  # noqa: BLE001 - nothing to stop
            state["dir"] = None
            raise web.HTTPConflict(
                text=f"profiler stop failed: {exc}") from exc
        trace_dir, state["dir"] = state["dir"], None
        return web.json_response({"status": "written", "dir": trace_dir,
                                  "trace": path})

    async def _shutdown(_app) -> None:
        worker.shutdown(wait=False)

    app.router.add_post("/profiler/start", profiler_start)
    app.router.add_post("/profiler/stop", profiler_stop)
    app.on_cleanup.append(_shutdown)


def create_server_app(engine: Engine, embed_service=None,
                      model_name: str = "model") -> web.Application:
    """One app over one engine (and optional embedder): ``/health``, the
    OpenAI routes,
    ``/v1/score``, ``/metrics``, the ``/debug/*`` and ``/control/incident``
    routes and the profiler routes (see the module docstring). The
    retained telemetry's sampler starts with the app and stops at its
    cleanup, as does the engine."""
    from .openai_api import add_openai_routes

    app = web.Application()

    async def health(request: web.Request) -> web.Response:
        return web.json_response(
            {"status": "ok", "model": model_name,
             "quantization": weight_mode(engine.params["layers"]["wq"]),
             "kv_quant": engine.cfg.kv_quant,
             "engine": dict(engine.stats)})

    def _mirror_engine_stats() -> None:
        obs_metrics.record_engine_stats(engine.stats)

    async def metrics_endpoint(request: web.Request) -> web.Response:
        # Scrape-time pull: every numeric stats key as an engine_* gauge,
        # plus the process gauges. A scrape never answers 500.
        try:
            _mirror_engine_stats()
        except Exception:  # noqa: BLE001
            logger.debug("engine stats unavailable", exc_info=True)
        obs_metrics.record_process_stats()
        return web.Response(text=obs_metrics.REGISTRY.render_prometheus(),
                            content_type="text/plain")

    async def debug_requests(request: web.Request) -> web.Response:
        return obs_flight.debug_requests_response(request, engine.flight)

    async def debug_rounds(request: web.Request) -> web.Response:
        return obs_rounds.debug_rounds_response(request, engine.rounds)

    # History, alerts and incident bundles as one unit; engine stats and
    # process gauges go into every sample, so alerts see them between
    # scrapes.
    obs_stack = obs_incidents.ObservabilityStack(
        "model", pre_sample=[_mirror_engine_stats,
                             obs_metrics.record_process_stats],
        flight=engine.flight, rounds=engine.rounds)

    async def debug_history(request: web.Request) -> web.Response:
        return obs_history.debug_history_response(request, obs_stack.history)

    async def debug_alerts(request: web.Request) -> web.Response:
        return obs_alerts.debug_alerts_response(request, obs_stack.alerts)

    async def debug_incidents(request: web.Request) -> web.Response:
        return obs_incidents.debug_incidents_response(request, obs_stack)

    async def control_incident(request: web.Request) -> web.Response:
        return await obs_incidents.control_incident_response(request,
                                                             obs_stack)

    async def _obs_start(_app) -> None:
        obs_stack.start()

    async def _cleanup(_app) -> None:
        obs_stack.stop()
        engine.stop()

    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/debug/requests", debug_requests)
    app.router.add_get("/debug/rounds", debug_rounds)
    app.router.add_get("/debug/history", debug_history)
    app.router.add_get("/debug/alerts", debug_alerts)
    app.router.add_get("/debug/incidents", debug_incidents)
    app.router.add_post("/control/incident", control_incident)
    add_openai_routes(app, engine, model_name, embed_service=embed_service,
                      max_output=engine.cfg.max_output_length)
    add_score_route(app, engine, model_name)
    add_profiler_routes(app, engine)
    app.on_startup.append(_obs_start)
    app.on_cleanup.append(_cleanup)
    return app


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Serve a llama checkpoint directory, or a registry "
                    "model with random weights, over HTTP")
    parser.add_argument("model_name", nargs="?", default="llama-2-7b-chat")
    parser.add_argument("--model-path",
                        default=os.environ.get("MODEL_PATH", ""),
                        help="checkpoint directory (safetensors, "
                             "pytorch_model*.bin or Meta .pth, with its "
                             "tokenizer.model or tokenizer.json); default "
                             "$MODEL_PATH; none: random weights from "
                             "--seed and the byte tokenizer")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=sorted(_DTYPES))
    parser.add_argument("--max-batch-size", type=int, default=8)
    parser.add_argument("--max-input-length", type=int, default=3000)
    parser.add_argument("--max-output-length", type=int, default=512)
    parser.add_argument("--page-size", type=int, default=128)
    parser.add_argument("--kv-pool-tokens", type=int, default=0,
                        help="pool size in tokens (0 = fit free memory)")
    parser.add_argument("--quantization", default="",
                        choices=["", *MODES],
                        help="weight-only quantization of the weights, "
                             "made on the device. int4 and "
                             "int4_awq run the int4 kernel; int8 has no "
                             "kernel yet: each product widens the int8 "
                             "weight to bf16 per call, so it streams more "
                             "bytes per decode step than bf16 serving")
    parser.add_argument("--kv-quant", default="", choices=["", "int8"],
                        help="KV-cache quantization: int8 pool pages + "
                             "per-row bf16 scales")
    parser.add_argument("--embedder-path", default="",
                        help="e5-large-v2 checkpoint directory for "
                             "/v1/embeddings (HF BERT safetensors and its "
                             "tokenizer); none: encoder-tiny with random "
                             "weights")
    parser.add_argument("--no-embedder", action="store_true",
                        help="serve no embedder (/v1/embeddings: 501)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args(argv)
    engine_cfg = EngineConfig(
        max_slots=args.max_batch_size,
        max_input_length=args.max_input_length,
        max_output_length=args.max_output_length,
        page_size=args.page_size, dtype=args.dtype,
        kv_pool_tokens=args.kv_pool_tokens or "auto",
        kv_quant=args.kv_quant)
    engine, name = build_services(args.model_name, engine_cfg=engine_cfg,
                                  seed=args.seed, device=args.device,
                                  quantization=args.quantization,
                                  model_path=args.model_path)
    embed_service = (None if args.no_embedder else
                     build_embedder(args.embedder_path, device=args.device))
    bootstrap_logging()
    pid_path = write_pid_file(f"model-server-{args.port}")
    if pid_path:
        logger.info("pid file: %s", pid_path)
    # Serve a worst-case request through the real loop before taking
    # traffic; the pool shrinks if the card runs out of memory.
    engine.prewarm()
    engine.start()
    web.run_app(create_server_app(engine, embed_service, name),
                host=args.host, port=args.port)
