"""Model server of the port: builds an engine and serves it over aiohttp.

    python -m generativeaiexamples_tpu_torch.serving llama-2-7b-chat \\
        --port 8000 [--device cuda] [--seed 0] [--kv-pool-tokens N] \\
        [--quantization {int8,int4,int4_awq}] [--kv-quant int8]

The repository holds no checkpoint for the served geometries, so
``build_services`` makes random weights on the device from ``--seed``
and, with ``--quantization``, quantizes them there
(``ops.quant.quantize_params``); loading real weights waits for a later
slice. Routes: ``/health`` (with the weight and KV quantization modes)
and ``POST /v1/completions`` (``serving/openai_api.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Union

import torch
from aiohttp import web

from ..engine.engine import _DTYPES, Engine, EngineConfig
from ..models import llama
from ..models.configs import get_model_config
from ..models.tokenizer import get_tokenizer
from ..ops.quant import MODES, quantize_params, weight_mode
from ..utils.device import resolve_device
from ..utils.errors import ConfigError


def build_services(model_name: str = "llama-2-7b-chat", *,
                   engine_cfg: EngineConfig = EngineConfig(),
                   seed: int = 0,
                   device: Union[str, torch.device] = "cuda",
                   tokenizer: str = "byte",
                   quantization: str = "") -> tuple[Engine, str]:
    """An engine for registry model ``model_name`` with random weights
    made on ``device`` from ``seed`` in the engine config's dtype, and
    quantized there when ``quantization`` is one of ``ops.quant.MODES``
    (int4_awq groups: AWQ's usual 128, or the largest of 64 and 32 that
    divides every reduction dim, for the tiny geometries). The KV pool's
    mode is ``engine_cfg.kv_quant``. Returns (engine, model name)."""
    if quantization and quantization not in MODES:
        raise ValueError(f"quantization={quantization!r}: use one of "
                         f"{MODES} or ''")
    dev = resolve_device(device)
    cfg = get_model_config(model_name)
    params = llama.init_params(cfg, seed=seed,
                               dtype=_DTYPES[engine_cfg.dtype], device=dev)
    if quantization:
        dims = (cfg.hidden_size, cfg.q_dim, cfg.intermediate_size)
        group = next((g for g in (128, 64, 32)
                      if all(d % g == 0 for d in dims)), None)
        if group is None:
            raise ConfigError(f"no int4_awq group of 128, 64 or 32 divides "
                              f"the reduction dims {dims}")
        params = quantize_params(params, mode=quantization, group_size=group)
    engine = Engine(params, cfg, get_tokenizer(tokenizer),
                    dataclasses.replace(engine_cfg, seed=seed), device=dev)
    return engine, model_name


def create_server_app(engine: Engine,
                      model_name: str = "model") -> web.Application:
    """One app: ``/health`` plus the OpenAI completions route."""
    from .openai_api import add_openai_routes

    app = web.Application()

    async def health(request: web.Request) -> web.Response:
        return web.json_response(
            {"status": "ok", "model": model_name,
             "quantization": weight_mode(engine.params["layers"]["wq"]),
             "kv_quant": engine.cfg.kv_quant,
             "engine": dict(engine.stats)})

    app.router.add_get("/health", health)
    add_openai_routes(app, engine, model_name,
                      max_output=engine.cfg.max_output_length)

    async def _stop_engine(_app) -> None:
        engine.stop()

    app.on_cleanup.append(_stop_engine)
    return app


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Serve a registry model (random weights) over HTTP")
    parser.add_argument("model_name", nargs="?", default="llama-2-7b-chat")
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
                        help="weight-only quantization of the random "
                             "weights, made on the device. int4 and "
                             "int4_awq run the int4 kernel; int8 has no "
                             "kernel yet: each product widens the int8 "
                             "weight to bf16 per call, so it streams more "
                             "bytes per decode step than bf16 serving")
    parser.add_argument("--kv-quant", default="", choices=["", "int8"],
                        help="KV-cache quantization: int8 pool pages + "
                             "per-row bf16 scales")
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
                                  quantization=args.quantization)
    engine.start()
    web.run_app(create_server_app(engine, name), host=args.host,
                port=args.port)
