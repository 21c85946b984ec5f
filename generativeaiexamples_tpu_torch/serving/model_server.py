"""Model server of the port: builds an engine and serves it over aiohttp.

    python -m generativeaiexamples_tpu_torch.serving llama-2-7b-chat \\
        --port 8000 [--model-path DIR] [--device cuda] [--seed 0] \\
        [--kv-pool-tokens N] [--quantization {int8,int4,int4_awq}] \\
        [--kv-quant int8] [--embedder-path DIR | --no-embedder] \\
        [--grpc-port 8001] [--world-size N] [--tensor-parallelism TP] \\
        [--pipeline-parallelism 1]

With ``--model-path`` (default ``$MODEL_PATH``, else the one model
directory under ``$AZUREML_MODEL_DIR`` on an AzureML managed endpoint:
``resolve_azureml_model_dir``) ``build_services`` follows
the reference's order: the tokenizer from the directory
(``tokenizer.model``, else ``tokenizer.json``), the weights loaded onto
the device in the engine's dtype (``models/import_hf.py``: safetensors,
``pytorch_model*.bin`` or Meta ``consolidated.*.pth``; GPTQ and AWQ
directories through ``models/import_quantized.py``, a ``.nemo`` archive
through ``models/import_nemo.py``), then, with ``--quantization``,
quantized there. The geometry is the registry model's, overridden by the
directory's ``config.json`` (or a ``.nemo``'s ``model_config.yaml``)
where it has one. The served tree is cached on disk
(``models/weight_cache.py``) under ``name-dtype-quant-hash``, the hash
being the directory's content hash (``fast_hash_dir``), so a restart
skips the conversion; ``GAIE_SKIP_HASH=1`` skips both the hash and the
cache, ``GAIE_WEIGHT_CACHE=0`` the cache. Without a path the server makes
random weights on the device from ``--seed`` and serves the byte
tokenizer. ``nemotron-8b-chat`` serves the GPT-Next family
(layernorm1p, squared-ReLU MLP).

Tensor parallelism (``--world-size``, ``--tensor-parallelism``,
``--pipeline-parallelism``, the reference's flags; the world defaults
to every local card, as the reference's does, and ``--device cuda:N``
names one card: ``cli_topology``): at a world of more than one the CLI
spawns ``world - 1`` follower processes (``torch.multiprocessing``,
spawn), one per card, joins them in an NCCL group (gloo with ``--device
cpu``) and serves from rank 0; each rank loads only its own block of
every leaf of the checkpoint (``load_checkpoint(..., mesh=)``, every
format; a quantization at load reduces a row-parallel weight's
per-channel absmax over the ranks first), or makes its own shard of the
random weights (``llama.init_params(..., mesh=)``), and runs its
``Engine`` over it, the followers in ``Engine.follow``. The weight cache
keeps one entry per rank (``...-tp{N}-r{rank}-hash``; the leader hashes
the directory and shares the hash). A follower that dies takes the
server down: ``/health`` answers 503 and the process exits. pp > 1 and
multi-host runs are refused.

The embedder behind ``/v1/embeddings`` (``build_embedder``) is the
e5-large-v2 checkpoint in ``--embedder-path``, else ``encoder-tiny`` with
random weights; ``--no-embedder`` serves none (the route then answers
501).

Routes: ``/health`` (with the weight and KV quantization modes); the
OpenAI routes of ``serving/openai_api.py`` (``/v1/completions``,
``/v1/chat/completions``, ``/v1/models``, ``/v1/embeddings``); the
Triton generate extension of ``serving/triton_shim.py``
(``/v2/models/{model}/generate[_stream]``, the ready endpoints); the job
routes of ``serving/jobs_api.py`` (``/v1/jobs``, submit then poll);
``POST /v1/score`` (per-token NLL and perplexity of a text
or token list, ``models/llama.py`` ``score``; at tp > 1 run by every
rank on the serve thread, ``Engine.score``); ``/metrics`` (Prometheus
text: the engine's stats as ``engine_*`` gauges, the round metrics, the
stage histograms, the request timers, the process gauges);
``/debug/requests`` (flight-recorder timelines), ``/debug/launches``
and ``/debug/load`` (each rank's kernel launch counters and its load
report: seconds, device peak, host RSS growth), ``/debug/rounds`` (round
records), ``/debug/history``, ``/debug/alerts``, ``/debug/incidents`` and
``POST /control/incident`` (the retained telemetry, inert with
``HISTORY_INTERVAL_S=0``); ``POST /profiler/start`` (body ``{"dir": ...}``)
and ``POST /profiler/stop``, a ``torch.profiler`` session whose Chrome
trace lands in that directory. The CLI also serves the gRPC
``LLMService`` of ``serving/grpc_server.py`` on ``--grpc-port`` (default
8001; 0 serves none; without the ``grpcio`` package a port other than 0
raises ``ConfigError``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import functools
import hashlib
import os
import socket
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from aiohttp import web

from ..engine.engine import _DTYPES, Engine, EngineConfig
from ..models import llama, weight_cache
from ..models.configs import (LlamaConfig, config_for_checkpoint,
                              get_model_config)
from ..models.import_hf import (detect_checkpoint_format, leaf_specs,
                                load_checkpoint)
from ..models.tokenizer import Tokenizer, get_tokenizer
from ..obs import alerts as obs_alerts
from ..obs import flight as obs_flight
from ..obs import history as obs_history
from ..obs import incidents as obs_incidents
from ..obs import metrics as obs_metrics
from ..obs import rounds as obs_rounds
from ..ops.quant import MODES, quantize_params, weight_mode
from ..parallel import comm
from ..parallel.mesh import (Mesh, MeshPlan, make_mesh,
                             maybe_init_distributed)
from ..utils.device import resolve_device
from ..utils.errors import ConfigError, EngineError
from ..utils.logging import bootstrap_logging, get_logger, write_pid_file

logger = get_logger(__name__)


def fast_hash_dir(path: str, workers: int = 8) -> str:
    """Content hash of a model directory: the sha1 of every file (read in
    parallel), joined in path order with the relative paths (the
    reference's ``fast_hash_dir``)."""
    files = sorted(os.path.join(root, n) for root, _, names in os.walk(path)
                   for n in names)

    def hash_one(p: str) -> str:
        h = hashlib.sha1()
        with open(p, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()

    top = hashlib.sha1()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for p, digest in zip(files, pool.map(hash_one, files)):
            top.update(os.path.relpath(p, path).encode())
            top.update(digest.encode())
    return top.hexdigest()


def resolve_azureml_model_dir(model_path: str = "") -> str:
    """The checkpoint directory on an AzureML managed endpoint: with no
    explicit ``model_path`` and ``AZUREML_MODEL_DIR`` set, the model lives
    one level under it (``$AZUREML_MODEL_DIR/<model_name>``), the first
    directory there in name order (MLflow puts ``MLmodel``, ``conda.yaml``
    and hidden files beside it). ``model_path`` unchanged otherwise;
    ``ConfigError`` when that directory holds no model directory."""
    if model_path:
        return model_path
    aml = os.environ.get("AZUREML_MODEL_DIR", "")
    if not aml:
        return model_path
    aml = os.path.abspath(aml)
    entries = [n for n in sorted(os.listdir(aml))
               if os.path.isdir(os.path.join(aml, n))
               and not n.startswith(".")] if os.path.isdir(aml) else []
    if not entries:
        raise ConfigError(
            f"AZUREML_MODEL_DIR={aml} contains no model directory: "
            "AzureML folder structure not recognized")
    resolved = os.path.join(aml, entries[0])
    logger.info("AzureML detected: model dir %s", resolved)
    return resolved


def awq_group(cfg: LlamaConfig, mesh: Optional[Mesh] = None) -> int:
    """The int4_awq group for ``cfg``: AWQ's usual 128, or the largest of
    64 and 32 that divides every reduction dim a rank holds (the tiny
    geometries; under ``mesh`` the K/tp rows of wo and w_down that
    ``llama.tp_layout`` gives a rank, so each keeps whole groups:
    llama-2-7b's F/4 = 2752 takes 64). Raises ``ConfigError`` when none
    does."""
    local = llama.tp_layout(cfg, mesh).cfg
    dims = (local.hidden_size, local.q_dim, local.intermediate_size)
    group = next((g for g in (128, 64, 32)
                  if all(d % g == 0 for d in dims)), None)
    if group is None:
        raise ConfigError(f"no int4_awq group of 128, 64 or 32 divides the "
                          f"reduction dims {dims}; use int4 (per channel)")
    return group


def resolve_topology(world_size: int = 0, tp: int = 0, pp: int = 1,
                     available: Optional[int] = None) -> tuple[int, int, int]:
    """(world, tp, pp) with the reference's defaulting rules: the world
    defaults to every available device, tp to world / pp, and TP·PP must
    equal the world size. ``pp > 1`` is refused before anything loads:
    decode runs all layers as one program per round, so pipeline stages
    would idle 1/pp of every round. ``available``: the cards by default
    (``torch.cuda.device_count()``)."""
    if pp > 1:
        raise ConfigError(
            f"serving requires pp == 1 (got pp={pp}): decode runs all "
            f"layers as one program per round; shard serving over tp "
            f"instead — pp is training-only")
    if available is None:
        available = torch.cuda.device_count()
    world = world_size or available
    if world > available:
        raise ConfigError(
            f"world size {world} exceeds available devices {available}")
    tp = tp or max(1, world // pp)
    if tp * pp != world:
        raise ConfigError(
            f"tensor parallelism ({tp}) x pipeline parallelism ({pp}) "
            f"must equal world size ({world})")
    return world, tp, pp


def cli_topology(args: argparse.Namespace,
                 available: Optional[int] = None) -> tuple[int, int, int]:
    """The CLI's (world, tp, pp) by ``resolve_topology``'s rules: the
    world defaults to every local card, as the reference's does (one
    process with ``--device cpu`` unless ``--world-size`` or
    ``--tensor-parallelism`` asks for more; ``--tensor-parallelism``
    times pp when ``--world-size`` is not given). A ``--device`` that
    names one card (``cuda:N``) serves on that card alone, and a world
    above one with it is refused before any process starts (rank r runs
    on card r). ``available``: the local cards by default, the world asked
    for with ``--device cpu``."""
    pp = args.pipeline_parallelism
    asked = args.world_size or args.tensor_parallelism * pp
    dev = torch.device(args.device)
    if dev.index is not None or (dev.type == "cpu" and not asked):
        if asked > 1:
            raise ConfigError(
                f"--device {args.device} names one card, but a world of "
                f"{asked} runs rank r on card r: pass --device cuda")
        return resolve_topology(1, args.tensor_parallelism, pp, available=1)
    if available is None:
        available = torch.cuda.device_count() if dev.type != "cpu" else asked
    return resolve_topology(asked, args.tensor_parallelism, pp,
                            available=available)


# The reference CLI's model types, each served as its default registry
# model (the reference's ``MODEL_TYPES`` and ``_TYPE_DEFAULT_NAME``): the
# port's CLI takes a type where it takes a model name.
TYPE_DEFAULT_NAME = {
    "llama": "llama-2-7b-chat",
    "codellama": "codellama-13b-instruct",
    "gptnext": "nemotron-8b-chat",
    "mixtral": "mixtral-8x7b-instruct",
    "dev": "llama-tiny",
}


# What the last ``build_services`` with a model path did: the checkpoint
# format, the cache identity (None without a content hash), whether the
# tree came from the weight cache, and the load seconds (conversion or
# cache read, to the device).
last_load: dict = {}


def build_services(model_name: str = "llama-2-7b-chat", *,
                   engine_cfg: EngineConfig = EngineConfig(),
                   seed: int = 0,
                   device: Union[str, torch.device] = "cuda",
                   tokenizer: Union[str, Tokenizer] = "byte",
                   quantization: str = "",
                   model_path: str = "", world_size: int = 0, tp: int = 0,
                   pp: int = 1) -> tuple[Engine, str]:
    """An engine for registry model ``model_name`` in the engine config's
    dtype on ``device``: with ``model_path``, the checkpoint there
    (HF, Meta, GPTQ, AWQ or ``.nemo``; the geometry from its
    ``config.json`` or ``model_config.yaml`` where it has one) and its own
    tokenizer; else random weights made on the device from ``seed`` and
    the ``tokenizer`` spec. A ``Tokenizer`` object passed as
    ``tokenizer`` is used either way. With ``quantization`` (one of
    ``ops.quant.MODES``) the weights are quantized on the device
    (int4_awq groups: ``awq_group``; leaves a GPTQ/AWQ checkpoint
    quantized already stay as they are). A checkpoint's served tree goes
    through the weight cache, keyed ``name-dtype-quant-hash``
    (``GAIE_SKIP_HASH`` skips the hash and the cache,
    ``GAIE_WEIGHT_CACHE=0`` the cache and so the hash). The KV pool's mode
    is ``engine_cfg.kv_quant``. ``world_size``, ``tp``, ``pp``: the
    topology (``resolve_topology``'s rules; the world defaults to the
    process group's, one process without one): at a world of more than
    one, every rank of the initialized process group calls this and gets
    its engine over its tensor-parallel shard (each rank reads only its
    block of the checkpoint, or makes its own shard of the random
    weights). Returns (engine, model name)."""
    if quantization and quantization not in MODES:
        raise ValueError(f"quantization={quantization!r}: use one of "
                         f"{MODES} or ''")
    dev = resolve_device(device)
    grouped = dist.is_initialized()
    world = world_size or (dist.get_world_size() if grouped else 1)
    world, tp, pp = resolve_topology(world, tp, pp, available=world)
    mesh = None
    if world > 1:
        if not grouped or dist.get_world_size() != world:
            raise ConfigError(
                f"a world of {world} needs one process per rank in an "
                f"initialized process group (maybe_init_distributed; the "
                f"CLI spawns them)")
        mesh = make_mesh(MeshPlan(tp=tp, pp=pp), device=dev)
    cfg = get_model_config(model_name)
    dtype = _DTYPES[engine_cfg.dtype]
    model_path = resolve_azureml_model_dir(model_path)
    if model_path:
        # The format first: an unrecognised directory fails before
        # anything else is read.
        fmt = detect_checkpoint_format(model_path)
        cfg = config_for_checkpoint(model_path, cfg)
        llama.check_supported(cfg)
        tok = (tokenizer if not isinstance(tokenizer, str)
               else get_tokenizer(model_path))
        params = _load_served_tree(model_name, model_path, fmt, cfg,
                                   engine_cfg.dtype, quantization, dev, mesh)
    else:
        tok = (get_tokenizer(tokenizer) if isinstance(tokenizer, str)
               else tokenizer)
        # Quantized slab by slab; under tp each rank draws every leaf
        # whole, quantizes it and keeps its block: the tp = 1 tree of
        # this seed, split.
        params = llama.init_params(
            cfg, seed=seed, dtype=dtype, device=dev, mesh=mesh,
            quantization=quantization,
            group_size=(awq_group(cfg, mesh) if quantization == "int4_awq"
                        else 128))
    engine = Engine(params, cfg, tok,
                    dataclasses.replace(engine_cfg, seed=seed), device=dev,
                    mesh=mesh)
    if model_path:
        engine.load_report = dict(last_load)
    return engine, model_name


def _quantize(params: llama.Params, cfg: LlamaConfig, quantization: str,
              mesh: Optional[Mesh] = None) -> llama.Params:
    """``quantize_params`` of a loaded tree; under ``mesh`` a shard whose
    row-parallel weights' per-channel scales are the whole weights'
    (their absmax reduced by MAX over the ranks) and whose int4_awq
    groups tile each rank's rows (``awq_group``)."""
    group = awq_group(cfg, mesh) if quantization == "int4_awq" else 128
    k_split: tuple = ()
    if comm.sharded(mesh):
        specs = leaf_specs(cfg, mesh)
        k_split = tuple(k.removeprefix("layers/") for k, v in specs.items()
                        if len(v) >= 2 and v[-2] is not None)
    return quantize_params(params, mode=quantization, group_size=group,
                           k_split=k_split, reduce_absmax=functools.partial(
                               comm.all_reduce_max_, mesh=mesh))


def _rss() -> int:
    """This process's resident bytes (``/proc/self/statm``; 0 where it is
    not readable)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class _RssPeak:
    """The largest resident size seen while the block runs, sampled every
    ``interval`` seconds on a thread (``getrusage``'s peak is the
    process's whole life, reached before a load as often as in it)."""

    def __init__(self, interval: float = 0.005):
        self.interval, self.peak = interval, 0
        self._done = threading.Event()

    def _sample(self) -> None:
        while not self._done.wait(self.interval):
            self.peak = max(self.peak, _rss())

    def __enter__(self) -> "_RssPeak":
        self.before = self.peak = _rss()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, _rss())


def _agreed_cache_read(identity: str, dev: torch.device,
                       mesh: Optional[Mesh]) -> Optional[llama.Params]:
    """The weight cache's tree for ``identity``, or None. Under tp the
    ranks agree first (``comm.agree``): a rank whose entry is missing or
    unreadable sends every rank to the conversion, whose quantization
    holds collectives that all ranks must reach together."""
    params = weight_cache.load(identity, device=dev)
    if comm.agree(params is not None, mesh):
        return params
    return None


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for v in tree.values() for t in llama.param_tensors(v))


def _load_served_tree(model_name: str, model_path: str, fmt: str,
                      cfg: LlamaConfig, dtype: str, quantization: str,
                      dev: torch.device,
                      mesh: Optional[Mesh] = None) -> llama.Params:
    """The served tree of a checkpoint: loaded (and quantized) on the
    device, or read back from the weight cache when the directory's
    content hash names an entry. Under ``mesh`` this rank's shard: read
    block by block, cached in an entry of its own
    (``name-dtype-quant-tp{N}-r{rank}-hash``), the hash computed by the
    leader alone and shared, the ranks agreeing on reading it
    (``_agreed_cache_read``). ``last_load`` records the seconds, the
    device peak over the load (``max_memory_allocated``) and the served
    tree's bytes; under tp also the growth of the host's resident memory
    (its peak during the load, sampled every 5 ms, over its size
    before)."""
    def convert() -> llama.Params:
        p = load_checkpoint(model_path, cfg, dtype=_DTYPES[dtype],
                            device=dev, mesh=mesh)
        return _quantize(p, cfg, quantization, mesh) if quantization else p

    t0 = time.monotonic()
    if dev.type == "cuda":
        # The caching allocator's peak can be reset only once it exists,
        # and a load may be the process's first use of the card.
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    base = f"{model_name}-{dtype}-{quantization or 'raw'}"
    if comm.sharded(mesh):
        base += f"-tp{mesh.tp}-r{mesh.tp_rank}"
    identity, from_cache = None, False
    with (_RssPeak() if comm.sharded(mesh)
          else contextlib.nullcontext()) as rss:
        if os.environ.get("GAIE_SKIP_HASH") or not weight_cache.enabled():
            # Without the content hash an updated checkpoint at the same
            # path would be served stale from the cache: skip both. With
            # the cache off the hash names nothing: skip it too.
            params = convert()
        else:
            digest = comm.share_from_leader(
                fast_hash_dir(model_path)
                if mesh is None or mesh.leader else None, mesh)
            identity = f"{base}-{digest[:12]}"
            params = _agreed_cache_read(identity, dev, mesh)
            from_cache = params is not None
            if not from_cache:
                params = convert()
                weight_cache.save(identity, params, prune_prefix=base + "-")
    peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    last_load.clear()
    last_load.update(format=fmt, identity=identity, from_cache=from_cache,
                     seconds=time.monotonic() - t0,
                     rank=mesh.tp_rank if mesh is not None else 0,
                     tree_bytes=_tree_bytes(params),
                     max_memory_allocated=peak)
    if rss is not None:
        last_load.update(rss_before=rss.before, rss_peak=rss.peak,
                         rss_growth=rss.peak - rss.before)
    logger.info("model %s (%s) loaded in %.1f s%s", model_path, fmt,
                last_load["seconds"],
                " from the weight cache" if from_cache else "")
    return params


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
    loop; at tp > 1 ``Engine.score`` runs it on every rank between two
    programs."""
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
        try:
            async with gate:
                nll = await loop.run_in_executor(
                    None, functools.partial(engine.score, ids, chunk))
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
                      model_name: str = "model", *,
                      close_engine: bool = False) -> web.Application:
    """One app over one engine (and optional embedder): ``/health``, the
    OpenAI routes, the Triton generate extension, the job routes,
    ``/v1/score``, ``/metrics``, the ``/debug/*`` and ``/control/incident``
    routes and the profiler routes (see the module docstring). The
    retained telemetry's sampler starts with the app and stops at its
    cleanup, as does the engine; with ``close_engine`` the cleanup
    closes it (``Engine.close``: its device memory goes back), as the
    CLI's shutdown does."""
    from .jobs_api import add_jobs_routes
    from .openai_api import add_openai_routes
    from .triton_shim import add_triton_routes

    app = web.Application()

    async def health(request: web.Request) -> web.Response:
        fatal = engine._fatal
        if fatal is not None:
            # The serve loop failed, or a tensor-parallel follower died.
            return web.json_response(
                {"status": "error", "model": model_name,
                 "error": repr(fatal)}, status=503)
        return web.json_response(
            {"status": "ok", "model": model_name,
             "quantization": weight_mode(engine.params["layers"]["wq"]),
             "kv_quant": engine.cfg.kv_quant,
             "tp": engine.mesh.tp if engine.mesh is not None else 1,
             "engine": dict(engine.stats)})

    async def debug_launches(request: web.Request) -> web.Response:
        # Each rank's kernel launch counters, gathered between two
        # programs (``Engine.rank_reports``).
        ranks = await asyncio.get_running_loop().run_in_executor(
            None, engine.rank_reports)
        return web.json_response(
            {"ranks": [r["launch_counts"] for r in ranks]})

    async def debug_load(request: web.Request) -> web.Response:
        # Each rank's checkpoint load report (``last_load``; empty with
        # random weights).
        ranks = await asyncio.get_running_loop().run_in_executor(
            None, engine.rank_reports)
        return web.json_response({"ranks": [r["load"] for r in ranks]})

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
        if close_engine:
            engine.close()
        else:
            engine.stop()

    app.router.add_get("/health", health)
    app.router.add_get("/metrics", metrics_endpoint)
    app.router.add_get("/debug/requests", debug_requests)
    app.router.add_get("/debug/launches", debug_launches)
    app.router.add_get("/debug/load", debug_load)
    app.router.add_get("/debug/rounds", debug_rounds)
    app.router.add_get("/debug/history", debug_history)
    app.router.add_get("/debug/alerts", debug_alerts)
    app.router.add_get("/debug/incidents", debug_incidents)
    app.router.add_post("/control/incident", control_incident)
    add_openai_routes(app, engine, model_name, embed_service=embed_service,
                      max_output=engine.cfg.max_output_length)
    add_triton_routes(app, engine, model_name,
                      max_output=engine.cfg.max_output_length)
    add_jobs_routes(app, engine, model_name,
                    max_output=engine.cfg.max_output_length)
    add_score_route(app, engine, model_name)
    add_profiler_routes(app, engine)
    app.on_startup.append(_obs_start)
    app.on_cleanup.append(_cleanup)
    return app


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve a llama checkpoint directory, or a registry "
                    "model with random weights, over HTTP")
    parser.add_argument("model_name", nargs="?", default="llama-2-7b-chat",
                        help="a registry model (llama-2-7b-chat, "
                             "mixtral-8x7b-instruct, nemotron-8b-chat, ...) "
                             "or one of the reference's model types "
                             f"{tuple(TYPE_DEFAULT_NAME)}, served as its "
                             "default model")
    parser.add_argument("--model-path",
                        default=os.environ.get("MODEL_PATH", ""),
                        help="checkpoint directory (safetensors, "
                             "pytorch_model*.bin, Meta .pth, GPTQ, AWQ or "
                             "a .nemo archive, with its tokenizer.model "
                             "or tokenizer.json); default $MODEL_PATH; "
                             "none: random weights from --seed and the "
                             "byte tokenizer")
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
    parser.add_argument("--grpc-port", type=int, default=8001,
                        help="gRPC LLMService port (0 serves none)")
    parser.add_argument("--world-size", type=int, default=0,
                        help="devices to use, one process each (default: "
                             "tp x pp with --tensor-parallelism, else 1)")
    parser.add_argument("--tensor-parallelism", type=int, default=0,
                        help="tp degree (default: world size / pp)")
    parser.add_argument("--pipeline-parallelism", type=int, default=1,
                        help="pp degree: serving refuses pp > 1")
    return parser


def _build_rank(args: argparse.Namespace, world: int, tp: int
                ) -> tuple[Engine, str]:
    """This rank's engine for the CLI's arguments."""
    engine_cfg = EngineConfig(
        max_slots=args.max_batch_size,
        max_input_length=args.max_input_length,
        max_output_length=args.max_output_length,
        page_size=args.page_size, dtype=args.dtype,
        kv_pool_tokens=args.kv_pool_tokens or "auto",
        kv_quant=args.kv_quant)
    model_name = TYPE_DEFAULT_NAME.get(args.model_name, args.model_name)
    return build_services(model_name, engine_cfg=engine_cfg,
                          seed=args.seed, device=args.device,
                          quantization=args.quantization,
                          model_path=args.model_path, world_size=world,
                          tp=tp)


def _follower_main(argv: list[str], rank: int, world: int, tp: int,
                   init_method: str) -> None:
    """A tensor-parallel follower process of the CLI: join the group,
    build this rank's engine, replay the leader's programs until it
    closes. It exits when the leader's process goes away."""
    import signal

    # The leader ends the group (its shutdown closes this loop); an
    # interrupt meant for the server must not kill a rank under it.
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    args = _parser().parse_args(argv)
    bootstrap_logging()
    parent = os.getppid()

    def watch_parent() -> None:
        while os.getppid() == parent:
            time.sleep(1.0)
        logger.error("tp rank %d: the leader's process is gone", rank)
        os._exit(1)
    threading.Thread(target=watch_parent, daemon=True).start()
    maybe_init_distributed(init_method, world, rank, device=args.device)
    engine, _ = _build_rank(args, world, tp)
    engine.follow()
    engine.close()
    dist.destroy_process_group()


def _spawn_followers(argv: list[str], world: int, tp: int,
                     init_method: str) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower_main,
                         args=(argv, rank, world, tp, init_method),
                         name=f"tp-rank-{rank}", daemon=True)
             for rank in range(1, world)]
    for proc in procs:
        proc.start()
    return procs


def _watch_followers(procs: list, engine: Engine) -> None:
    """A follower that exits while rank 0 serves fails the engine (its
    ``/health`` answers 503) and, a moment later, the server: the group
    cannot run a program without it."""
    def watch() -> None:
        while not engine._closing:
            for proc in procs:
                if not proc.is_alive() and not engine._closing:
                    engine._fatal = EngineError(
                        f"tensor-parallel {proc.name} exited with code "
                        f"{proc.exitcode}")
                    logger.error("%s", engine._fatal)
                    time.sleep(2.0)
                    os._exit(1)
            time.sleep(0.5)
    threading.Thread(target=watch, daemon=True,
                     name="tp-followers-watch").start()


def main(argv: Optional[list[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.grpc_port:
        # Refused before the weights load, not after.
        from .grpc_server import require_grpc
        require_grpc()
    world, tp, _pp = cli_topology(args)
    followers = []
    if world > 1:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            init_method = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
        followers = _spawn_followers(argv, world, tp, init_method)
        maybe_init_distributed(init_method, world, 0, device=args.device)
    engine, name = _build_rank(args, world, tp)
    if followers:
        _watch_followers(followers, engine)
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
    grpc_server = None  # held: a grpc.Server stops when collected
    if args.grpc_port:
        from .grpc_server import serve_grpc
        grpc_server = serve_grpc(engine, name, embed_service,
                                 max_output=engine.cfg.max_output_length,
                                 host=args.host, port=args.grpc_port)
    try:
        web.run_app(create_server_app(engine, embed_service, name,
                                      close_engine=True),
                    host=args.host, port=args.port)
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=1.0)
        if followers:
            # The app's cleanup closed the engine, which closed the
            # followers' loops.
            for proc in followers:
                proc.join(timeout=60)
            dist.destroy_process_group()
