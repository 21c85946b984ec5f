"""Continuous-batching inference engine over a paged KV pool — the reduced
port of the reference's ``engine/engine.py``.

- **Decode slots.** ``max_slots`` requests decode together; every decode
  step runs the whole slot batch, inactive slots masked. Requests join and
  leave between rounds.
- **Paged KV pool.** KV lives in a pool of fixed-size pages shared through
  per-slot block tables. Admission allocates a request's whole extent
  (prompt + max_tokens) and waits when the pool is exhausted. Physical
  page 0 is the trash page: inactive slots and prefill overhang write
  there, and no live slot ever reads it.
- **Prefix cache.** Prompts are hashed in page-sized blocks
  (``engine/prefix_cache.py``); admission maps the longest cached prefix
  into the slot's table read-only and prefills from the first uncached
  token. Retired requests' prompt pages stay resident until pool
  pressure evicts them.
- **Token-budget rounds.** Each serve-loop iteration plans a round
  (``engine/scheduler.py``): the decode round over the armed slots first,
  then prompt chunks under the round's token budget. A cold prompt that
  fits its grant is prefilled in one bucket (``_prefill`` + ``_insert``);
  a longer one, or the uncached suffix of a prefix hit, runs as
  page-aligned chunks over the pool (``models/llama.py``
  ``apply_prefill_paged``), the last of which samples the first token and
  arms the slot.
- **Multi-step decode rounds.** Each round runs up to ``steps_per_round``
  decode steps with device-side eos/length termination; tokens come back
  to the host once per round. On CUDA each layer of each step launches
  the hand-written paged-attention kernel.
- **Static state, captured programs.** The slot state, the pool, the
  round's token output and the admission's inputs are allocated once
  (``_init_device_state``) and only ever written in place. On CUDA the
  engine captures, at construction, one CUDA graph per decode-round rung
  ``(steps, greedy)``, per admission ``(bucket, greedy)``, per chunk
  extension ``(C, mode)`` and per final chunk ``(C, greedy, seed)``
  (``_prewarm``), where the reference compiled one program each and
  donated the state; the serve loop then runs only by replay. On the CPU,
  or with ``EngineConfig(cuda_graphs=False)``, the same bodies run
  eagerly.

- **Fused sampling tail.** By default each decode step streams the
  lm_head in vocab tiles and samples from a running candidate carry
  (``ops/fused_sampler.py``, the reference's default tail), over the
  armed slots only: a round of one stream gathers one row, a round of
  more all ``max_slots`` rows (the reference's active-row ladder {1, B});
  no (B, V) tensor exists. ``EngineConfig(fused_tail=False)`` keeps the
  materialized tail, (B, V) logits and a full sort, as the oracle.

- **Harvest worker.** The serve thread plans and dispatches; a harvest
  thread reads the tokens back, detokenizes, scans for stop words and
  finishes streams, so up to ``dispatch_depth`` decode rounds ride the
  device queue while the host works on the last one's tokens. Each
  round's tokens (and each admission's first tokens) are copied into a
  host buffer of a ring right after their program (``_HostRing``), since
  the next replay overwrites the static ``round_tokens``. The worker
  posts finish decisions back; the serve thread alone retires requests
  (slots, pages, prefix-cache refs, the device-side ``active`` flag).
  With ``dispatch_depth=1``, or when ``_step`` is driven without
  ``start()``, the serve thread reads each round back itself at the end
  of its ``_step``.

- **Observability.** Every request gets a flight-recorder timeline
  (``obs/flight.py``): its ID (adopted from the caller or minted; a
  duplicate in-flight ID gets a ``#N`` suffix), queue wait, slot, pages,
  prefix-hit tokens, first readback, one event per decode round, and its
  finish. Every planned round gets a record (``obs/rounds.py``): the serve
  thread opens it and seals its dispatch half, the harvest completes it
  when it reads the round back; its device time, estimated bytes moved,
  bandwidth share of the card's peak (``utils/hbm.py``) and drift from the
  step-cost model feed ``/debug/rounds`` and ``/metrics``. The recorders
  do O(1) host work per round and none per token, and read no device
  value.
- **Deadlines.** A request may carry an absolute deadline: past it in the
  backlog it is dropped before it takes a slot (finish
  ``deadline_queue``); past it between two prompt chunks, or at a
  harvested token, it stops (finish ``deadline``).

Waiting for later slices: speculative decoding, the KV tier, roles, the
watchdog, the online cost calibrator, and the tensor-parallel tails.
"""

from __future__ import annotations

import functools
import gc
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..models import llama
from ..models.configs import LlamaConfig
from ..obs import flight as obs_flight
from ..obs import rounds as obs_rounds
from ..obs.tracing import record_stage
from ..models.tokenizer import Tokenizer
from ..ops import int4_matmul
from ..ops.fused_sampler import choose_tile, fused_unembed_sample
from ..ops.kv_quant import quantize_rows
from ..ops.paged_attention import kernel_supported
from ..ops.quant import is_grouped, is_quantized
from ..ops.sampling import (MASK_BITS, NEG_INF, apply_repetition_penalty,
                            mask_words, pack_mask, pack_mask_np, sample,
                            seen_mask, set_token_bits, unpack_mask)
from ..utils.device import resolve_device
from ..utils.errors import ConfigError, EngineError, SchedulerFullError
from ..utils.hbm import peak_bw
from ..utils.logging import get_logger, log_event
from . import graphs
from .detokenizer import IncrementalDetokenizer, StopWordTrap
from .prefix_cache import PrefixCache, hash_blocks, usable_prefix_tokens
from .sampling_params import SamplingParams
from .scheduler import (PrefillJob, RoundPlan, StepCostModel,
                        TokenBudgetScheduler)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

logger = get_logger(__name__)

# Short per-engine tag stamped on round records: engines in one process
# share the process-wide round ring, and the tag tells their rounds apart
# in /debug/rounds.
_ENGINE_TAGS = itertools.count()

# The counters ``Engine.stats`` always carries, with their start values
# (each engine copies this template), named as the reference's stats.
_STATS_TEMPLATE = {
    "requests": 0, "tokens_generated": 0, "decode_steps": 0, "prefills": 0,
    # The harvest's milliseconds waiting for decode rounds' copies and the
    # rounds it read; the same for the first-token copies (one per serve
    # step that armed slots).
    "harvest_wait_ms": 0.0, "harvest_rounds": 0,
    "first_readback_ms": 0.0, "first_readbacks": 0,
    # The most decode rounds dispatched and not yet harvested.
    "dispatch_depth_peak": 0,
    # Submissions refused at a full queue (a 429 at the HTTP edge),
    # requests dropped in the backlog past their deadline, and requests
    # stopped past it between prompt chunks or mid-decode.
    "rejected_full": 0, "deadline_queue_drops": 0, "deadline_stops": 0,
    # The scheduler: the resolved per-round budget, prefill tokens granted,
    # decode token-equivalents charged against the budget, and rounds
    # that ran decode and prefill together.
    "sched_round_budget_tokens": 0, "sched_prefill_tokens": 0,
    "sched_decode_tokens": 0, "sched_interleaved_rounds": 0,
    # The fused tail's rows sampled and skipped (max_slots less the rung)
    # over decode steps; 0 under the materialized tail.
    "sampler_rows_sampled": 0, "sampler_rows_skipped": 0,
    # Rounds whose record completed (obs/rounds.py).
    "rounds_completed": 0,
    # Feature downgrades at construction: the port refuses a geometry its
    # kernels do not take (ConfigError) instead of serving it slower.
    "downgrades": 0,
    # Port-only: decode rounds dispatched, prefill programs run (one-shot
    # admissions and chunks) and of those the chunk programs, and the
    # harvest's milliseconds delivering tokens (detokenize, stop words).
    "decode_rounds": 0, "prefill_dispatches": 0, "prefill_chunks": 0,
    "harvest_emit_ms": 0.0,
}

# Keys ``Engine.stats`` adds when it is read (the prefix cache's keys only
# while the cache is on).
_STATS_READ_TIME = ("dispatch_queue_depth", "queue_waiting",
                    "sched_prefill_share", "sched_cost_drift_ratio",
                    "uptime_s", "active_slots", "free_pages", "pool_pages")


def engine_stat_keys() -> tuple[str, ...]:
    """Every key an ``Engine.stats`` snapshot can hold: the template, the
    read-time gauges and the prefix cache's counters (on by default).
    ``/metrics`` mirrors each as an ``engine_*`` gauge."""
    from .prefix_cache import CacheStats
    return (tuple(_STATS_TEMPLATE) + _STATS_READ_TIME
            + tuple(CacheStats().snapshot()) + ("prefix_cache_pages",))


def _drop_tracebacks(exc: Optional[BaseException]) -> None:
    """Clear the tracebacks of ``exc`` and of the errors it chains to, so
    their frames (and the tensors those hold) can be freed."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# The card's default sampler tile target: 2 tiles of 16000 for llama's
# 32000-token vocab. The tail's cost is launches, not bytes: on an H100
# the sampled 8-row tail takes 0.70 ms in 2 tiles against 1.62 in 8 of
# 4000 (PERF.md section 5, the sampling tail).
CARD_TILE = 16384


@dataclass(frozen=True)
class EngineConfig:
    """Engine sizing (the reference's fields this slice serves)."""
    max_slots: int = 8                # concurrent decode requests
    max_input_length: int = 3000
    max_output_length: int = 512
    prefill_buckets: tuple[int, ...] = (128, 512, 1024, 2048, 3072)
    dtype: str = "bfloat16"
    seed: int = 0
    max_queue: int = 256
    # Paged KV pool: "auto" fits the pool to free device memory (full
    # capacity on the CPU); None = full capacity (max_slots x max cache
    # extent); an int = pool size in tokens.
    page_size: int = 128
    kv_pool_tokens: Union[int, str, None] = "auto"
    # Decode steps per round: one host transfer per round.
    steps_per_round: int = 8
    # Caps the largest prefill bucket; longer prompts stream through the
    # pool in chunks. None = one-shot buckets up to max_input_length.
    max_prefill_bucket: Optional[int] = None
    # KV-cache quantization: "" (pool in `dtype`) or "int8" (per-row
    # symmetric int8 pools + bf16 scale pools, ops/kv_quant.py): about
    # half the bytes per cached token, so "auto" fits ~2x the pages.
    kv_quant: str = ""
    # Shared-prefix KV reuse (engine/prefix_cache.py).
    prefix_cache: bool = True
    # Token-budget scheduler (engine/scheduler.py): per-round prefill-token
    # budget and per-request chunk cap. None = derive the budget from the
    # engine's step-cost model (measured on the card at construction, the
    # class defaults elsewhere) and let the chunk cap follow it.
    sched_round_budget_tokens: Optional[int] = None
    sched_prefill_chunk_tokens: Optional[int] = None
    # On CUDA, capture every decode round and admission as a CUDA graph at
    # construction and replay them; False runs them eagerly (the oracle
    # the card checks hold the graphs against). No effect on the CPU.
    cuda_graphs: bool = True
    # Decode rounds dispatched before the serve thread waits for their
    # tokens: with 2 (the reference's default) a harvest thread reads each
    # round back while the next one runs; 1 reads each round back on the
    # serve thread, in line.
    dispatch_depth: int = 2
    # The decode round's sampling tail (the reference's ENGINE_FUSED_SAMPLER,
    # SAMPLER_TILE and SAMPLER_CAND_K): True streams the lm_head in vocab
    # tiles of ``sampler_tile`` tokens and samples from a running
    # top-``sampler_cand_k`` candidate carry, over the armed slots only;
    # False builds (B, V) logits and sorts them (the oracle). None: the
    # largest 32-aligned divisor of the vocab up to 4096 on the CPU (the
    # reference's; 4000 for 32000), up to ``CARD_TILE`` on the card.
    fused_tail: bool = True
    sampler_tile: Optional[int] = None
    sampler_cand_k: int = 64

    def __post_init__(self) -> None:
        if self.page_size <= 0:
            raise ConfigError(f"page_size={self.page_size} must be > 0")
        if self.dtype not in _DTYPES:
            raise ConfigError(f"dtype={self.dtype!r} not supported; use one "
                              f"of {sorted(_DTYPES)}")
        if self.kv_quant not in ("", "int8"):
            raise ConfigError(f"kv_quant={self.kv_quant!r} not supported; "
                              f"use '' or 'int8'")
        if (self.max_slots < 1 or self.steps_per_round < 1
                or self.dispatch_depth < 1):
            raise ConfigError("max_slots, steps_per_round and "
                              "dispatch_depth must be >= 1")
        if self.sampler_cand_k < 1 or (self.sampler_tile is not None
                                       and self.sampler_tile < 1):
            raise ConfigError("sampler_cand_k and sampler_tile must be >= 1")
        if not (self.kv_pool_tokens is None or self.kv_pool_tokens == "auto"
                or isinstance(self.kv_pool_tokens, int)):
            raise ConfigError(f"kv_pool_tokens={self.kv_pool_tokens!r}: use "
                              f"'auto', None or a token count")
        if self.max_prefill_bucket is not None and (
                self.max_prefill_bucket < self.page_size
                or self.max_prefill_bucket % self.page_size):
            raise ConfigError(
                f"max_prefill_bucket={self.max_prefill_bucket} must be a "
                f"multiple of page_size={self.page_size} (>= one page)")

    @property
    def max_cache_len(self) -> int:
        return self.max_input_length + self.max_output_length


class TokenStream:
    """Thread-safe stream of text chunks for one request.

    ``request_id`` is the request's end-to-end identity and the key of its
    flight-recorder timeline (``timeline``), which the stream's terminal
    transition completes through ``_flight`` unless the timeline was
    adopted from a serving edge (``owns_timeline`` False: the edge
    completes it)."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.timeline: Optional[obs_flight.Timeline] = None
        self.owns_timeline = True
        self._flight: Optional[obs_flight.FlightRecorder] = None
        self._q: "queue.Queue[tuple[str, object]]" = queue.Queue()
        self._error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        self.token_ids: list[int] = []
        # Host-clock time each token was read back from the device (a
        # round's tokens share one).
        self.token_times: list[float] = []
        self.submit_time = time.monotonic()
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.cancelled = False

    def _put_chunk(self, text: str) -> None:
        if text:
            self._q.put(("chunk", text))

    def _record_done(self) -> None:
        """Complete the timeline at the first terminal transition (every
        finish path goes through ``_finish`` or ``_fail``); idempotent."""
        if self._flight is not None:
            self._flight.complete_stream(self)

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.finish_time = time.monotonic()
        # Into the timeline before the terminal event goes out: a consumer
        # woken by it may read /debug/requests at once.
        self._record_done()
        self._q.put(("done", reason))

    def _fail(self, exc: BaseException) -> None:
        self._error = exc   # sticky: re-iteration re-raises, never hangs
        self.finish_reason = "error"
        self._record_done()
        self._q.put(("error", exc))

    def cancel(self) -> None:
        """Abort generation (e.g. the HTTP client disconnected). The serve
        thread retires the request at its next harvested token."""
        self.cancelled = True

    def __iter__(self) -> Iterator[str]:
        """Yield chunks until the terminal event. The terminal state is
        sticky: iterating a finished stream again returns (or re-raises)
        at once instead of blocking on the drained queue."""
        while True:
            try:
                if self.finish_reason is not None and self._q.empty():
                    raise queue.Empty
                kind, payload = self._q.get(timeout=0.25)
            except queue.Empty:
                if self.finish_reason is None:
                    continue
                while True:
                    try:
                        kind, payload = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if kind == "chunk":
                        yield payload  # type: ignore[misc]
                    elif kind == "error":
                        raise EngineError(
                            "engine failure") from payload  # type: ignore[arg-type]
                    else:
                        return
                if self._error is not None:
                    raise EngineError("engine failure") from self._error
                return
            if kind == "chunk":
                yield payload  # type: ignore[misc]
            elif kind == "error":
                raise EngineError("engine failure") from payload  # type: ignore[arg-type]
            else:
                return

    def text(self) -> str:
        """Block until completion, return the full generation."""
        return "".join(self)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return (self.first_token_time - self.submit_time) * 1e3


@dataclass
class _Request:
    stream: TokenStream
    prompt_ids: list[int]
    params: SamplingParams
    detok: IncrementalDetokenizer
    stop: StopWordTrap
    eff_max: int = 0          # max_tokens clamped to the cache extent
    extent: int = 0           # prompt + eff_max (cache positions reserved)
    slot: int = -1
    pages: list[int] = field(default_factory=list)
    proj_pos: int = 0         # host upper bound on the device-side pos
    generated: int = 0
    greedy: bool = False      # top_k == 1 or temperature <= 0: argmax
    banned_np: Optional[np.ndarray] = None    # packed (Wn,) words
    bad_seq_np: Optional[np.ndarray] = None   # (MAX_BAD_SEQS, MAX_BAD_LEN)
    bad_len_np: Optional[np.ndarray] = None   # (MAX_BAD_SEQS,)
    seq: int = 0              # arrival order
    prefill_done: bool = False   # armed: the slot decodes
    pf_pos: int = 0           # prompt tokens prefilled (or mapped) so far
    pf: Optional[dict] = None    # admission context while prefilling
    cache_refs: list = field(default_factory=list)   # prefix-cache refs held
    cache_pages: set = field(default_factory=set)    # pages the cache owns
    block_hashes: Optional[list] = None   # memoized across admission retries
    # Absolute time.monotonic deadline: past it in the backlog the request
    # is dropped ("deadline_queue"); past it between chunks or at a
    # harvested token it stops ("deadline").
    deadline_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.stream.finish_reason is not None


class _HostRing:
    """Host buffers for the device->host copies the harvest reads: each a
    (steps_per_round, B) int32 buffer (pinned on CUDA, so the copy is
    asynchronous) with a CUDA event recorded after its copy. The serve
    thread copies into the next buffer in turn (``copy``), waiting while
    the harvest still holds it, so a copy never lands in a buffer whose
    tokens are unread; ``read`` waits for the copy, returns the values
    and hands the buffer back."""

    def __init__(self, n: int, shape: tuple[int, int], device: torch.device):
        cuda = device.type == "cuda"
        self.bufs = [torch.zeros(shape, dtype=torch.int32, pin_memory=cuda)
                     for _ in range(n)]
        self.events = [torch.cuda.Event() if cuda else None
                       for _ in range(n)]
        self._busy = [False] * n
        self._next = 0
        self._cond = threading.Condition()

    def __len__(self) -> int:
        return len(self.bufs)

    def copy(self, src: torch.Tensor, alive) -> int:
        """Start copying ``src`` (at most (steps_per_round, B)) into the
        next free buffer, after the work already queued on the current
        stream; returns the buffer's index. ``alive()`` is called while
        waiting and raises to abandon the wait."""
        i = self._next
        with self._cond:
            while self._busy[i]:
                alive()
                self._cond.wait(timeout=0.05)
            self._busy[i] = True
        self._next = (i + 1) % len(self.bufs)
        rows = src.reshape(-1, src.shape[-1])
        self.bufs[i][:rows.shape[0]].copy_(rows, non_blocking=True)
        if self.events[i] is not None:
            self.events[i].record()
        return i

    def read(self, i: int, rows: int) -> list[list[int]]:
        """Wait for buffer ``i``'s copy; its first ``rows`` rows as lists,
        and the buffer handed back."""
        if self.events[i] is not None:
            self.events[i].synchronize()
        out = self.bufs[i][:rows].tolist()
        with self._cond:
            self._busy[i] = False
            self._cond.notify_all()
        return out

    def reset(self) -> None:
        """Every buffer free (nothing is in flight)."""
        with self._cond:
            self._busy = [False] * len(self.bufs)
            self._cond.notify_all()


class Engine:
    """Continuous-batching engine over one model on one device."""

    # Device-side multi-token bad-words table: up to MAX_BAD_SEQS
    # sequences per request, each up to MAX_BAD_LEN tokens.
    MAX_BAD_SEQS = 8
    MAX_BAD_LEN = 8

    def __init__(self, params: llama.Params, model_cfg: LlamaConfig,
                 tokenizer: Tokenizer, cfg: EngineConfig = EngineConfig(),
                 device: Union[str, torch.device] = "cuda"):
        llama.check_supported(model_cfg)
        self.device = resolve_device(device)
        self._dtype = _DTYPES[cfg.dtype]
        embed = params["embed"]
        if embed.device.type != self.device.type or embed.dtype != self._dtype:
            raise ConfigError(
                f"params are {embed.dtype} on {embed.device}; the engine "
                f"runs {self._dtype} on {self.device}")
        self.params = params
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.tokenizer = tokenizer
        page = cfg.page_size
        self._pmax = _ceil_div(cfg.max_cache_len, page)
        page_up = lambda n: _ceil_div(n, page) * page  # noqa: E731
        # max_prefill_bucket caps the one-shot bucket; longer prompts are
        # admitted in chunks.
        cap = min(cfg.max_prefill_bucket or cfg.max_input_length,
                  cfg.max_input_length)
        self._buckets = tuple(sorted(
            {page_up(min(b, cap)) for b in cfg.prefill_buckets}
            | {page_up(cap)}))
        # A chunk's padded span starts on a prompt page and runs at most
        # one largest bucket: the staged page row covers it (pages past
        # the extent map to the trash page 0). The prefix a chunk attends
        # lies before its start, inside the prompt's pages.
        self._row_pages = self._pmax + self._buckets[-1] // page
        self._prefix_pages = _ceil_div(cfg.max_input_length, page)
        if self.device.type == "cuda":
            self._check_kernel_geometry()
        V, B = model_cfg.vocab_size, cfg.max_slots
        self._sampler_tile = choose_tile(V, cfg.sampler_tile or (
            CARD_TILE if self.device.type == "cuda" else None))
        if (cfg.sampler_tile is not None and V % MASK_BITS == 0
                and self._sampler_tile == V):
            raise ConfigError(
                f"sampler_tile={cfg.sampler_tile} streams the {V}-token "
                f"vocab as one tile: the materialized tail is "
                f"fused_tail=False")
        # The fused tail's active-row ladder (the reference's two rungs):
        # a round samples 1 row for one stream, else all B.
        self._ba_ladder = (1, B) if cfg.fused_tail and B > 1 else (B,)

        self._pool_reserve: Optional[int] = None   # "auto" sizing's reserve
        # The side stream the programs are captured on, kept across a
        # rebuild: cuBLAS's workspace and the kernels' scratch are keyed
        # by stream, and a new stream would hold a second set.
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self._n_pages = 1 + self._resolve_pool_pages()
        self._build_device()

        self._slots: dict[int, _Request] = {}
        self._free_slots = list(range(cfg.max_slots))
        self._pending: "queue.Queue[_Request]" = queue.Queue(
            maxsize=cfg.max_queue)
        self._backlog: list[_Request] = []
        self._arrival_seq = itertools.count()
        # The recorders (the process-wide ones unless a private one is
        # installed through ``flight`` / ``rounds``) and the inputs of a
        # round's byte estimate: the weights' bytes as stored (packed int4
        # at its packed size), streamed once per decode step and per
        # prefill program, and the card's peak rate (0 on the CPU).
        self._flight_override: Optional[obs_flight.FlightRecorder] = None
        self._rounds_override: Optional[obs_rounds.RoundRecorder] = None
        self._engine_tag = f"e{next(_ENGINE_TAGS)}"
        self._param_bytes = sum(t.numel() * t.element_size()
                                for t in llama.param_tensors(params))
        self._hbm_peak = peak_bw(self.device)
        # EWMA of round wall over the step-cost model's prediction, updated
        # per completed round (``sched_cost_drift_ratio``).
        self._drift_ratio: Optional[float] = None
        self._created_monotonic = time.monotonic()
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        # The harvest pipeline: each dispatched program's output goes
        # onto ``_harvest_q`` in dispatch order (or ``_inline`` when no
        # worker runs); the worker reads it and posts finished requests
        # on ``_completed`` for the serve thread to retire.
        self._ring = _HostRing(2 * (cfg.dispatch_depth + 1),
                               (cfg.steps_per_round, cfg.max_slots),
                               self.device)
        self._harvest_q: "queue.Queue[tuple]" = queue.Queue()
        self._inline: list[tuple] = []
        self._marks: list = []     # round records awaiting a later read
        self._completed: "queue.Queue[_Request]" = queue.Queue()
        self._harvest_thread: Optional[threading.Thread] = None
        self._harvest_stop = threading.Event()
        self._depth = 1          # the running pipeline's dispatch depth
        self._inflight_rounds = 0
        # Prompt chunks were dispatched since the last decode round (at
        # most one step of them between two rounds).
        self._chunk_behind = False
        self._pipe_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats: dict[str, float] = dict(_STATS_TEMPLATE)
        self._stats["sched_round_budget_tokens"] = \
            self._sched.round_budget_tokens

    def _build_device(self) -> None:
        """Allocate the pool of ``_n_pages`` pages and the static state,
        capture every program on the card (``_prewarm``) and build the
        scheduler over the step-cost model that gives: the construction
        path, which ``prewarm`` reruns at a smaller pool."""
        cfg = self.cfg
        self._free_pages = list(range(1, self._n_pages))
        self._prefix_cache = (PrefixCache(cfg.page_size) if cfg.prefix_cache
                              else None)
        self._state = self._init_device_state()
        (self._admit_arrays, self._admit_host,
         self._admit_in) = self._admission_views()
        self._step_counter = itertools.count()
        self._round_gen = torch.Generator(device=self.device)
        self._admit_gen = torch.Generator(device=self.device)
        self._round_graphs: dict[tuple[int, bool, int],
                                 graphs.Program] = {}
        self._admit_graphs: dict[tuple[int, bool], graphs.Program] = {}
        self._extend_graphs: dict[tuple[int, str], graphs.Program] = {}
        self._final_graphs: dict[tuple[int, bool, bool],
                                 graphs.Program] = {}
        self.graph_pool_bytes = 0
        cost = StepCostModel(slots=cfg.max_slots)
        if self._graphs_on:
            cost = self._prewarm()
        self._round_gen.manual_seed(cfg.seed)
        self._sched = TokenBudgetScheduler(
            cost, page_size=cfg.page_size,
            steps_per_round=cfg.steps_per_round,
            round_budget_tokens=cfg.sched_round_budget_tokens,
            chunk_tokens=cfg.sched_prefill_chunk_tokens,
            max_one_shot_tokens=self._buckets[-1])

    def _check_kernel_geometry(self) -> None:
        """On the card every decode layer launches the paged kernel and
        every int4 projection the int4 kernel: refuse, before any pool is
        allocated, a geometry either kernel does not take, and GPTQ zero
        points (``gbias``), which the int4 kernel does not apply."""
        m, page = self.model_cfg, self.cfg.page_size
        if not kernel_supported(page, m.num_heads, m.num_kv_heads,
                                m.head_dim):
            raise ConfigError(
                f"the paged decode kernel does not take heads "
                f"{m.num_heads}/{m.num_kv_heads}, head_dim {m.head_dim}, "
                f"page {page}")
        leaves = dict(self.params["layers"])
        if "lm_head" in self.params:
            leaves["lm_head"] = self.params["lm_head"]
        for name, w in leaves.items():
            if not (is_quantized(w) and "q4" in w):
                continue
            if "gbias" in w:
                raise ConfigError(
                    f"{name}: int4 weights with GPTQ zero points (gbias) "
                    f"are not served by the int4 kernel")
            K, N = 2 * w["q4"].shape[-2], w["q4"].shape[-1]
            group = K // w["gscale"].shape[-2] if is_grouped(w) else 0
            if not int4_matmul.supported(K, N, group):
                raise ConfigError(f"{name}: the int4 kernel does not take "
                                  f"K={K}, N={N}, group {group}")

    # -------------------------------------------------------------- sizing

    def _kv_bytes_per_token(self, pooled: bool = True) -> int:
        """KV bytes per cached token. ``pooled``: bytes in the page pool
        (int8 rows plus one bf16 scale each under kv_quant); False: the
        dense bytes of a prefill bucket's KV, which stays in the compute
        dtype until the insert quantizes it (sizing the prefill reserve
        with pooled bytes would under-reserve by ~2x under kv_quant)."""
        m = self.model_cfg
        if pooled and self.cfg.kv_quant:
            return m.num_layers * m.num_kv_heads * 2 * (m.head_dim + 2)
        return (2 * m.num_layers * m.num_kv_heads * m.head_dim
                * torch.finfo(self._dtype).bits // 8)

    def _resolve_pool_pages(self) -> int:
        cfg = self.cfg
        full = cfg.max_slots * self._pmax
        spec = cfg.kv_pool_tokens
        if spec is None:
            return full
        if isinstance(spec, int):
            return min(full, max(self._pmax, _ceil_div(spec, cfg.page_size)))
        if self.device.type != "cuda":
            return full
        # "auto": 90% of the free device memory left after a reserve for
        # the largest bucket's prefill transients (its dense KV, logits
        # and activations; a chunk's float32 score tiles over one
        # streamed block of the prefix). On the card those live in the
        # captured programs' memory pool; ``_prewarm`` checks that it
        # fits. Cached blocks nothing uses (say, weights a quantization
        # replaced) are handed back first, so they count as free.
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(self.device)
        m, S = self.model_cfg, self._buckets[-1]
        block = llama.PREFIX_BLOCK_PAGES * cfg.page_size
        reserve = (2 * S * self._kv_bytes_per_token(pooled=False)
                   + 4 * m.hidden_size * m.vocab_size
                   + 64 * S * m.hidden_size
                   + 16 * m.num_heads * S * block + (512 << 20))
        self._pool_reserve = reserve
        pages = int(0.9 * (free - reserve)) // (
            cfg.page_size * self._kv_bytes_per_token())
        return min(full, max(self._pmax, pages))

    # Slot-state fields that do not start at 0, and the value they start at.
    _STATE_FILL = {"rep_pen": 1, "bad_seq": -1, "recent": -1}

    def _init_device_state(self) -> dict:
        """Device-side slot state, the page pool, the decode round's token
        output ``round_tokens`` (steps_per_round, B), the armed slots a
        fused-tail round samples (``act_idx``: sorted, padded with B) and
        the admission and
        chunk programs' packed inputs (``admit``: int32 ``i32``, float32
        ``f32``, banned words, and the seen words of a cached prefix
        ``seen0``; laid out by ``_admission_views``). Allocated once:
        every later write is in place, so a captured program's addresses
        stay valid."""
        B, dev = self.cfg.max_slots, self.device
        Wn = mask_words(self.model_cfg.vocab_size)

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        st = {
            "cache": llama.init_paged_kv_cache(
                self.model_cfg, self._n_pages, self.cfg.page_size,
                self._dtype, device=dev,
                quantized=self.cfg.kv_quant == "int8"),
            "table": z(B, self._pmax),
            "pos": z(B), "last_token": z(B), "remaining": z(B),
            "active": z(B, dtype=torch.bool),
            "eos_ok": z(B, dtype=torch.bool),
            "temp": z(B, dtype=torch.float32),
            "top_k": z(B),
            "top_p": z(B, dtype=torch.float32),
            "rep_pen": z(B, dtype=torch.float32),
            "seen": z(B, Wn, dtype=torch.int64),
            "banned": z(B, Wn, dtype=torch.int64),
            "bad_seq": z(B, self.MAX_BAD_SEQS, self.MAX_BAD_LEN),
            "bad_len": z(B, self.MAX_BAD_SEQS),
            "recent": z(B, self.MAX_BAD_LEN - 1),
            "round_tokens": z(self.cfg.steps_per_round, B),
            "act_idx": z(B),
            "admit": {"i32": z(sum(n for _, n in
                                   self._admit_i32_spans().values())),
                      "f32": z(len(self._ADMIT_F32), dtype=torch.float32),
                      "banned": z(Wn, dtype=torch.int64),
                      "seen0": z(Wn, dtype=torch.int64)},
        }
        for name, value in self._STATE_FILL.items():
            st[name].fill_(value)
        return st

    def _reset_state(self) -> None:
        """Every state tensor back to its initial value, in place."""
        for tensors in (self._state, self._state["cache"],
                        self._state["admit"]):
            for name, t in tensors.items():
                if isinstance(t, torch.Tensor):
                    t.fill_(self._STATE_FILL.get(name, 0))

    # The admission's float32 inputs, in their order in state["admit"]["f32"].
    _ADMIT_F32 = ("temp", "top_p", "rep_pen")

    def _admit_i32_spans(self) -> dict[str, tuple[int, int]]:
        """(offset, length) of each admission input packed into
        state["admit"]["i32"]: the largest bucket's token ids, the page
        row (wide enough for a chunk's padded span), the sequence-ban
        table and lengths, then the scalars. ``start`` is a chunk's first
        prompt position (0 for a one-shot admission) and ``length`` the
        prompt tokens valid after it (the chunk's ``kv_valid_len``)."""
        sizes = {"tokens": self._buckets[-1], "row": self._row_pages,
                 "bad_seq": self.MAX_BAD_SEQS * self.MAX_BAD_LEN,
                 "bad_len": self.MAX_BAD_SEQS, "length": 1, "start": 1,
                 "slot": 1, "top_k": 1, "remaining": 1, "eos_ok": 1}
        spans, at = {}, 0
        for name, n in sizes.items():
            spans[name] = (at, n)
            at += n
        return spans

    def _admission_views(self):
        """Named views of the admission inputs: (the host staging arrays,
        one int32, one float32 and one int64 as state["admit"] has them;
        named numpy views of those; named device views of
        state["admit"]). ``_stage_admission`` fills the host side and
        copies each array over whole, four copies per admission or chunk;
        the programs read only the device views."""
        a = self._state["admit"]
        host = {"i32": np.zeros(a["i32"].shape, np.int32),
                "f32": np.zeros(a["f32"].shape, np.float32),
                "banned": np.zeros(a["banned"].shape, np.int64),
                "seen0": np.zeros(a["seen0"].shape, np.int64)}
        hv = {"banned": host["banned"], "seen0": host["seen0"]}
        dv = {"banned": a["banned"], "seen0": a["seen0"]}
        for name, (off, n) in self._admit_i32_spans().items():
            hv[name] = host["i32"][off:off + n]
            dv[name] = a["i32"][off:off + n]
        shape = (self.MAX_BAD_SEQS, self.MAX_BAD_LEN)
        hv["bad_seq"] = hv["bad_seq"].reshape(shape)
        dv["bad_seq"] = dv["bad_seq"].view(shape)
        for i, name in enumerate(self._ADMIT_F32):
            hv[name] = host["f32"][i:i + 1]
            dv[name] = a["f32"][i:i + 1]
        return host, hv, dv

    @property
    def flight(self) -> obs_flight.FlightRecorder:
        """The flight recorder in use: the process-wide one unless a
        private one was installed. Resolved per access, so the engine and
        the HTTP server always agree on it."""
        return self._flight_override or obs_flight.RECORDER

    @flight.setter
    def flight(self, recorder: obs_flight.FlightRecorder) -> None:
        self._flight_override = recorder

    @property
    def rounds(self) -> obs_rounds.RoundRecorder:
        """The round recorder in use, resolved as ``flight``."""
        return self._rounds_override or obs_rounds.RECORDER

    @rounds.setter
    def rounds(self, recorder: obs_rounds.RoundRecorder) -> None:
        self._rounds_override = recorder

    @property
    def engine_tag(self) -> str:
        """This engine's tag on its round records: the ``?engine=`` filter
        of ``/debug/rounds``."""
        return self._engine_tag

    @property
    def stats(self) -> dict[str, float]:
        """Counters and gauges (``engine_stat_keys``).
        ``dispatch_queue_depth`` is the decode rounds dispatched and not
        yet harvested; ``free_pages`` counts the pages an admission can
        take now: the free list plus cached pages no live request maps
        (eviction reclaims them on demand)."""
        with self._stats_lock:
            out = dict(self._stats)
        out["dispatch_queue_depth"] = self._inflight_rounds
        out["queue_waiting"] = len(self._backlog) + self._pending.qsize()
        sched_total = out["sched_prefill_tokens"] + out["sched_decode_tokens"]
        out["sched_prefill_share"] = (
            round(out["sched_prefill_tokens"] / sched_total, 4)
            if sched_total else 0.0)
        drift = self._drift_ratio
        out["sched_cost_drift_ratio"] = (round(drift, 4)
                                         if drift is not None else 0.0)
        out["uptime_s"] = round(time.monotonic() - self._created_monotonic,
                                3)
        out["active_slots"] = len(self._slots)
        cache = self._prefix_cache
        out["free_pages"] = len(self._free_pages) + (
            cache.idle_pages if cache is not None else 0)
        out["pool_pages"] = self._n_pages - 1
        if cache is not None:
            out.update(cache.stats.snapshot())
            out["prefix_cache_pages"] = cache.cached_pages
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    # ------------------------------------------------------ device functions

    @torch.no_grad()
    def _prefill(self, bucket: int, greedy: bool):
        """Prefill of the staged prompt (``_admit_in``) padded to
        ``bucket``. Returns the bucket's dense K/V (L, 1, S, KV, hd), the
        first token ((1,) int32) and the prompt's seen mask with the first
        token set, as packed (Wn,) words. Every per-request value is read
        from the static inputs on the device (the last prompt row by an
        ``index_select`` of ``length``), so one captured program serves
        every request of the bucket."""
        mcfg, dev, a = self.model_cfg, self.device, self._admit_in
        tokens = a["tokens"][:bucket][None, :]
        length = a["length"]
        positions = torch.arange(bucket, dtype=torch.int32, device=dev)[None, :]
        cache = llama.init_kv_cache(mcfg, 1, bucket, self._dtype, device=dev)
        hn, cache = llama.apply(self.params, mcfg, tokens, positions, cache,
                                kv_valid_len=length, return_hidden=True)
        # Only the last prompt row is projected (the reference projects
        # every row and takes this one).
        last = llama.project_logits(
            self.params, hn.index_select(1, (length - 1).long())[:, 0])
        V = mcfg.vocab_size
        seen = seen_mask(tokens, length, V)                           # (1, V)
        last = apply_repetition_penalty(last, seen, a["rep_pen"])
        last = torch.where(unpack_mask(a["banned"], V)[None, :],
                           torch.full_like(last, NEG_INF), last)
        if greedy:
            first = last.float().argmax(dim=-1).to(torch.int32)
        else:
            first = sample(last, a["temp"], a["top_k"], a["top_p"],
                           self._admit_gen)
        seen = seen[0].index_fill(0, first.long(), True)
        return cache["k"], cache["v"], first, pack_mask(seen)

    @torch.no_grad()
    def _insert(self, k_new: torch.Tensor, v_new: torch.Tensor,
                first: torch.Tensor, seen: torch.Tensor) -> None:
        """Scatter a prefilled bucket into the staged page row and arm the
        staged slot, both read from ``_admit_in`` on the device. Page-table
        entries past the allocated extent are 0, so the bucket's overhang
        lands in the trash page. Under an int8 pool the bucket is
        quantized per row with ``quantize_rows``, one layer at a time (a
        small float32 transient), so inserted rows are bit-identical to
        rows the decode kernel appends. The pool and the slot state are
        updated in place (the reference returned a new state from a
        donated jit)."""
        mcfg, a = self.model_cfg, self._admit_in
        page, L = self.cfg.page_size, mcfg.num_layers
        nb = k_new.shape[2] // page
        dest = a["row"][:nb].long()
        # (L, 1, S, KV, hd) -> (L, nb, KV, page, hd): KV heads ahead of the
        # page dim, the pool's layout.
        cache = self._state["cache"]
        for name, new in (("k", k_new), ("v", v_new)):
            blocks = new.reshape(L, nb, page, mcfg.num_kv_heads,
                                 mcfg.head_dim).transpose(2, 3)
            if not llama.kv_cache_quantized(cache):
                cache[name][:, dest] = blocks.to(cache[name].dtype)
                continue
            for i in range(L):
                rows, scales = quantize_rows(blocks[i])
                cache[name][i, dest] = rows
                cache[name + "s"][i, dest] = scales
        self._arm(first, seen)

    def _arm(self, first: torch.Tensor, seen: torch.Tensor) -> None:
        """Arm the staged slot for decoding, in place: its page row, its
        position (the prompt length), its first token ((1,) int32), its
        sampling inputs and its seen mask (packed (Wn,) words with the
        first token set)."""
        st, a = self._state, self._admit_in
        eos = int(self.tokenizer.eos_id)
        eos_ok = a["eos_ok"].bool()
        # A slot whose first token already ends it (eos, or max_tokens
        # == 1) never activates.
        active = (a["remaining"] > 0) & ~((first == eos) & eos_ok)
        # Sequence bans match generated tokens only: a fresh ring seeded
        # with the first sampled token.
        recent = torch.cat([torch.full((1, self.MAX_BAD_LEN - 2), -1,
                                       dtype=torch.int32, device=first.device),
                            first[:, None]], dim=1)
        slot = a["slot"].long()
        for name, value in (
                ("table", a["row"][None, :self._pmax]), ("pos", a["length"]),
                ("last_token", first), ("active", active),
                ("remaining", a["remaining"]), ("eos_ok", eos_ok),
                ("temp", a["temp"]), ("top_k", a["top_k"]),
                ("top_p", a["top_p"]), ("rep_pen", a["rep_pen"]),
                ("seen", seen[None]), ("banned", a["banned"][None]),
                ("bad_seq", a["bad_seq"][None]),
                ("bad_len", a["bad_len"][None]), ("recent", recent)):
            st[name].index_copy_(0, slot, value)

    def _admit_body(self, bucket: int, greedy: bool) -> None:
        """One admission: prefill, first token, insert (the reference's
        ``prefill_insert``, one program on the TTFT path)."""
        self._insert(*self._prefill(bucket, greedy))

    # The chunk programs' seen handling (the reference's ``_chunk_seen``):
    # "replace" is the first chunk of a cold prompt (the slot's mask is
    # the previous occupant's), "accum" ORs into the slot's mask, "seed"
    # is the first chunk of a prefix hit (OR into the staged ``seen0``,
    # the cached tokens' mask built on the host).
    CHUNK_MODES = ("replace", "accum", "seed")

    def _chunk_seen(self, C: int, mode: str) -> torch.Tensor:
        """The staged slot's seen mask after the staged chunk, as packed
        (Wn,) words."""
        a = self._admit_in
        in_chunk = (a["length"] - a["start"]).clamp(0, C)
        words = pack_mask(seen_mask(a["tokens"][:C][None], in_chunk,
                                    self.model_cfg.vocab_size)[0])
        if mode == "accum":
            words = self._state["seen"].index_select(
                0, a["slot"].long())[0] | words
        elif mode == "seed":
            words = a["seen0"] | words
        return words

    def _chunk_prefill(self, C: int, prefix: bool) -> torch.Tensor:
        """The staged chunk (``C`` tokens from ``start``, ``length`` valid)
        through ``apply_prefill_paged`` into the staged page row; returns
        its hidden states (1, C, D). ``prefix`` False: the chunk starts at
        position 0 and attends no pool rows."""
        a = self._admit_in
        positions = (a["start"] + torch.arange(
            C, dtype=torch.int32, device=self.device))[None, :]
        h, _ = llama.apply_prefill_paged(
            self.params, self.model_cfg, a["tokens"][:C][None], positions,
            self._state["cache"], a["row"][None], a["length"],
            a["start"] // self.cfg.page_size,
            prefix_pages=self._prefix_pages if prefix else 0)
        return h

    @torch.no_grad()
    def _chunk_extend_body(self, C: int, mode: str) -> None:
        """A chunk that is not the prompt's last (the reference's
        ``_chunk_extend_fn``): its K/V into the slot's pages and its
        tokens into the slot's seen mask; no vocab projection."""
        self._chunk_prefill(C, prefix=mode != "replace")
        self._state["seen"].index_copy_(
            0, self._admit_in["slot"].long(), self._chunk_seen(C, mode)[None])

    @torch.no_grad()
    def _chunk_final_body(self, C: int, greedy: bool, seed: bool) -> None:
        """The prompt's last chunk (the reference's ``_chunk_final_fn``):
        paged prefill, the first token from the last prompt row only, and
        the slot armed as ``_insert`` arms it. ``seed``: also the first
        chunk of a prefix hit."""
        a, mcfg = self._admit_in, self.model_cfg
        h = self._chunk_prefill(C, prefix=True)
        seen = self._chunk_seen(C, "seed" if seed else "accum")
        idx = (a["length"] - a["start"] - 1).clamp(0, C - 1)
        last = llama.unembed(self.params, mcfg,
                             h.index_select(1, idx.long()))[:, 0]  # (1, V)
        V = mcfg.vocab_size
        last = apply_repetition_penalty(last, unpack_mask(seen, V)[None],
                                        a["rep_pen"])
        last = torch.where(unpack_mask(a["banned"], V)[None, :],
                           torch.full_like(last, NEG_INF), last)
        if greedy:
            first = last.float().argmax(dim=-1).to(torch.int32)
        else:
            first = sample(last, a["temp"], a["top_k"], a["top_p"],
                           self._admit_gen)
        seen = set_token_bits(seen[None], first,
                              torch.ones_like(first, dtype=torch.bool))[0]
        self._arm(first, seen)

    @staticmethod
    def _bad_seq_hits(seq: torch.Tensor, blen: torch.Tensor,
                      recent: torch.Tensor):
        """Multi-token bad words: a sequence of length l is banned by
        masking its last token whenever the l-1 most recent generated
        tokens equal its prefix. Returns (hit (R, W) bool, tail (R, W))."""
        R, Wb, Lb = seq.shape
        slen = recent.shape[1]
        j = torch.arange(Lb, dtype=torch.int32, device=seq.device)
        gi = (Lb - blen[..., None] + j).clamp(0, slen - 1).long()
        hist = torch.gather(recent[:, None, :].expand(R, Wb, slen), 2, gi)
        need = j[None, None, :] < (blen[..., None] - 1)
        hit = ((hist == seq) | ~need).all(-1) & (blen >= 2)
        tail = torch.gather(seq, 2, (blen - 1).clamp(min=0)[..., None].long()
                            )[..., 0]
        return hit, tail

    def _fused_tail(self, h: torch.Tensor, greedy: bool,
                    ba: int) -> torch.Tensor:
        """The fused sampling tail of one decode step (the reference's
        ``make_round`` fused branch): the final norm of the hidden rows
        ``h`` (B, D), the ``ba`` rows ``act_idx`` names gathered (pad
        index B reads row B - 1 and is dropped), their sequence bans, the
        vocab-tiled unembed + sample over them (``ops/fused_sampler.py``;
        a running argmax when ``greedy``), and the tokens scattered back.
        Returns (B,) int32: rows outside ``act_idx`` get 0, and every
        state update masks them on ``active``."""
        st, mcfg, B = self._state, self.model_cfg, self.cfg.max_slots
        hn = llama.unembed_norm(self.params, mcfg, h)
        act = st["act_idx"][:ba].long()
        rows = act.clamp(max=B - 1)

        def take(name: str) -> torch.Tensor:
            return st[name].index_select(0, rows)

        hit, tail = self._bad_seq_hits(take("bad_seq"), take("bad_len"),
                                       take("recent"))
        # AWQ's activation smoothing once per step, not once per tile.
        ha = llama.lm_head_input(self.params, hn.index_select(0, rows))
        tok_a = fused_unembed_sample(
            lambda t0, tile: llama.lm_head_tile(self.params, mcfg, ha, t0,
                                                tile, prescaled=True),
            mcfg.vocab_size, noise=self._round_gen, temp=take("temp"),
            top_k=take("top_k"), top_p=take("top_p"),
            rep_pen=take("rep_pen"), seen_words=take("seen"),
            banned_words=take("banned"), ban_tok=tail, ban_hit=hit,
            greedy=greedy, tile=self._sampler_tile,
            cand_k=self.cfg.sampler_cand_k)
        tok = torch.zeros((B + 1,), dtype=torch.int32, device=h.device)
        return tok.index_copy(0, act, tok_a)[:B]

    def _materialized_tail(self, h: torch.Tensor,
                           greedy: bool) -> torch.Tensor:
        """The materialized tail (``fused_tail=False``, the oracle): (B, V)
        float32 logits of every slot, penalized, banned and sampled with a
        full sort. Returns (B,) int32."""
        st, mcfg, V = self._state, self.model_cfg, self.model_cfg.vocab_size
        pen = apply_repetition_penalty(
            llama.unembed(self.params, mcfg, h), unpack_mask(st["seen"], V),
            st["rep_pen"])
        pen = torch.where(unpack_mask(st["banned"], V),
                          torch.full_like(pen, NEG_INF), pen)
        hit, tail = self._bad_seq_hits(st["bad_seq"], st["bad_len"],
                                       st["recent"])
        pen = pen.scatter_reduce(
            1, torch.where(hit, tail, torch.zeros_like(tail)).long(),
            torch.where(hit, torch.full_like(pen[:, :1], NEG_INF),
                        torch.full_like(pen[:, :1], float("inf"))
                        ).expand(hit.shape).contiguous(),
            reduce="amin")
        if greedy:
            return pen.float().argmax(dim=-1).to(torch.int32)
        return sample(pen, st["temp"], st["top_k"], st["top_p"],
                      self._round_gen)

    @torch.no_grad()
    def _decode_step(self, k: int, greedy: bool, ba: int) -> None:
        """Decode step ``k`` of a round over every slot (the reference's
        ``make_round`` body), in place: row ``k`` of ``round_tokens``
        gets each slot's token, -1 for slots inactive at step entry; the
        slot state advances. eos and length stops happen on the device
        (``active`` drops), so the host reads the tokens once per round.
        Attention takes the whole block table: the kernel loops over each
        slot's live pages only (the reference's gather path sliced a page
        window instead). The pool is updated in place by each layer's
        attention call. The tail samples the ``ba`` rows of ``act_idx``
        (fused) or every row (materialized)."""
        st, mcfg = self._state, self.model_cfg
        page = self.cfg.page_size
        eos = int(self.tokenizer.eos_id)
        pos, active = st["pos"], st["active"]
        # A retired slot's stale pos may point past its table: clamp
        # (the reference's gather clamps), the row is masked anyway.
        pidx = (pos // page).clamp(max=self._pmax - 1).long()
        page_of = torch.gather(st["table"], 1, pidx[:, None])[:, 0]
        wp = torch.where(active, page_of, torch.zeros_like(page_of))
        # Inactive slots attend over nothing (length 0) and write the
        # trash page.
        eff_pos = torch.where(active, pos, torch.zeros_like(pos))
        h, _ = llama.apply_decode_paged(
            self.params, mcfg, st["last_token"][:, None],
            eff_pos[:, None], st["cache"], st["table"], wp,
            eff_pos % page, return_hidden=True)
        if self.cfg.fused_tail:
            tok = self._fused_tail(h[:, 0], greedy, ba)
        else:
            tok = self._materialized_tail(h[:, 0], greedy)
        remaining = torch.where(active, st["remaining"] - 1,
                                st["remaining"])
        finished = active & (((tok == eos) & st["eos_ok"])
                             | (remaining <= 0))
        # Every new value is computed before the first write.
        new = {
            "pos": torch.where(active, pos + 1, pos),
            "last_token": torch.where(active, tok, st["last_token"]),
            "remaining": remaining,
            "seen": set_token_bits(st["seen"], tok, active),
            "recent": torch.where(
                active[:, None],
                torch.cat([st["recent"][:, 1:], tok[:, None]], dim=1),
                st["recent"]),
            "active": active & ~finished}
        st["round_tokens"][k].copy_(
            torch.where(active, tok, torch.full_like(tok, -1)))
        for name, value in new.items():
            st[name].copy_(value)

    def _round_body(self, steps: int, greedy: bool,
                    ba: Optional[int] = None) -> None:
        for k in range(steps):
            self._decode_step(k, greedy, ba or self.cfg.max_slots)

    def _decode_round(self, steps: int, greedy: bool,
                      ba: int) -> torch.Tensor:
        """``steps`` decode steps over every slot, the tail sampling the
        ``ba`` rows of ``act_idx``; returns the (steps, B) int32 view of
        ``round_tokens`` (-1 for slots inactive at step entry). On the
        card with graphs on, only the rung's captured program runs."""
        self._replay(self._round_graphs, self._round_body, steps, greedy, ba)
        return self._state["round_tokens"][:steps]

    def _ba_for(self, n: int) -> int:
        """The smallest active-row rung that covers ``n`` armed slots."""
        return next(b for b in self._ba_ladder if b >= max(1, n))

    @property
    def _graphs_on(self) -> bool:
        return self.device.type == "cuda" and self.cfg.cuda_graphs

    def _programs(self):
        """Every device program the serve loop runs, as (table, key,
        body, generator or None), largest chunk length first so the
        smaller ones reuse its memory: per bucket C the admission
        ``(C, greedy)``, the chunk extensions ``(C, mode)`` and the final
        chunks ``(C, greedy, seed)``; then the decode-round rungs
        ``(steps, greedy, ba)``, ``ba`` over the active-row ladder.
        Sampled programs draw from a generator."""
        for C in sorted(self._buckets, reverse=True):
            for greedy in (True, False):
                yield (self._admit_graphs, (C, greedy),
                       functools.partial(self._admit_body, C, greedy),
                       None if greedy else self._admit_gen)
            for mode in self.CHUNK_MODES:
                yield (self._extend_graphs, (C, mode),
                       functools.partial(self._chunk_extend_body, C, mode),
                       None)
            for greedy in (True, False):
                for seed in (False, True):
                    yield (self._final_graphs, (C, greedy, seed),
                           functools.partial(self._chunk_final_body, C,
                                             greedy, seed),
                           None if greedy else self._admit_gen)
        for steps in graphs.round_rungs(self.cfg.steps_per_round):
            for greedy in (True, False):
                for ba in self._ba_ladder:
                    yield (self._round_graphs, (steps, greedy, ba),
                           functools.partial(self._round_body, steps, greedy,
                                             ba),
                           None if greedy else self._round_gen)

    def _prewarm(self) -> StepCostModel:
        """Capture every device program the serve loop runs
        (``_programs``; the reference's ``prewarm``, narrowed to capture),
        so no request pays for one, then measure the step-cost model the
        scheduler plans with. Each program is warmed up once on a side
        stream and captured there, into one memory pool the programs
        share. The warm-ups write the trash page and an inactive slot 0
        (staged below), so the state is reset afterwards. Under "auto"
        pool sizing the programs' pool must fit in the reserve the sizing
        kept. A failed capture raises."""
        dev = self.device
        h = self._admit_host
        h["length"][0] = 1      # a one-token prompt into the trash page
        h["temp"][0] = h["top_p"][0] = h["rep_pen"][0] = 1.0
        self._copy_admission_inputs()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        stream = self._capture_stream
        pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        for table, key, body, gen in self._programs():
            table[key] = graphs.capture(
                body, device=dev, stream=stream, pool=pool,
                generators=() if gen is None else (gen,))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        cost = StepCostModel(slots=self.cfg.max_slots)
        if self.cfg.sched_round_budget_tokens is None:
            cost = self._measure_costs()
        self._reset_state()
        torch.cuda.synchronize(dev)
        if (self._pool_reserve is not None
                and self.graph_pool_bytes > self._pool_reserve):
            raise ConfigError(
                f"the captured programs hold {self.graph_pool_bytes} bytes, "
                f"more than the {self._pool_reserve} bytes that "
                f'kv_pool_tokens="auto" reserved for them')
        return cost

    def _measure_costs(self, replays: int = 3) -> StepCostModel:
        """The scheduler's step-cost model, measured on the card by CUDA
        events around replays of the captured programs: the
        ``steps_per_round`` rung gives ``decode_step_ms`` and the largest
        bucket's admission ``prefill_ms_per_token`` (a bucket's prefill
        costs its full length whatever the prompt). The replays run on
        the staged warm-up inputs, into the trash page."""
        def ms(program: graphs.Program) -> float:
            program.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(replays):
                program.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / replays

        steps, bucket = self.cfg.steps_per_round, self._buckets[-1]
        return StepCostModel(
            decode_step_ms=ms(self._round_graphs[
                (steps, True, self.cfg.max_slots)]) / steps,
            prefill_ms_per_token=ms(self._admit_graphs[(bucket, True)])
            / bucket,
            slots=self.cfg.max_slots, source="measured")

    # ------------------------------------------------------------ lifecycle

    # How often ``prewarm`` shrinks the pool before it gives up (the
    # reference's default).
    PREWARM_RETRIES = 4

    def prewarm(self) -> None:
        """Check the pool's size by serving through the real loop, before
        any request: two short concurrent streams, so both rungs of the
        active-row ladder run, then one worst-case request (a prompt of
        ``max_input_length`` tokens, rounds at full depth). The dummies
        are scrubbed from ``stats["requests"]``. When the card runs out
        of memory the pool shrinks by the reference's rule, to
        ``int((pages - 1) * 0.8) + 1`` pages with the trash page (never
        below one request's pages), and the engine is rebuilt at that
        size, up to ``PREWARM_RETRIES`` times. The engine must be
        stopped."""
        if self._thread is not None:
            raise EngineError("prewarm() requires a stopped engine")
        for attempt in range(self.PREWARM_RETRIES + 1):
            try:
                if attempt:
                    # Inside the try: the rebuild's own allocations can
                    # run out too, and that shrinks the pool again.
                    self._rebuild()
                self._verify_alloc()
                return
            except torch.cuda.OutOfMemoryError as exc:
                new_pages = max(self._pmax + 1,
                                int((self._n_pages - 1) * 0.8) + 1)
                if (attempt == self.PREWARM_RETRIES
                        or new_pages >= self._n_pages):
                    raise
                # The failed serve's frames (its device tensors) hang off
                # the error's tracebacks, and the loop keeps the error as
                # ``_fatal``: both go before the rebuild frees the pool.
                _drop_tracebacks(exc)
                self._fatal = None
                log_event(logger, "engine_prewarm_oom",
                          pool_pages=self._n_pages - 1,
                          retry_pages=new_pages - 1)
                self._n_pages = new_pages

    def _verify_alloc(self) -> None:
        """``prewarm``'s serve: the two short streams, then, once they are
        done, the worst-case request, through the started loop, holding
        256 MiB spare on the card so the accepted size has headroom past
        the serve's peak."""
        slack = (torch.empty((256 << 20,), dtype=torch.int8,
                             device=self.device)
                 if self.device.type == "cuda" else None)
        ids = [min(3, self.model_cfg.vocab_size - 1)] * \
            self.cfg.max_input_length
        streams = []
        if self.cfg.max_slots > 1 and self.cfg.fused_tail:
            # Submitted together before the loop starts and long enough
            # (three rounds) that their decoding overlaps even when the
            # budget admits them a step apart: rounds over both take the
            # full-width rung.
            streams = [self.submit(ids[:16], SamplingParams(
                max_tokens=min(self.cfg.max_output_length,
                               3 * self.cfg.steps_per_round + 1),
                top_k=1, ignore_eos=True),
                request_id=f"engine-prewarm-b{i}") for i in range(2)]

        def drain(batch) -> None:
            for stream in batch:
                try:
                    stream.text()
                except EngineError as exc:
                    # The caller matches the loop's own failure (an out of
                    # memory error), not the stream's wrapper.
                    raise (self._fatal or exc) from exc

        try:
            self.start()
            drain(streams)
            streams.append(self.submit(ids, SamplingParams(
                max_tokens=min(self.cfg.max_output_length,
                               2 * self.cfg.steps_per_round + 1),
                top_k=1, ignore_eos=True), request_id="engine-prewarm"))
            drain(streams[-1:])
        finally:
            with self._stats_lock:
                self._stats["requests"] -= len(streams)
            try:
                self.stop()
            except Exception:  # noqa: BLE001 - cleanup after a failure
                pass
            del slack

    def _rebuild(self) -> None:
        """Drop the pool, the state and every captured program, and build
        them again at ``_n_pages`` pages (``_build_device``). The serve
        loop is stopped; whatever it held is gone, every reference to the
        failed serve's tensors (its error, its requests and outputs)
        before the cache is emptied."""
        self._fatal = None
        self._state = self._admit_in = None
        self._round_graphs = self._admit_graphs = {}
        self._extend_graphs = self._final_graphs = {}
        self._slots = {}
        self._free_slots = list(range(self.cfg.max_slots))
        self._drain_intake()
        self._completed = queue.Queue()
        self._harvest_q = queue.Queue()
        self._inline = []
        self._marks = []
        self._inflight_rounds = 0
        self._chunk_behind = False
        self._ring.reset()
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self._build_device()
        with self._stats_lock:
            self._stats["sched_round_budget_tokens"] = \
                self._sched.round_budget_tokens

    def start(self) -> None:
        """Start the serve thread, and with ``dispatch_depth`` > 1 the
        harvest worker."""
        if self._thread is None:
            self._stopped.clear()
            if self.cfg.dispatch_depth > 1:
                self._start_harvest(self.cfg.dispatch_depth)
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="engine-loop")
            self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise EngineError("engine loop did not stop within 60s")
            self._thread = None
        self._stop_harvest()
        self._complete_marks(0.0)
        # Cancel what is still live so no consumer blocks forever, and
        # deactivate the slots so a restart reuses no live pages.
        for req in list(self._slots.values()):
            self._release(req)
        for req in self._drain_intake():
            if not req.done:
                req.stream._finish("cancelled")

    def _start_harvest(self, depth: int) -> None:
        """Start the harvest worker with ``depth`` decode rounds allowed in
        flight (the serve loop's ``start`` does; a caller driving
        ``_step`` itself may too). Nothing may be in flight."""
        if self._harvest_thread is not None:
            return
        if len(self._ring) < 2 * (depth + 1):
            self._ring = _HostRing(2 * (depth + 1), tuple(
                self._ring.bufs[0].shape), self.device)
        self._depth = depth
        self._harvest_stop.clear()
        self._harvest_thread = threading.Thread(
            target=self._harvest_loop, daemon=True, name="engine-harvest")
        self._harvest_thread.start()

    def _stop_harvest(self) -> None:
        """Stop and join the harvest worker. Items it left unread are
        read here (unless it failed), so their streams still get their
        tokens."""
        worker = self._harvest_thread
        if worker is None:
            return
        self._harvest_stop.set()
        worker.join(timeout=60)
        if worker.is_alive():
            raise EngineError("harvest worker did not stop within 60s")
        self._harvest_thread = None
        self._depth = 1
        while True:
            try:
                item = self._harvest_q.get_nowait()
            except queue.Empty:
                break
            if self._fatal is None:
                self._read_back(item)
        self._inflight_rounds = 0
        self._chunk_behind = False
        self._ring.reset()

    def _alive(self) -> None:
        """Raise if the engine failed (a wait on the harvest gives up)."""
        if self._fatal is not None:
            raise EngineError("the engine failed") from self._fatal

    def clear_prefix_cache(self) -> int:
        """Evict every cached page no live request maps back to the free
        list, so the next requests prefill cold; returns how many. The
        cache belongs to the serve thread: call this while it is
        stopped."""
        if self._prefix_cache is None or self._thread is not None:
            return 0
        freed = self._prefix_cache.evict(self._prefix_cache.idle_pages)
        self._free_pages.extend(freed)
        return len(freed)

    def __enter__(self) -> "Engine":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ API

    def _compile_bad_words(self, params: SamplingParams
                           ) -> tuple[list[int], list[list[int]]]:
        """bad_words -> (single-token ids, multi-token sequences):
        single-token spellings go on the vocab mask, multi-token ones
        become device-side sequence bans."""
        banned_ids: list[int] = []
        bad_seqs: list[list[int]] = []
        for word in params.bad_words:
            variants = set()
            seqs: list[list[int]] = []
            for text in (word, " " + word):
                ids = [int(i) for i in
                       self.tokenizer.encode(text, add_bos=False)]
                if len(ids) == 1:
                    variants.add(ids[0])
                elif ids and ids not in seqs:
                    seqs.append(ids)
            for piece in (word, "▁" + word):
                pid = self.tokenizer.piece_id(piece)
                if pid is not None:
                    variants.add(int(pid))
            banned_ids.extend(sorted(variants))
            for seq in seqs:
                if any(t in variants for t in seq):
                    continue  # can never complete: a piece is banned
                if len(seq) > self.MAX_BAD_LEN:
                    raise EngineError(
                        f"bad_words entry {word!r} tokenizes to {len(seq)} "
                        f"tokens; the device-side sequence ban supports up "
                        f"to {self.MAX_BAD_LEN}")
                if seq not in bad_seqs:
                    bad_seqs.append(seq)
            if not variants and not seqs:
                raise EngineError(f"bad_words entry {word!r} produced no "
                                  f"tokens")
        if len(bad_seqs) > self.MAX_BAD_SEQS:
            raise EngineError(f"{len(bad_seqs)} multi-token bad-word "
                              f"sequences; the device table holds "
                              f"{self.MAX_BAD_SEQS}")
        return banned_ids, bad_seqs

    def _new_stream(self, request_id: Optional[str], prompt_tokens: int,
                    eff_max: int) -> TokenStream:
        """The stream and flight timeline of one submission. Without an
        explicit ``request_id``, a timeline bound on the calling context
        (the chain server's request, ``obs_flight.bind``) is adopted by
        object identity, and the edge completes it; otherwise the
        recorder begins a fresh timeline under ``request_id`` (minted
        when None; a duplicate of an in-flight ID gets a ``#N`` suffix),
        which the stream completes."""
        tl_ctx = obs_flight.current()
        if request_id is None and tl_ctx is not None:
            tl, owns = tl_ctx, False
        else:
            tl = self.flight.begin(
                request_id or obs_flight.mint_request_id(), fresh=True)
            owns = True
        stream = TokenStream(tl.request_id)
        stream.owns_timeline = owns
        tl.annotate(prompt_tokens=prompt_tokens, max_tokens=eff_max)
        tl.event("engine_submit")
        stream.timeline = tl
        stream._flight = self.flight
        return stream

    @staticmethod
    def _resolve_deadline(stream: TokenStream,
                          deadline_t: Optional[float]) -> Optional[float]:
        """The request's deadline: the explicit argument (the OpenAI
        surface passes it), else whatever the serving edge armed on an
        adopted timeline. An explicit deadline is stamped onto an unarmed
        timeline so /debug/requests shows the budget the request ran
        against."""
        tl = stream.timeline
        if deadline_t is None:
            return tl.deadline_t if tl is not None else None
        if tl is not None and tl.deadline_t is None:
            tl.set_deadline((deadline_t - tl.t_start) * 1e3)
            tl.deadline_t = deadline_t
        return deadline_t

    def submit(self, prompt_ids: Sequence[int],
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None,
               deadline_t: Optional[float] = None) -> TokenStream:
        """Enqueue a request; returns its stream immediately.
        ``request_id`` names the request end to end (its timeline in
        ``/debug/requests``); ``deadline_t`` is an absolute
        ``time.monotonic`` deadline (see ``_Request.deadline_t``)."""
        if self._fatal is not None:
            raise EngineError("engine is dead") from self._fatal
        params = params or SamplingParams()
        if len(prompt_ids) > self.cfg.max_input_length:
            raise EngineError(
                f"prompt length {len(prompt_ids)} exceeds max_input_length "
                f"{self.cfg.max_input_length}")
        if len(prompt_ids) == 0:
            raise EngineError("empty prompt")
        ids = [int(t) for t in prompt_ids]
        eff_max = min(params.max_tokens, self.cfg.max_cache_len - len(ids))
        need = _ceil_div(len(ids) + eff_max, self.cfg.page_size)
        if need > self._n_pages - 1:
            raise EngineError(
                f"request needs {need} KV pages but the pool only has "
                f"{self._n_pages - 1} (kv_pool_tokens too small)")
        banned_ids, bad_seqs = self._compile_bad_words(params)
        banned_row = np.zeros((self.model_cfg.vocab_size,), bool)
        banned_row[banned_ids] = True
        seq_tbl = np.full((self.MAX_BAD_SEQS, self.MAX_BAD_LEN), -1,
                          np.int32)
        seq_len = np.zeros((self.MAX_BAD_SEQS,), np.int32)
        for i, seq in enumerate(bad_seqs):
            seq_tbl[i, :len(seq)] = seq
            seq_len[i] = len(seq)
        stream = self._new_stream(request_id, len(ids), eff_max)
        req = _Request(stream=stream, prompt_ids=ids, params=params,
                       detok=IncrementalDetokenizer(self.tokenizer),
                       stop=StopWordTrap(params.stop_words),
                       eff_max=eff_max, extent=len(ids) + eff_max,
                       greedy=(params.top_k == 1 or params.temperature <= 0),
                       banned_np=pack_mask_np(banned_row),
                       bad_seq_np=seq_tbl, bad_len_np=seq_len,
                       deadline_t=self._resolve_deadline(stream, deadline_t),
                       seq=next(self._arrival_seq))
        if len(self._backlog) + self._pending.qsize() >= self.cfg.max_queue:
            self._reject_full(stream)
        try:
            self._pending.put_nowait(req)
        except queue.Full:
            self._reject_full(stream)
        if self._fatal is not None:
            stream._fail(self._fatal)
        self._bump("requests")
        self._wake.set()
        return stream

    def _reject_full(self, stream: TokenStream) -> None:
        """Refuse a submission at a full queue: count it, and retire its
        timeline with the reason."""
        self._bump("rejected_full")
        tl = stream.timeline
        if tl is not None:
            tl.annotate(finish="rejected")
            if stream.owns_timeline:
                self.flight.complete(tl)
        raise SchedulerFullError(
            f"request queue full ({self.cfg.max_queue})") from None

    def generate_text(self, prompt: str,
                      params: Optional[SamplingParams] = None,
                      request_id: Optional[str] = None) -> str:
        """Sync convenience: tokenize, generate, detokenize."""
        self.start()
        return self.submit(self.tokenizer.encode(prompt), params,
                           request_id=request_id).text()

    def stream_text(self, prompt: str,
                    params: Optional[SamplingParams] = None,
                    request_id: Optional[str] = None,
                    deadline_t: Optional[float] = None) -> TokenStream:
        self.start()
        return self.submit(self.tokenizer.encode(prompt), params,
                           request_id=request_id, deadline_t=deadline_t)

    # ------------------------------------------------------------ scheduler

    def _bucket_for(self, n: int) -> int:
        """The smallest bucket that holds ``n`` tokens: a one-shot
        admission's length, and a chunk's padded length (the reference's
        ``_chunk_pad``, so chunks add no shapes of their own)."""
        return next((b for b in self._buckets if n <= b), self._buckets[-1])

    def _drain_intake(self) -> list[_Request]:
        out, self._backlog = self._backlog, []
        while True:
            try:
                out.append(self._pending.get_nowait())
            except queue.Empty:
                return out

    def _run(self) -> None:
        """Serve thread: retire, plan, dispatch (and, without a harvest
        worker, harvest)."""
        try:
            while not self._stopped.is_set():
                # Cleared before the step: a wake-up posted while it runs
                # (a harvested round opening the depth gate) is kept.
                self._wake.clear()
                if not self._step():
                    self._wake.wait(timeout=0.05)
        except BaseException as exc:  # noqa: BLE001 - report to all streams
            if self._fatal is None:
                self._fatal = exc
            for req in list(self._slots.values()) + self._drain_intake():
                if not req.done:
                    req.stream._fail(self._fatal)

    def _step(self) -> bool:
        """One iteration of the serve loop (the reference's
        ``_plan_round`` and ``_execute_plan``): retire finished requests,
        plan the round, dispatch its decode round over the armed slots
        (while fewer than the dispatch depth are in flight), then its
        prompt chunks, then post the first tokens of the slots it armed
        and the round's tokens for the harvest (the worker's queue, or
        read here at the end of the step). False when there was nothing
        to do."""
        self._alive()
        did = self._drain_completed()
        self._pull_pending()
        did |= self._cull_backlog()
        plan = self._plan_round()
        rec = None
        if plan.decode_steps or plan.chunks:
            # The round's record: the plan now, the dispatch half sealed
            # below, the execution half completed by the harvest.
            rec = self.rounds.begin(
                engine_tag=self._engine_tag,
                budget_tokens=self._sched.round_budget_tokens,
                decode_steps=plan.decode_steps,
                decode_cost_tokens=plan.decode_cost_tokens,
                active_decodes=plan.active_decodes,
                kind="decode" if plan.decode_steps else "prefill",
                on_complete=self._on_round_complete)
        try:
            work = self._execute_plan(plan, rec)
        except BaseException:
            # A round that failed mid-dispatch leaves no unsealed record.
            if rec is not None and not rec._sealed:
                self.rounds.discard(rec)
            raise
        items, self._inline = self._inline, []
        for item in items:
            self._read_back(item)
        return did or work

    def _execute_plan(self, plan: RoundPlan, rec) -> bool:
        """Dispatch the plan's decode round, then its prompt chunks; post
        for the harvest the first tokens of the slots it armed (their copy
        runs after every chunk, so reading it completes the chunks' part
        of the round) or, when chunks armed none, a marker that the next
        output read back completes; seal the round's record with the parts
        the harvest will complete (or drop it when nothing was
        dispatched). True when anything was done."""
        dispatched = False
        if plan.decode_steps:
            self._dispatch_round(plan.decode_steps, rec)
            dispatched = True
            self._bump("sched_decode_tokens", plan.decode_cost_tokens)
        armed, prefilled, admitted, grants = self._run_chunks(plan.chunks,
                                                              rec)
        if prefilled:
            self._chunk_behind = True
            self._bump("sched_prefill_tokens", prefilled)
            if dispatched:
                self._bump("sched_interleaved_rounds")
        if armed:
            # Each final chunk or admission left its first token in its
            # slot's last_token: one copy serves them all.
            self._post(("first", {r.slot: r for r in armed},
                        self._ring.copy(self._state["last_token"],
                                        self._alive), 1, rec))
        if rec is not None:
            if prefilled and not armed:
                self._post(("mark", {}, None, 0, rec))
            parts = int(dispatched) + int(bool(prefilled))
            if not parts:
                self.rounds.discard(rec)
            else:
                if not dispatched:
                    rec.kind = "prefill"
                elif prefilled:
                    rec.kind = "mixed"
                self.rounds.seal(
                    rec, parts=parts, prefill_tokens=prefilled,
                    grants=grants, modeled_ms=self._modeled_round_ms(
                        plan.decode_steps if dispatched else 0, prefilled))
        return admitted or bool(prefilled) or dispatched

    def _modeled_round_ms(self, decode_steps: int,
                          prefill_tokens: int) -> float:
        """What the step-cost model predicts the round takes: the
        denominator of its drift ratio."""
        cost = self._sched.cost
        return (cost.decode_round_ms(decode_steps)
                + prefill_tokens * cost.prefill_ms_per_token)

    def _on_round_complete(self, rec) -> None:
        """A round's record completed (on whichever thread harvested its
        last part): its bandwidth share and drift, the metrics and the
        span. Never raises."""
        try:
            if self._hbm_peak > 0 and rec.device_ms > 0:
                rec.bw_util = (rec.hbm_bytes / (rec.device_ms / 1e3)
                               / self._hbm_peak)
            ratio = (rec.round_ms / rec.modeled_ms
                     if rec.modeled_ms > 0 else 0.0)
            rec.drift_ratio = ratio
            if ratio > 0:
                prev = self._drift_ratio
                self._drift_ratio = (ratio if prev is None
                                     else prev + 0.2 * (ratio - prev))
            self._bump("rounds_completed")
            obs_rounds.record_round_metrics(rec, self._drift_ratio)
            obs_rounds.emit_round_span(rec)
        except Exception:  # noqa: BLE001 - telemetry never raises
            logger.debug("round completion accounting failed",
                         exc_info=True)

    def _post(self, item: tuple) -> None:
        """Hand a dispatched program's output to the harvest: the
        worker's queue when it runs, else read at the end of the step."""
        if self._harvest_thread is not None:
            self._harvest_q.put(item)
        else:
            self._inline.append(item)

    def _harvest_loop(self) -> None:
        """Harvest thread: read the queued outputs in dispatch order,
        blocking on each copy here so the serve thread never does. It
        touches no device state and none of the serve thread's
        structures; a failure becomes ``_fatal``, which the serve thread
        fans out to every stream."""
        try:
            while not self._harvest_stop.is_set() and self._fatal is None:
                try:
                    item = self._harvest_q.get(timeout=0.05)
                except queue.Empty:
                    continue
                self._read_back(item)
                self._wake.set()
        except BaseException as exc:  # noqa: BLE001 - fanned out by _step
            if self._fatal is None:
                self._fatal = exc
            self._wake.set()

    def _read_back(self, item: tuple) -> None:
        """One posted item, in dispatch order: an output (``_harvest``);
        ``("mark", {}, None, 0, record)`` after a round's prompt chunks
        that armed no slot; ``("flush", {}, event, 0, None)`` after an
        admission stopped between its chunks. A marker waits for nothing:
        the next output read back, queued on the device after the
        marker's chunks, completes its round's prefill part (a wait of its
        own would hold the harvest off the rounds a long chunk program's
        launch blocks behind). A stopped admission may leave no later
        output, so its flush waits for the device to finish the work
        queued before it (the event; nothing to wait for on the CPU) and
        completes every marker read so far."""
        kind = item[0]
        if kind == "mark":
            self._marks.append(item[4])
        elif kind == "flush":
            t0 = time.monotonic()
            if item[2] is not None:
                item[2].synchronize()
            self._complete_marks(time.monotonic() - t0)
        else:
            self._harvest(item)

    def _harvest(self, item: tuple) -> None:
        """Read one output back and deliver its tokens: ``("first",
        {slot: request}, buffer, 1, record)`` for the slots an admission
        armed, ``("round", {slot: request}, buffer, steps, record)`` for a
        decode round (-1 marks a slot inactive on the device at that
        step). A request the harvest finished mid-round drops its later
        tokens: the device ran it on until the serve thread deactivates
        it. Each output completes its part of the round's record (a
        "first" output the prefill part) and the prefill parts of the
        markers read before it. Each request's timeline gets one event per
        round, none per token."""
        kind, members, buf, rows, rec = item
        t0 = time.monotonic()
        grid = self._ring.read(buf, rows)
        now = time.monotonic()
        wait = now - t0
        self._complete_marks(wait)
        emitted = dict.fromkeys(members, 0)
        live = {slot: not req.done for slot, req in members.items()}
        for row in grid:
            for slot, req in members.items():
                tok = row[slot]
                if tok >= 0 and not req.done:
                    emitted[slot] += 1
                    self._emit_token(req, tok, now)
        if kind == "first":
            record_stage("engine_first_readback", wait)
            with self._stats_lock:
                self._stats["first_readback_ms"] += wait * 1e3
                self._stats["first_readbacks"] += 1
            for i, (slot, req) in enumerate(members.items()):
                if req.stream.timeline is not None:
                    req.stream.timeline.stage("engine_first_readback", wait)
                self.rounds.first_token(rec, wait_ms=0.0 if i else wait * 1e3,
                                        counted=live[slot])
            self.rounds.complete_part(rec, harvest_wait_ms=wait * 1e3)
            return
        with self._stats_lock:
            self._stats["harvest_rounds"] += 1
            self._stats["harvest_wait_ms"] += wait * 1e3
            self._stats["harvest_emit_ms"] += (time.monotonic() - now) * 1e3
        record_stage("engine_harvest_wait", wait)
        for slot, n in emitted.items():
            tl = members[slot].stream.timeline
            if n and tl is not None:
                tl.event("decode_round", n)
        self.rounds.complete_part(rec, tokens=sum(emitted.values()),
                                  harvest_wait_ms=wait * 1e3)
        # Last: the depth gate opens only once the round is accounted for,
        # and the serve thread is woken right after.
        with self._pipe_lock:
            self._inflight_rounds -= 1

    def _complete_marks(self, wait_s: float) -> None:
        """Complete the prefill parts of the markers read so far (their
        chunks ran before the output just read back)."""
        marks, self._marks = self._marks, []
        for rec in marks:
            self.rounds.complete_part(rec, harvest_wait_ms=wait_s * 1e3)

    def _drain_completed(self) -> bool:
        """Retire the requests the harvest finished: deactivate each slot
        on the device (a stop word or a cancel leaves it live there) and
        return its slot and pages. True when one was retired."""
        did = False
        while True:
            try:
                req = self._completed.get_nowait()
            except queue.Empty:
                return did
            if self._slots.get(req.slot) is req:
                self._release(req)
                did = True

    def _pull_pending(self) -> None:
        """Move submitted requests into the backlog."""
        while True:
            try:
                self._backlog.append(self._pending.get_nowait())
            except queue.Empty:
                return

    def _cull_backlog(self) -> bool:
        """Finish the backlog's cancelled requests and drop those past
        their deadline ("deadline_queue"), every round before a slot or a
        page is touched. True when one was finished."""
        kept, did = [], False
        now = time.monotonic()
        for req in self._backlog:
            if req.stream.cancelled:
                req.stream._finish("cancelled")
                did = True
            elif req.deadline_t is not None and now > req.deadline_t:
                self._bump("deadline_queue_drops")
                tl = req.stream.timeline
                if tl is not None:
                    tl.stage("engine_admit_pickup",
                             now - req.stream.submit_time)
                req.stream._finish("deadline_queue")
                did = True
            else:
                kept.append(req)
        self._backlog = kept
        return did

    def _armed(self) -> dict[int, _Request]:
        """The slots that decode: prefill done, not finished."""
        return {s: r for s, r in self._slots.items()
                if r.prefill_done and not r.done}

    def _plan_round(self):
        """This round's plan: the decode round right-sized against the
        power-of-two step ladder (as before the scheduler, so decode-only
        traffic runs the rounds it always ran) plus the prefill jobs the
        scheduler may grant chunks to: slots mid-prefill first, then the
        backlog when a slot is free. Empty while armed slots wait for a
        round, the pipeline holds ``_depth`` rounds and prompt chunks
        were dispatched since the last round."""
        armed = self._armed()
        # proj_pos is the device pos after the last dispatched step; the
        # first token came from prefill, so extent - 1 - proj_pos steps
        # remain at most.
        need = max((r.extent - 1 - r.proj_pos for r in armed.values()),
                   default=0)
        steps = graphs.rung_for(self.cfg.steps_per_round, need) \
            if need > 0 else 0
        # The depth gate: no new round while ``_depth`` are in flight.
        # Prompt chunks may take the place of the next round unless
        # chunks already followed the last one: they are granted what is
        # left beside that round, so one chunk step queues between two
        # rounds as at depth 1 (a request arriving beside decoding
        # streams waits for no extra round), and chunks never run back
        # to back ahead of the next round.
        gated = steps > 0 and self._inflight_rounds >= self._depth
        if gated and self._chunk_behind:
            return RoundPlan(decode_steps=0, active_decodes=len(armed))
        inflight = [PrefillJob(key=r, remaining=len(r.prompt_ids) - r.pf_pos,
                               deadline_t=r.deadline_t, seq=r.seq,
                               started=True)
                    for r in self._slots.values() if not r.prefill_done]
        backlog = [PrefillJob(key=r, remaining=len(r.prompt_ids),
                              deadline_t=r.deadline_t, seq=r.seq)
                   for r in self._backlog] if self._free_slots else []
        plan = self._sched.plan_round(
            decode_steps=steps, active_decodes=len(armed), inflight=inflight,
            backlog=backlog, now=time.monotonic(),
            max_new=len(self._free_slots))
        if gated:
            plan.decode_steps = 0
        return plan

    def _run_chunks(self, chunks, rec=None
                    ) -> tuple[list[_Request], int, bool, list]:
        """Dispatch the plan's prefill grants: a request without a slot is
        admitted first (``_begin_prefill``); admitting stops at pool
        backpressure. Returns (requests armed this round, prompt tokens
        prefilled, whether any request was admitted or dropped, the
        (request id, tokens) grants dispatched). Each program's estimated
        bytes (the weights once, its tokens' KV written) go on ``rec``."""
        armed: list[_Request] = []
        grants: list[tuple[str, int]] = []
        prefilled, admitted = 0, False
        for req, grant in chunks:
            if req.slot < 0:
                if not self._free_slots:
                    break
                ok = self._begin_prefill(req)
                if ok is None:     # cancelled while it waited
                    admitted = True
                    continue
                if not ok:         # pool backpressure: stop admitting
                    break
                admitted = True
            n = self._advance_prefill(req, grant)
            if n:
                prefilled += n
                grants.append((req.stream.request_id, n))
                if rec is not None:
                    rec.hbm_bytes += (self._param_bytes
                                      + n * self._kv_bytes_per_token())
            if req.prefill_done:
                armed.append(req)
        return armed, prefilled, admitted, grants

    def _prefix_lookup(self, req: _Request):
        """Match the prompt's full blocks against the prefix cache and
        take refs on the usable prefix. Returns (the prompt's block
        hashes, how many leading blocks to map read-only, their pages).
        A full-cover match is capped one block short (COW demotion)."""
        if self._prefix_cache is None:
            return [], 0, []
        page = self.cfg.page_size
        if req.block_hashes is None:  # backpressure retries re-enter here
            req.block_hashes = hash_blocks(req.prompt_ids, page)
        hashes = req.block_hashes
        matched = self._prefix_cache.match(hashes)
        k_use = usable_prefix_tokens(matched, len(req.prompt_ids),
                                     page) // page
        if k_use == 0:
            return hashes, 0, []
        return hashes, k_use, self._prefix_cache.acquire(hashes[:k_use])

    def _register_prefix(self, req: _Request, hashes: list,
                         k_use: int) -> None:
        """Hand the freshly prefilled full prompt blocks to the cache
        (they hold prompt KV only: decode writes land past the last full
        block). A block already cached (the COW-demoted tail) keeps its
        page private; it frees at retire."""
        if self._prefix_cache is None:
            return
        for i in range(k_use, len(hashes)):
            parent = hashes[i - 1] if i else None
            if self._prefix_cache.insert(hashes[i], parent, req.pages[i]):
                req.cache_refs.append(hashes[i])
                req.cache_pages.add(req.pages[i])

    def _begin_prefill(self, req: _Request) -> Optional[bool]:
        """Admission, first half: the slot and pages (a prefix hit's
        cached pages first), prefix-cache refs, and the context the
        prefill programs share. Pool pressure evicts refcount-0 cached
        pages before it reports backpressure. Returns True on success,
        False on backpressure (the request stays in the backlog), None
        when the request was cancelled instead."""
        if req.stream.cancelled:
            self._backlog.remove(req)
            req.stream._finish("cancelled")
            return None
        page = self.cfg.page_size
        n_alloc = _ceil_div(req.extent, page)
        hashes, k_use, hit_pages = self._prefix_lookup(req)
        need_new = n_alloc - k_use
        if need_new > len(self._free_pages):
            if self._prefix_cache is not None:
                self._free_pages.extend(self._prefix_cache.evict(
                    need_new - len(self._free_pages)))
            if need_new > len(self._free_pages):
                if k_use:
                    self._prefix_cache.release(hashes[:k_use])
                return False
        self._backlog.remove(req)
        req.slot = self._free_slots.pop()
        req.pages = hit_pages + [self._free_pages.pop()
                                 for _ in range(need_new)]
        req.cache_refs = list(hashes[:k_use])
        req.cache_pages = set(hit_pages)
        start_tok = k_use * page
        req.proj_pos = len(req.prompt_ids)
        req.pf_pos = start_tok
        if self._prefix_cache is not None:
            st = self._prefix_cache.stats
            st.lookups += 1
            st.lookup_tokens += len(req.prompt_ids)
            if start_tok:
                st.hits += 1
                st.hit_tokens += start_tok
        row = np.zeros((self._row_pages,), np.int32)
        row[:n_alloc] = req.pages
        seen0 = None
        if start_tok:
            # The cached tokens' seen mask, built on the host and seeded
            # into the first chunk.
            mask = np.zeros((self.model_cfg.vocab_size,), bool)
            mask[np.asarray(req.prompt_ids[:start_tok], np.int64)] = True
            seen0 = pack_mask_np(mask)
        req.pf = {"row": row, "start_tok": start_tok, "hashes": hashes,
                  "k_use": k_use, "seen0": seen0, "dispatch_s": 0.0,
                  "seed": ((self.cfg.seed << 32)
                           ^ (next(self._step_counter) << 16)
                           ^ req.params.random_seed)}
        # The queue wait, and the slack left at admission after the
        # modeled prefill of the uncached suffix (clamped at 0).
        now = time.monotonic()
        qwait = now - req.stream.submit_time
        record_stage("engine_admit_pickup", qwait)
        if req.deadline_t is not None:
            slack = (req.deadline_t - now) - self._sched.cost.prefill_s(
                len(req.prompt_ids) - start_tok)
            record_stage("sched_slack", max(slack, 0.0))
        tl = req.stream.timeline
        if tl is not None:
            tl.stage("engine_admit_pickup", qwait)
            tl.annotate(slot=req.slot, pages_held=len(req.pages),
                        prefix_hit_tokens=start_tok)
        self._slots[req.slot] = req
        self._bump("prefills")
        return True

    def _abort_prefill(self, req: _Request, finish: str) -> None:
        """Retire a request between chunks (cancelled, or past its
        deadline): its slot was never armed on the device, so only the
        host bookkeeping goes; its pages and prefix-cache refs return. Its
        earlier chunks' round records complete at the flush posted here,
        as no output of the request will follow them."""
        req.pf = None
        self._retire(req, finish)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._post(("flush", {}, event, 0, None))

    def _advance_prefill(self, req: _Request, grant: int) -> int:
        """Admission, second half, once per round: run one prefill program
        for up to ``grant`` prompt tokens. A cold prompt that fits its
        grant keeps the one-program admission (``_admit_body``); otherwise
        a chunk padded to its bucket runs (``_chunk_extend_body``, or
        ``_chunk_final_body`` for the prompt's last tokens, which arms the
        slot). Returns the prompt tokens prefilled."""
        pf = req.pf
        if req.pf_pos > pf["start_tok"]:
            # Between chunks only: a started admission's first program
            # runs, and the harvest notices a cancel or a deadline at the
            # first token.
            if req.stream.cancelled:
                self._abort_prefill(req, "cancelled")
                return 0
            if req.deadline_t is not None \
                    and time.monotonic() > req.deadline_t:
                self._bump("deadline_stops")
                self._abort_prefill(req, "deadline")
                return 0
        total, page = len(req.prompt_ids), self.cfg.page_size
        n = min(grant, total - req.pf_pos, self._buckets[-1])
        final = req.pf_pos + n >= total
        if not final:
            n = (n // page) * page
            if n <= 0:
                return 0
        C = self._bucket_for(n)
        seeding = req.pf_pos == pf["start_tok"] and pf["seen0"] is not None
        self._stage_admission(req, req.pf_pos, n, C,
                              pf["seen0"] if seeding else None)
        if final:
            self._admit_gen.manual_seed(pf["seed"])
        t0 = time.monotonic()
        if final and req.pf_pos == 0:
            self._replay(self._admit_graphs, self._admit_body, C, req.greedy)
        elif final:
            self._replay(self._final_graphs, self._chunk_final_body, C,
                         req.greedy, seeding)
            self._bump("prefill_chunks")
        else:
            mode = ("seed" if seeding else
                    "replace" if req.pf_pos == 0 else "accum")
            self._replay(self._extend_graphs, self._chunk_extend_body, C,
                         mode)
            self._bump("prefill_chunks")
        pf["dispatch_s"] += time.monotonic() - t0
        self._bump("prefill_dispatches")
        req.pf_pos += n
        if final:
            self._arm_slot(req)
        return n

    def _replay(self, table: dict, body, *key) -> None:
        """Run one device program: with graphs on, the replay of the
        capture ``table`` keeps under ``key`` (a missing one raises), else
        ``body(*key)`` eagerly."""
        if self._graphs_on:
            table[key].replay()
        else:
            body(*key)

    def _arm_slot(self, req: _Request) -> None:
        """Prefill complete: publish the prompt's blocks to the prefix
        cache and mark the slot armed for the decode rounds (its first
        token is read after the round's dispatches)."""
        pf = req.pf
        self._register_prefix(req, pf["hashes"], pf["k_use"])
        # The host's dispatch time over every program of the admission.
        record_stage("engine_admit_dispatch", pf["dispatch_s"])
        if req.stream.timeline is not None:
            req.stream.timeline.stage("engine_admit_dispatch",
                                      pf["dispatch_s"])
        req.pf = None
        req.prefill_done = True

    def _stage_admission(self, req: _Request, start: int, n: int, C: int,
                         seen0: Optional[np.ndarray]) -> None:
        """Write a prefill program's inputs (the prompt's tokens
        [start, start + n) padded to ``C``, the page row, the sampling
        inputs, the cached prefix's seen words) into the host staging
        arrays and copy them to the device (``_admission_views``)."""
        h, sp = self._admit_host, req.params
        h["tokens"][:n] = req.prompt_ids[start:start + n]
        h["tokens"][n:C] = 0
        h["row"][:] = req.pf["row"]
        h["bad_seq"][:] = req.bad_seq_np
        h["bad_len"][:] = req.bad_len_np
        h["banned"][:] = req.banned_np
        h["seen0"][:] = 0 if seen0 is None else seen0
        h["length"][0] = start + n
        h["start"][0] = start
        h["slot"][0] = req.slot
        h["top_k"][0] = sp.top_k
        h["remaining"][0] = req.eff_max - 1
        h["eos_ok"][0] = not sp.ignore_eos
        h["temp"][0] = sp.temperature
        h["top_p"][0] = sp.top_p
        h["rep_pen"][0] = sp.repetition_penalty
        self._copy_admission_inputs()

    def _copy_admission_inputs(self) -> None:
        """Host staging arrays -> state["admit"], in place."""
        for name, arr in self._admit_arrays.items():
            self._host_to_device(self._state["admit"][name], arr)

    def _host_to_device(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into device state, in place. On the card it
        goes through a fresh pinned buffer, asynchronously (a copy from
        pageable memory would wait for every round in flight); the caching
        host allocator keeps that buffer until the copy has run, so each
        program in flight keeps its own source."""
        src = torch.from_numpy(arr)
        if self.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _dispatch_round(self, steps: int, rec=None) -> None:
        """Run one ``steps``-step decode round over the armed slots, start
        its tokens' copy to the host and post it for the harvest. Under
        the fused tail the armed slots, sorted and padded with B, are
        staged into ``act_idx`` first, and the round samples the smallest
        rung of rows that holds them. Every slot active on the device
        when the round runs is armed: a chunk program that arms a slot in
        this serve step runs after the round. ``rec`` gets the round's
        slots, the pages its steps read and its estimated bytes: the
        weights once per step, and each slot's live pages (at its host
        position bound before the round) per step."""
        members = self._armed()
        greedy = all(r.greedy for r in members.values())
        B = self.cfg.max_slots
        ba = self._ba_for(len(members))
        if self.cfg.fused_tail:
            act = np.full((B,), B, np.int32)
            act[:len(members)] = sorted(members)
            self._host_to_device(self._state["act_idx"], act)
        toks = self._decode_round(steps, greedy, ba)
        buf = self._ring.copy(toks, self._alive)
        if rec is not None:
            page = self.cfg.page_size
            pages = sum(_ceil_div(r.proj_pos + 1, page)
                        for r in members.values())
            rec.decode_slots = len(members)
            rec.pages_touched += pages * steps
            rec.hbm_bytes += steps * (
                self._param_bytes + pages * page * self._kv_bytes_per_token())
        for req in members.values():
            req.proj_pos = min(req.proj_pos + steps, req.extent - 1)
        with self._pipe_lock:
            self._inflight_rounds += 1
            depth = self._inflight_rounds
        with self._stats_lock:
            self._stats["dispatch_depth_peak"] = max(
                self._stats["dispatch_depth_peak"], depth)
        self._post(("round", members, buf, steps, rec))
        self._chunk_behind = False
        self._bump("decode_rounds")
        self._bump("decode_steps", steps)
        if self.cfg.fused_tail:
            self._bump("sampler_rows_sampled", ba * steps)
            self._bump("sampler_rows_skipped", (B - ba) * steps)

    def _emit_token(self, req: _Request, token: int, now: float) -> None:
        """Deliver one generated token, read back at host time ``now``
        (on the harvest thread, or the serve thread without one); finish
        the stream when the request ends and post it for the serve thread
        to retire. The finish rule mirrors the device-side termination, so
        host and device agree on each slot's last token."""
        req.generated += 1
        req.stream.token_ids.append(token)
        req.stream.token_times.append(now)
        self._bump("tokens_generated")
        if req.stream.first_token_time is None:
            req.stream.first_token_time = now
            ttft = now - req.stream.submit_time
            record_stage("engine_ttft", ttft)
            if req.stream.timeline is not None:
                req.stream.timeline.stage("engine_ttft", ttft)
        finish: Optional[str] = None
        if token == self.tokenizer.eos_id and not req.params.ignore_eos:
            finish = "eos"
        elif req.generated >= req.eff_max:
            finish = "length"
        if req.stream.cancelled and finish is None:
            finish = "cancelled"
        elif (finish is None and req.deadline_t is not None
                and time.monotonic() > req.deadline_t):
            # Past the deadline mid-generation: the tokens delivered stand,
            # this one's text is not emitted, and the request retires like
            # a host-detected finish.
            finish = "deadline"
            self._bump("deadline_stops")
        elif finish != "eos":  # the eos token itself is not emitted as text
            req.stream._put_chunk(req.stop.feed(req.detok.push(token)))
            if req.stop.stopped:
                finish = "stop"
        if finish is not None:
            if finish in ("eos", "length"):
                # Text still held back: the detokenizer's incomplete
                # fragment and any potential stop-word prefix.
                req.stream._put_chunk(req.stop.feed(req.detok.flush()))
                req.stream._put_chunk(req.stop.flush())
                if req.stop.stopped and finish == "length":
                    finish = "stop"
            req.stream._finish(finish)
            self._completed.put(req)

    def _release(self, req: _Request) -> None:
        """Deactivate a finished request's slot on the device (a
        host-detected finish such as a stop word leaves it live there),
        then return its slot and pages. The flag is filled in place: an
        assignment of a Python value would copy it from pageable host
        memory, which waits for every round in flight."""
        self._state["active"][req.slot].fill_(False)
        self._retire(req, req.stream.finish_reason or "cancelled")

    def _retire(self, req: _Request, finish: str) -> None:
        """Return the slot and the pages the cache does not own, and
        release the request's prefix-cache refs: cached pages stay
        resident, warm for the next request that shares them."""
        del self._slots[req.slot]
        self._free_slots.append(req.slot)
        self._free_pages.extend(p for p in req.pages
                                if p not in req.cache_pages)
        if req.cache_refs:
            self._prefix_cache.release(req.cache_refs)
        req.pages = []
        req.cache_refs = []
        req.cache_pages = set()
        if not req.done:
            req.stream._finish(finish)
