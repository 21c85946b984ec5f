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
- **Fused RAG.** ``enable_fused_rag`` + ``set_rag_corpus`` keep a
  retrieval corpus on the device; ``submit_rag`` admits a question whose
  embedding, top-k, prompt assembly and prefill run as one program
  (``engine/rag_fusion.py``; captured per greedy on the card), charged
  the spec's whole bucket and never split into chunks. The prefix cache
  does not see these prompts; the retrieved rows come back with the
  first token (``TokenStream.source_ids``).
- **Deadlines.** A request may carry an absolute deadline: past it in the
  backlog it is dropped before it takes a slot (finish
  ``deadline_queue``); past it between two prompt chunks, or at a
  harvested token, it stops (finish ``deadline``).

- **Speculative decoding** (``EngineConfig.spec_decode``): prompt-lookup
  drafts (``engine/spec_decode.py``) scored by a verify round of S = K + 1
  positions per slot (``models/llama.py`` ``apply_verify_paged``),
  accepted on the device, captured per (page window, greedy, rung). A
  verify round runs with the pipeline drained; a workload with nothing to
  draft keeps its pipelined classic rounds.
- **Online cost calibration** (``SCHED_ONLINE_CALIB``): pure rounds'
  device times (CUDA events around their programs on the card) move the
  step-cost model, and the round budget follows between rounds.
- **Liveness watchdog** (``ENGINE_WATCHDOG_STALL_S``): work pending and no
  progress for that long flips ``stalled``.
- **Host KV tier** (``KV_HOST_POOL_TOKENS``, ``engine/kv_tier.py``):
  evicted prefix pages are offloaded to pinned host memory, restored at
  admission when cheaper than recompute, and a conversation's chain can
  be suspended to a blob and resumed (``suspend_session`` /
  ``resume_session``). ``submit`` takes a mid-stream resume bound by
  ``engine/resume.py``.
- **Fleet half of the tier** (docs/disaggregation.md, docs/kv-tiering.md):
  ``submit`` fetches a prompt's missing prefix pages from the donor the
  router named (``X-KV-Transfer-From``, bound by the chain server) into
  the host tier, where the priced restore takes them;
  ``export_handoff`` serializes a finished prompt's chain for the push
  to a decode replica. A ``prefill``-role engine (``ENGINE_ROLE``)
  refuses decode-bound requests with ``RoleMismatchError``.

- **Tensor parallelism** (``Engine(..., mesh=)``, ``parallel/``): one
  process per card, each an ``Engine`` over its tp shard of the weights
  and of the pool (kv heads over tp). The leader (global rank 0 of the
  mesh) plans and serves; every program it runs goes first to its
  followers as a header (the program's key and the host writes staged
  since the last one: ``_replay``), and each follower's ``follow`` loop
  applies the writes and runs the same program, so the collectives inside
  meet. The vocab-sharded tail (``fused_unembed_sample_tp``) ends with the
  same tokens on every rank, so no rank reads another's. A vocab that does
  not split in whole mask words downgrades to the materialized tail,
  observably (``downgrades``). On the card a geometry the paged kernel
  cannot take per rank (head counts that do not divide tp) is refused.
  The work that is not a captured program goes to the followers as a
  header of its own: ``score`` (the tp forward over a dense cache), the
  host tier's page gathers and scatters (the leader keeps the one host
  store, of whole-model blocks: each offload or export gathers every
  rank's kv heads into them, each restore broadcasts them and every rank
  takes its heads, so a blob is the one a one-card engine writes and
  moves between topologies), fused RAG's install and corpus (the
  encoder and the corpus replicated on every rank by broadcasts from the
  leader; the leader's retrieved rows broadcast inside the captured
  admission, so every rank assembles the same prompt), and ``prewarm``'s
  attempts (every allocation that may run out is made outside any
  collective and its outcome agreed over the header group, so all ranks
  shrink and rebuild to one page count). A failed collective or an
  out-of-memory error inside one ends the engine (``_fatal``): nothing
  carries on past it.
- **The rest of the serving mesh** (``parallel/mesh.py``): global rank 0
  leads every rank of the mesh, the ``dp``, ``ep`` and ``sp`` replicas
  included, which replay its programs as tp followers do. Under ``ep``
  each rank holds its ``E/ep`` experts (``parallel/moe.py``; attention,
  the pool and the tail as at its tp); ``dp`` replicates. Under ``sp``
  (dp x sp only, as the reference) every rank holds the whole model and
  pool: a one-shot admission is the ring-attention prefill
  (``llama.apply_prefill_sp``), each rank's K/V block gathered over sp
  layer by layer into its pool, so every rank's pool equals one card's;
  a longer prompt's chunks, a prefix hit's and every decode round run
  replicated, as the reference's do. On an sp mesh the prefill programs
  (ring or chunk) run eagerly on every rank, by design: they are the
  long-context programs, whose launches are a vanishing share of their
  time, and a capture would pin each bucket's transients (gigabytes at
  32768 tokens) in the graph pool; the NCCL point-to-point passes of the
  ring stay outside any graph. Decode rounds are captured as always.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import os
import queue
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..models import llama, weight_cache
from ..models.configs import LlamaConfig
from ..obs import flight as obs_flight
from ..obs import rounds as obs_rounds
from ..obs.tracing import record_stage
from ..models.tokenizer import Tokenizer
from ..ops import int4_matmul
from ..ops.fused_sampler import (choose_tile, fused_unembed_sample,
                                 fused_unembed_sample_tp,
                                 fused_verify_sample, fused_verify_sample_tp,
                                 tp_shardable, verify_reference_tiled)
from ..ops.kv_quant import quantize_rows
from ..ops.paged_attention import kernel_supported
from ..ops.quant import is_grouped, is_quantized
from ..parallel import comm
from ..parallel.mesh import Mesh
from ..parallel.sharding import llama_param_specs, shard_params
from ..ops.sampling import (MASK_BITS, NEG_INF, apply_repetition_penalty,
                            mask_words, pack_mask, pack_mask_np, sample,
                            seen_mask, set_token_bits, unpack_mask)
from ..utils import faults
from ..utils.device import resolve_device
from ..utils.errors import (ConfigError, EngineError, RoleMismatchError,
                            SchedulerFullError)
from ..utils.hbm import peak_bw
from ..utils.logging import get_logger, log_event
from . import graphs
from . import kv_tier as kv_tier_mod
from . import resume as engine_resume
from .detokenizer import IncrementalDetokenizer, StopWordTrap
from .kv_tier import KVTier
from .prefix_cache import PrefixCache, hash_blocks, usable_prefix_tokens
from .rag_fusion import FusedRag, FusedRagSpec
from .sampling_params import SamplingParams
from .scheduler import (OnlineCalibrator, PrefillJob, RoundPlan,
                        StepCostModel, TokenBudgetScheduler,
                        online_calib_enabled)
from .spec_decode import (AdaptiveDraftController, PromptLookupDrafter,
                          SpecConfig, spec_enabled)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Disaggregation roles (docs/disaggregation.md).
ROLES = ("unified", "prefill", "decode")

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
    # Speculative decoding (engine/spec_decode.py): draft tokens
    # proposed, drafts the verify rounds accepted, verify rounds run, the
    # tokens they emitted (accepted drafts plus one correction or bonus
    # token per slot) and the slots that rode them.
    "spec_draft_tokens": 0, "spec_accepted_tokens": 0,
    "spec_verify_rounds": 0, "spec_verify_tokens": 0,
    "spec_verify_slot_steps": 0,
    # The host KV tier (engine/kv_tier.py): prefix pages offloaded at
    # eviction, pages restored at admission and the admissions that
    # restored any, restores refused as dearer than recompute, blocks
    # moved through session suspend/resume, and blobs refused as corrupt.
    # All 0 with the tier off (KV_HOST_POOL_TOKENS=0).
    "kv_tier_offload_pages": 0, "kv_tier_restore_pages": 0,
    "kv_tier_restore_hits": 0, "kv_restore_skipped_cost": 0,
    "kv_tier_suspended_blocks": 0, "kv_tier_resumed_blocks": 0,
    "kv_restore_corrupt": 0,
    # The fleet half: pages imported from a sibling replica over
    # /control/kv_pages, finished prefix pages exported for the
    # prefill->decode handoff, and /control/kv_pages exports the chain
    # server shed past KV_EXPORT_CONCURRENCY.
    "kv_tier_transfer_pages": 0, "kv_tier_export_pages": 0,
    "kv_export_shed": 0,
    # Times the liveness watchdog declared the engine stalled.
    "watchdog_stalls": 0,
    # Rounds whose record completed (obs/rounds.py).
    "rounds_completed": 0,
    # Times the online calibrator moved the round budget.
    "sched_budget_recalibrations": 0,
    # Feature downgrades at construction (``Engine.downgrades``): a vocab
    # that does not shard over tp in whole mask words takes the
    # materialized tail. A geometry the kernels do not take is refused on
    # the card (ConfigError) instead of served slower.
    "downgrades": 0,
    # Port-only: decode rounds dispatched, prefill programs run (one-shot
    # admissions, fused-RAG admissions and chunks) and of those the chunk
    # programs and the fused-RAG admissions, and the harvest's
    # milliseconds delivering tokens (detokenize, stop words).
    "decode_rounds": 0, "prefill_dispatches": 0, "prefill_chunks": 0,
    "rag_admissions": 0, "harvest_emit_ms": 0.0,
}

# Keys ``Engine.stats`` adds when it is read (the prefix cache's keys only
# while the cache is on).
_STATS_READ_TIME = ("dispatch_queue_depth", "queue_waiting",
                    "sched_prefill_share", "spec_acceptance_rate",
                    "spec_tokens_per_step", "sched_cost_drift_ratio",
                    "kv_tier_host_pages", "kv_restore_hit_rate",
                    "uptime_s", "active_slots", "free_pages", "pool_pages")


def engine_stat_keys() -> tuple[str, ...]:
    """Every key an ``Engine.stats`` snapshot can hold: the template, the
    read-time gauges and the prefix cache's counters (on by default).
    ``/metrics`` mirrors each as an ``engine_*`` gauge."""
    from .prefix_cache import CacheStats
    return (tuple(_STATS_TEMPLATE) + _STATS_READ_TIME
            + tuple(CacheStats().snapshot()) + ("prefix_cache_pages",))


class _AgreedOOM(torch.cuda.OutOfMemoryError):
    """An out-of-memory error every tensor-parallel rank raised together
    (``Engine._agreed``): the group is still in step."""


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


def _pow2_ladder(top: int) -> tuple[int, ...]:
    """(1, 2, 4, ..., top): the verify round's page windows."""
    ladder, w = [], 1
    while w < top:
        ladder.append(w)
        w *= 2
    return tuple(ladder + [top])


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
    # Speculative decoding (engine/spec_decode.py): prompt-lookup drafts
    # scored by one verify round of S = K + 1 positions per slot. Greedy
    # output equals the plain engine's; sampled output keeps its
    # distribution. ENGINE_SPEC_DECODE beats ``spec_decode``;
    # SPEC_MAX_DRAFT_TOKENS beats ``spec_max_draft_tokens`` (K).
    spec_decode: bool = False
    spec_max_draft_tokens: Optional[int] = None
    # The host KV tier (engine/kv_tier.py), in tokens of host RAM for
    # offloaded prefix pages; KV_HOST_POOL_TOKENS beats it, None defers to
    # the env, 0 turns the tier off.
    kv_host_pool_tokens: Optional[int] = None
    # Disaggregation role (docs/disaggregation.md): "unified" serves
    # everything; "prefill" refuses requests wanting more than
    # ROLE_PREFILL_MAX_TOKENS output tokens (RoleMismatchError) and
    # exports finished prefix pages to decode siblings; "decode"
    # advertises itself for decode-bound placement (the router enforces
    # it). ENGINE_ROLE beats this field.
    role: str = "unified"

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
        if self.kv_host_pool_tokens is not None \
                and self.kv_host_pool_tokens < 0:
            raise ConfigError(
                f"kv_host_pool_tokens={self.kv_host_pool_tokens} must be "
                f">= 0 (0 turns the host KV tier off)")
        if self.spec_max_draft_tokens is not None \
                and self.spec_max_draft_tokens < 1:
            raise ConfigError(
                f"spec_max_draft_tokens={self.spec_max_draft_tokens} must "
                f"be >= 1 (it sizes the verify round's K+1 positions)")
        if self.role not in ROLES:
            raise ConfigError(
                f"role={self.role!r} not supported; use 'unified', "
                f"'prefill', or 'decode' (docs/disaggregation.md)")

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
        # Fused-RAG requests: the corpus rows the retrieval on the device
        # picked and the length of the prompt it assembled, read back
        # with the first token.
        self.source_ids: list[int] = []
        self.rag_length: Optional[int] = None

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
    # The prompt's length on the device: its token count, or the spec's
    # bucket for a fused-RAG request (assembled on the device).
    base_len: int = 0
    # Fused-RAG payload: (q_llm (q_bucket,) int32, question length,
    # q_enc (2, enc_bucket) int32); its admission runs the fused program.
    rag: Optional[tuple] = None
    # Speculative decoding: the request's prompt-lookup index over prompt
    # and generated tokens, and its draft-length controller.
    drafter: Optional[PromptLookupDrafter] = None
    spec_ctrl: Optional[AdaptiveDraftController] = None
    # A mid-stream resume: how many trailing prompt ids are replayed
    # generated tokens (engine/resume.py); None otherwise. Pins the
    # admission's sampling seed to the replay offset.
    resume_offset: Optional[int] = None
    # The fused admission's [first, length, top_ids] copy to the host: a
    # pinned buffer and the event recorded after the copy.
    rag_aux: Optional[tuple] = None

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


def _mixed_float_leaves(params: llama.Params, dtype: torch.dtype
                        ) -> list[str]:
    """The raw floating-point leaves of ``params`` whose dtype is not
    ``dtype`` (a QLoRA merge's float32 projections beside bf16 leaves).
    Quantized dict leaves keep float32 scales by design and are not
    looked at."""
    flat = [(k, v) for k, v in params.items() if k != "layers"]
    flat += [(f"layers/{k}", v) for k, v in params["layers"].items()]
    return sorted(k for k, v in flat if isinstance(v, torch.Tensor)
                  and v.is_floating_point() and v.dtype != dtype)


def _whole_tree(params: llama.Params, cfg: LlamaConfig, mesh: Mesh) -> bool:
    """Whether ``params`` is the whole model's tree where ``mesh`` splits
    it: the embedding's every vocab row under tp, every expert under
    ep."""
    if comm.sharded(mesh) and params["embed"].shape[0] == cfg.vocab_size:
        return True
    if mesh.shape.get("ep", 1) > 1 and cfg.num_experts:
        return params["layers"]["w_gate"].shape[1] == cfg.num_experts
    return False


class Engine:
    """Continuous-batching engine over one model on one device, or on one
    rank of a serving mesh (``mesh``: module docstring)."""

    # Device-side multi-token bad-words table: up to MAX_BAD_SEQS
    # sequences per request, each up to MAX_BAD_LEN tokens.
    MAX_BAD_SEQS = 8
    MAX_BAD_LEN = 8

    def __init__(self, params: llama.Params, model_cfg: LlamaConfig,
                 tokenizer: Tokenizer, cfg: EngineConfig = EngineConfig(),
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        llama.check_supported(model_cfg)
        self.device = resolve_device(device)
        self._dtype = _DTYPES[cfg.dtype]
        self.mesh = mesh
        # tp splits the model; ``_multi``: other ranks follow this one.
        self._sharded = comm.sharded(mesh)
        self._multi = comm.distributed(mesh)
        self._sp = mesh is not None and mesh.shape.get("sp", 1) > 1
        # Construction-time feature downgrades, observable (``downgrades``).
        self._downgrades: list[dict] = []
        self._check_topology(model_cfg)
        if mesh is not None and _whole_tree(params, model_cfg, mesh):
            # A whole tree: keep this rank's shard of it.
            params = shard_params(params, mesh,
                                  llama_param_specs(model_cfg, mesh))
        self._tpl = llama.tp_layout(model_cfg, mesh)
        # The rank's own geometry: its query and kv heads, F and V shards.
        self._local_cfg = self._tpl.cfg
        # The leader plans and serves; a follower replays its programs.
        self.leader = mesh is None or mesh.leader
        # Host writes and admission seeds staged since the leader's last
        # program, sent ahead of the next one (``_replay``); recorded only
        # once construction is done (a follower constructs alike).
        self._ops: list[tuple] = []
        self._recording = False
        embed = params["embed"]
        if embed.device.type != self.device.type or embed.dtype != self._dtype:
            raise ConfigError(
                f"params are {embed.dtype} on {embed.device}; the engine "
                f"runs {self._dtype} on {self.device}")
        mixed = _mixed_float_leaves(params, self._dtype)
        if mixed:
            raise ConfigError(
                f"raw leaves {mixed} are not {self._dtype}, the engine's "
                f"dtype (its captured programs take one activation dtype); "
                f"cast them first, e.g. lora.merge_lora(..., dtype=)")
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
        if self._sp:
            # The ring prefill shards each bucket over sp: a bucket that
            # does not split fails here, not at its first admission.
            for b in self._buckets:
                try:
                    llama.validate_sp_mesh(mesh, b, "sp serving prefill")
                except ValueError as exc:
                    raise ConfigError(str(exc)) from exc
        # A chunk's padded span starts on a prompt page and runs at most
        # one largest bucket: the staged page row covers it (pages past
        # the extent map to the trash page 0). The prefix a chunk attends
        # lies before its start, inside the prompt's pages.
        self._row_pages = self._pmax + self._buckets[-1] // page
        self._prefix_pages = _ceil_div(cfg.max_input_length, page)
        V, B = model_cfg.vocab_size, cfg.max_slots
        # The tail: fused (streamed vocab tiles), sharded over the vocab
        # under tp, or materialized. A vocab that does not shard in whole
        # mask words downgrades to the materialized tail, observably.
        self._tail_fused = cfg.fused_tail
        self._tail_sharded = False
        if self._tail_fused and self._sharded:
            if tp_shardable(V, mesh.tp):
                self._tail_sharded = True
            else:
                self._tail_fused = False
                self._note_downgrade(
                    "fused_sampler", "materialized_tail",
                    f"vocab_size={V} does not split over tp={mesh.tp} "
                    f"into whole {MASK_BITS}-token mask words")
        self._sampler_tile = choose_tile(
            V // mesh.tp if self._tail_sharded else V,
            cfg.sampler_tile or (CARD_TILE if self.device.type == "cuda"
                                 else None))
        if self.device.type == "cuda":
            self._check_kernel_geometry()
        if (cfg.sampler_tile is not None and V % MASK_BITS == 0
                and not self._tail_sharded and self._sampler_tile == V):
            raise ConfigError(
                f"sampler_tile={cfg.sampler_tile} streams the {V}-token "
                f"vocab as one tile: the materialized tail is "
                f"fused_tail=False")
        # The fused tail's active-row ladder (the reference's two rungs):
        # a round samples 1 row for one stream, else all B.
        self._ba_ladder = (1, B) if self._tail_fused and B > 1 else (B,)
        # Speculative decoding: S = K + 1 positions per slot in a verify
        # round, captured per (page window, greedy, rung); the window is
        # the power-of-two page ladder up to the table's width (the verify
        # attention gathers its window, so it pays for the pages it
        # covers). The drafts planned for this step (serve thread only).
        self._spec: Optional[SpecConfig] = (
            SpecConfig.resolve(cfg.spec_max_draft_tokens)
            if spec_enabled(cfg.spec_decode) else None)
        self._spec_S = self._spec.max_draft_tokens + 1 if self._spec else 0
        self._windows = _pow2_ladder(self._pmax)
        self._draft_plan: Optional[dict] = None
        # Rows of the static token grid a program writes: a decode round's
        # steps, or a verify round's S emitted rows plus its accepted
        # counts.
        self._grid_rows = max(cfg.steps_per_round, self._spec_S + 1
                              if self._spec else 0)
        # The host KV tier (KV_HOST_POOL_TOKENS beats the config field;
        # off without the prefix cache, whose hashes address it).
        env_host = os.environ.get("KV_HOST_POOL_TOKENS", "")
        host_tokens = (int(env_host) if env_host
                       else (cfg.kv_host_pool_tokens or 0))
        self._kv_tier: Optional[KVTier] = None
        if cfg.prefix_cache and host_tokens > 0:
            # Under tp the leader's store holds whole-model blocks: the
            # geometry and the bytes are the model's.
            m = model_cfg
            self._kv_tier = KVTier(
                page_size=page, host_pool_tokens=host_tokens,
                bytes_per_token=self._kv_bytes_per_token(local=False),
                meta={"kv_quant": cfg.kv_quant, "num_layers": m.num_layers,
                      "num_kv_heads": m.num_kv_heads,
                      "head_dim": m.head_dim, "dtype": cfg.dtype},
                transfer_max_pages=int(os.environ.get(
                    "KV_TRANSFER_MAX_PAGES", "32") or 32),
                transfer_timeout_s=float(os.environ.get(
                    "KV_TRANSFER_TIMEOUT_S", "5") or 5))
        # Disaggregation role: ENGINE_ROLE beats the config. A
        # prefill-role engine refuses, at submit, requests wanting more
        # than ROLE_PREFILL_MAX_TOKENS output tokens: its device belongs
        # to prefills; decode rounds run on the decode replicas.
        env_role = (os.environ.get("ENGINE_ROLE", "") or "").strip().lower()
        if env_role and env_role not in ROLES:
            raise ConfigError(
                f"ENGINE_ROLE={env_role!r} not supported; use 'unified', "
                f"'prefill', or 'decode' (docs/disaggregation.md)")
        self.role: str = env_role or cfg.role
        self._role_prefill_max_tokens = max(1, int(os.environ.get(
            "ROLE_PREFILL_MAX_TOKENS", "4") or 4))
        # Restores' timings not yet read ((pages, start event, end
        # event)), the step's [start, end] events around its programs on
        # the card (``_replay``), the side stream offloads copy on, and the
        # online calibrator (``_build_device``).
        self._io_pending: list[tuple] = []
        self._span: Optional[list] = None
        self._io_stream: Optional[torch.cuda.Stream] = None
        self._calib: Optional[OnlineCalibrator] = None

        # Fused RAG (``enable_fused_rag``): the corpus and encoder, the
        # captured programs per greedy, the question inputs staged on the
        # device (host array, device tensor) and the aux row read back.
        self._fused_rag: Optional[FusedRag] = None
        self._rag_graphs: dict[tuple[bool], graphs.Program] = {}
        self._rag_in: Optional[tuple[np.ndarray, torch.Tensor]] = None
        self._rag_aux: Optional[torch.Tensor] = None
        # Work handed to the serve thread, run between two steps.
        self._control: "queue.Queue[tuple]" = queue.Queue()
        self._pool_reserve: Optional[int] = None   # "auto" sizing's reserve
        # The side stream the programs are captured on, kept across a
        # rebuild: cuBLAS's workspace and the kernels' scratch are keyed
        # by stream, and a new stream would hold a second set.
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # The memory pool every captured program shares (``_prewarm``), and
        # what the fused-RAG programs added to the reserved memory.
        self._graph_pool = None
        self.rag_graph_bytes = 0
        # A follower's slack during a prewarm attempt (``_hold_slack``),
        # and the checkpoint load's report (``model_server``), gathered
        # with the launch counts (``rank_reports``).
        self._slack = None
        self.load_report: dict = {}
        self._n_pages = 1 + self._resolve_pool_pages()
        # NCCL's communicator exists before any program captures on it.
        comm.warm_up(mesh, self.device)
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
        # Weight bytes a forward streams: every leaf but an untied
        # embedding table, of which a step gathers only its tokens' rows
        # (Nemotron's 256000-row table is 2.1 GB of its 17.1).
        self._param_bytes = sum(
            t.numel() * t.element_size() for k, v in params.items()
            if k != "embed" or "lm_head" not in params
            for t in llama.param_tensors(v))
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
                               (self._grid_rows, cfg.max_slots),
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
        # Liveness watchdog (ENGINE_WATCHDOG_STALL_S, 0 = off): work
        # queued or in flight while no progress counter moves for that
        # long flips ``stalled`` (the chain server's /health answers 503)
        # and logs every thread's stack.
        self._watchdog_stall_s = float(os.environ.get(
            "ENGINE_WATCHDOG_STALL_S", "0") or 0)
        self._watchdog_thread: Optional[threading.Thread] = None
        self._stalled = False
        self._recording = self._multi and self.leader
        self._closing = False
        with self._stats_lock:
            self._stats["downgrades"] = len(self._downgrades)

    # ------------------------------------------------- tensor parallelism

    def _check_topology(self, model_cfg: LlamaConfig) -> None:
        """The reference's topology gates, and the port's own: serving
        shards over dp, ep, sp and tp, never pp (pipeline stages would
        idle 1/pp of every round); sp composes with dp only, with the
        reference's message (each bucket's split is checked once the
        buckets exist); experts must split over ep; on the card the paged
        kernel runs on each rank's heads, so head counts that do not
        divide tp are refused (the reference falls back to its gather
        path there); the mesh's device is the engine's."""
        mesh = self.mesh
        if mesh is None:
            return
        pp = int(mesh.shape.get("pp", 1))
        if pp > 1:
            raise ConfigError(
                f"serving requires pp == 1 (mesh has pp={pp}): the decode "
                f"engine dispatches all layers as one program per round, "
                f"so pipeline stages would idle 1/pp of every round; shard "
                f"serving over tp/sp instead (pp is training-only)")
        n_sp = int(mesh.shape.get("sp", 1))
        if n_sp > 1:
            try:
                llama.validate_sp_mesh(mesh, n_sp, "sp serving prefill")
            except ValueError as exc:
                raise ConfigError(str(exc)) from exc
        ep = int(mesh.shape.get("ep", 1))
        if model_cfg.num_experts and model_cfg.num_experts % ep:
            raise ConfigError(f"num_experts={model_cfg.num_experts} does "
                              f"not split over ep={ep}")
        if mesh.device.type != self.device.type:
            raise ConfigError(f"the mesh runs on {mesh.device}, the engine "
                              f"on {self.device}")
        if (self.device.type == "cuda"
                and not llama.kernel_tp_compatible(model_cfg, mesh)):
            raise ConfigError(
                f"the paged decode kernel cannot run on each rank's shard: "
                f"heads {model_cfg.num_heads}/{model_cfg.num_kv_heads} must "
                f"divide tp={mesh.shape.get('tp', 1)}; the card refuses "
                f"the plain gather path the reference falls back to")

    def _note_downgrade(self, feature: str, fallback: str,
                        reason: str) -> None:
        """Record a construction-time feature downgrade observably: one
        structured ``engine_feature_downgrade`` event and the
        ``downgrades`` stat (the reference's ``_note_downgrade``)."""
        self._downgrades.append({"feature": feature, "fallback": fallback,
                                 "reason": reason})
        log_event(logger, "engine_feature_downgrade", feature=feature,
                  fallback=fallback, reason=reason)

    @property
    def downgrades(self) -> list[dict]:
        """The construction-time downgrades, each ``{feature, fallback,
        reason}``."""
        return [dict(d) for d in self._downgrades]

    def _program_table(self, body_name: str) -> Optional[dict]:
        """The captured programs a header names by their body (None: a
        prefill program of an sp mesh, which runs eagerly: module
        docstring)."""
        if self._sp and body_name in self._PREFILL_BODIES:
            return None
        return {"_admit_body": self._admit_graphs,
                "_chunk_extend_body": self._extend_graphs,
                "_chunk_final_body": self._final_graphs,
                "_round_body": self._round_graphs,
                "_verify_body": self._verify_graphs,
                "_rag_body": self._rag_graphs}[body_name]

    def _state_name(self, dst: torch.Tensor) -> str:
        """The name a follower finds ``dst`` under: a slot-state tensor's
        key, or ``admit/<key>``."""
        for key, t in self._state.items():
            if t is dst:
                return key
        for key, t in self._state["admit"].items():
            if t is dst:
                return f"admit/{key}"
        if self._rag_in is not None and dst is self._rag_in[1]:
            return "rag_in"
        raise EngineError("a host write to an unnamed device tensor")

    def _state_tensor(self, name: str) -> torch.Tensor:
        if name.startswith("admit/"):
            return self._state["admit"][name[len("admit/"):]]
        if name == "rag_in":
            return self._rag_in[1]
        return self._state[name]

    def _apply_op(self, op: tuple) -> None:
        """One staged host write, on a follower as on its leader."""
        kind = op[0]
        if kind == "copy":
            self._host_to_device(self._state_tensor(op[1]), op[2])
        elif kind == "deactivate":
            self._state["active"][op[1]].fill_(False)
        elif kind == "admit_seed":
            self._admit_gen.manual_seed(op[1])
        else:
            raise EngineError(f"unknown staged write {kind!r}")

    def follow(self) -> None:
        """A follower's loop: take each header from the leader and do what
        it names, until the leader closes (returns): a program (its staged
        writes, then its replay), a rebuild at the leader's page count, a
        score, the tier's page gather or scatter, fused RAG's install,
        corpus or capture, a prewarm's slack, a report. An error
        propagates: the caller ends the process, and the group with it;
        only a prewarm attempt's out-of-memory error that every rank
        agreed on (``_AgreedOOM``) leaves the loop running, since the
        leader then shrinks the pool and rebuilds."""
        if self.leader:
            raise EngineError("follow() runs on a follower rank")
        while True:
            header = comm.receive_header(self.mesh)
            kind = header[0]
            if kind == "close":
                return
            if kind == "run":
                _, body_name, key, ops = header
                for op in ops:
                    self._apply_op(op)
                self._replay(self._program_table(body_name),
                             getattr(self, body_name), *key)
                continue
            try:
                self._follow_control(kind, header[1:])
            except _AgreedOOM:
                # Every rank failed the step together; the leader shrinks
                # the pool and sends the next rebuild.
                self._slack = None
                self._drop_device_state()

    def _follow_control(self, kind: str, args: tuple) -> None:
        """A follower's side of one non-program header."""
        if kind == "rebuild":
            self._n_pages = args[0]
            self._rebuild()
        elif kind == "report":
            comm.gather_to_leader(self._report(), self.mesh)
        elif kind == "score":
            self._score(*args)
        elif kind == "gather":
            self._gather_pages(args[0])
        elif kind == "scatter":
            self._scatter_pages(args[0], None)
        elif kind == "rag_enable":
            enc_cfg, spec, leaves = args
            self._install_rag(weight_cache.unflatten({
                name: torch.empty(shape, dtype=dtype, device=self.device)
                for name, shape, dtype in leaves}), enc_cfg, spec)
        elif kind == "rag_corpus":
            n, width = args
            C = self._fused_rag.spec.chunk_tokens
            self._set_corpus(np.zeros((n, width), np.float32),
                             np.zeros((n, C), np.int32),
                             np.zeros((n,), np.int32))
        elif kind == "rag_capture":
            self._capture_rag()
        elif kind == "slack":
            self._slack = self._agreed(self._alloc_slack)
        elif kind == "slack_done":
            self._slack = None
        else:
            raise EngineError(f"unknown header {kind!r}")

    # The prefill programs: eager on an sp mesh (module docstring).
    _PREFILL_BODIES = ("_admit_body", "_chunk_extend_body",
                       "_chunk_final_body")

    def _broadcast(self, header: tuple) -> None:
        if self._recording:
            comm.broadcast_header(header, self.mesh)

    @contextlib.contextmanager
    def _collective(self):
        """Around work that holds collectives outside a captured program:
        under tp a failure in it ends the engine (``_fatal``), since the
        other ranks may be waiting inside a collective it never reached."""
        try:
            yield
        except BaseException as exc:
            if self._multi:
                self._fatal = exc
            raise

    def _agreed(self, step):
        """Run the allocation ``step`` (no collective inside) and return
        its result; under tp every rank runs it at the same point and
        they agree on its outcome (``comm.agree``) before anything else,
        so when one rank runs out of memory all of them raise
        ``_AgreedOOM`` instead of one rank missing a collective the others
        wait in."""
        err = None
        try:
            out = step()
        except torch.cuda.OutOfMemoryError as exc:
            err, out = exc, None
        if self._multi:
            if not comm.agree(err is None, self.mesh):
                _drop_tracebacks(err)
                raise _AgreedOOM(
                    f"a tensor-parallel rank ran out of device memory: "
                    f"{err or 'another rank'}")
        elif err is not None:
            raise err
        return out

    def _report(self) -> dict:
        return {"launch_counts": graphs.launch_counts(),
                "load": dict(self.load_report),
                "pool_pages": self._n_pages - 1}

    def rank_reports(self) -> list[dict]:
        """Each rank's report in rank order: its kernel launch counters
        (``engine/graphs.py`` ``launch_counts``), its checkpoint load
        report (``load_report``) and its pool's pages; under tp every
        follower's, gathered on the serve thread between two programs."""
        if not self._recording:
            return [self._report()]

        def gather() -> list[dict]:
            comm.broadcast_header(("report",), self.mesh)
            return comm.gather_to_leader(self._report(), self.mesh)
        return self._on_serve_thread(gather)

    # ------------------------------------------------------------ scoring

    def score(self, token_ids: Sequence[int], chunk: int = 2048
              ) -> np.ndarray:
        """Per-token NLL of ``token_ids`` (``llama.score``) as float64 on
        the host. On one card it runs on the calling thread, beside the
        serve loop. Under tp every rank runs the tp forward with the same
        tokens, so it runs on the serve thread between two programs, after
        a header of its own to the followers; an out-of-memory error there
        ends the engine (the followers may wait in a collective)."""
        ids = [int(t) for t in token_ids]
        if not self._multi:
            return self._score(ids, chunk)

        def run() -> np.ndarray:
            self._broadcast(("score", ids, chunk))
            with self._collective():
                return self._score(ids, chunk)
        self._alive()
        try:
            return self._on_serve_thread(run)
        except torch.cuda.OutOfMemoryError as exc:
            raise EngineError(f"scoring ran out of device memory on the "
                              f"mesh {self.mesh.shape}: the engine is "
                              f"down") from exc

    @torch.no_grad()
    def _score(self, ids: list, chunk: int) -> np.ndarray:
        tokens = torch.tensor([ids], dtype=torch.int32, device=self.device)
        nll = llama.score(self.params, self.model_cfg, tokens, chunk=chunk,
                          mesh=self.mesh)
        return nll[0].double().cpu().numpy()

    def _build_device(self) -> None:
        """Allocate the pool of ``_n_pages`` pages and the static state,
        capture every program on the card (``_prewarm``) and build the
        scheduler over the step-cost model that gives: the construction
        path, which ``prewarm`` reruns at a smaller pool."""
        cfg = self.cfg
        self._free_pages = list(range(1, self._n_pages))
        self._prefix_cache = (PrefixCache(cfg.page_size) if cfg.prefix_cache
                              else None)
        self._state = self._agreed(self._init_device_state)
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
        self._verify_graphs: dict[tuple[int, bool, int],
                                  graphs.Program] = {}
        self.graph_pool_bytes = 0
        cost = StepCostModel(slots=cfg.max_slots)
        if self._graphs_on:
            cost = self._prewarm()
        self._round_gen.manual_seed(cfg.seed)
        # Online calibration (SCHED_ONLINE_CALIB, default on): the
        # construction-time model is the prior, completed rounds' device
        # times move it.
        self._calib = (OnlineCalibrator(cost) if online_calib_enabled()
                       else None)
        self._sched = TokenBudgetScheduler(
            cost, page_size=cfg.page_size,
            steps_per_round=cfg.steps_per_round,
            round_budget_tokens=cfg.sched_round_budget_tokens,
            chunk_tokens=cfg.sched_prefill_chunk_tokens,
            max_one_shot_tokens=self._buckets[-1], calibrator=self._calib)

    def _check_kernel_geometry(self) -> None:
        """On the card every decode layer launches the paged kernel and
        every int4 projection the int4 kernel: refuse, before any pool is
        allocated, a geometry either kernel does not take, and GPTQ zero
        points (``gbias``) on a product that would not land on a
        tensor-core path ("tc"/"wg", the paths that apply them: bf16
        activations, K and N multiples of 16, groups of a multiple of
        128), the lm_head at the sampler's tile width as well as whole."""
        # A rank's heads under tp have the whole model's group size
        # (``_check_topology``), so the whole model's geometry decides.
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
            K, N = 2 * w["q4"].shape[-2], w["q4"].shape[-1]
            group = K // w["gscale"].shape[-2] if is_grouped(w) else 0
            if not int4_matmul.supported(K, N, group):
                raise ConfigError(f"{name}: the int4 kernel does not take "
                                  f"K={K}, N={N}, group {group}")
            widths = {N, self._sampler_tile} if name == "lm_head" else {N}
            if "gbias" in w and not all(
                    int4_matmul.tensor_cores(K, n, group, self._dtype)
                    for n in widths):
                raise ConfigError(
                    f"{name}: GPTQ zero points (gbias) run on the int4 "
                    f"kernel's tensor-core paths only: bfloat16 "
                    f"activations (the engine runs {self.cfg.dtype}), K and "
                    f"N {sorted(widths)} multiples of 16, groups of a "
                    f"multiple of 128 (K={K}, group {group})")

    # -------------------------------------------------------------- sizing

    def _kv_bytes_per_token(self, pooled: bool = True,
                            local: bool = True) -> int:
        """KV bytes per cached token. ``pooled``: bytes in the page pool
        (int8 rows plus one bf16 scale each under kv_quant); False: the
        dense bytes of a prefill bucket's KV, which stays in the compute
        dtype until the insert quantizes it (sizing the prefill reserve
        with pooled bytes would under-reserve by ~2x under kv_quant).
        Under tp, this rank's kv heads (the whole model's without
        ``local``)."""
        m = self._local_cfg if local else self.model_cfg
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
        if self._multi:
            # Every rank's pool has the same pages: the smallest fit.
            agreed = torch.tensor([pages], device=self.device)
            torch.distributed.all_reduce(
                agreed, op=torch.distributed.ReduceOp.MIN)
            pages = int(agreed.item())
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
                self._local_cfg, self._n_pages, self.cfg.page_size,
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
            "round_tokens": z(self._grid_rows, B),
            "act_idx": z(B),
            # A verify round's drafts and draft counts, staged per round.
            "drafts": z(B, max(1, self._spec_S - 1)),
            "n_draft": z(B),
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
        state["admit"]["i32"]: room for the token ids of the longest prompt
        the cache holds (a fused-RAG bucket may exceed the largest prefill
        bucket, ``_stage_admission`` pads the rest of a bucket), the page
        row (wide enough for a chunk's padded span), the sequence-ban
        table and lengths, then the scalars. ``start`` is a chunk's first
        prompt position (0 for a one-shot admission) and ``length`` the
        prompt tokens valid after it (the chunk's ``kv_valid_len``)."""
        sizes = {"tokens": self._pmax * self.cfg.page_size,
                 "row": self._row_pages,
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
        out["spec_acceptance_rate"] = (
            round(out["spec_accepted_tokens"] / out["spec_draft_tokens"], 4)
            if out["spec_draft_tokens"] else 0.0)
        out["spec_tokens_per_step"] = (
            round(out["spec_verify_tokens"] / out["spec_verify_slot_steps"],
                  4) if out["spec_verify_slot_steps"] else 0.0)
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
        tier = self._kv_tier
        out["kv_tier_host_pages"] = tier.store.pages if tier else 0
        lookups = out.get("prefix_cache_lookups", 0)
        out["kv_restore_hit_rate"] = (
            round(out["kv_tier_restore_hits"] / lookups, 4)
            if lookups else 0.0)
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
        cache = llama.init_kv_cache(self._local_cfg, 1, bucket, self._dtype,
                                    device=dev)
        hn, cache = llama.apply(self.params, mcfg, tokens, positions, cache,
                                kv_valid_len=length, return_hidden=True,
                                mesh=self.mesh)
        # Only the last prompt row is projected (the reference projects
        # every row and takes this one); under tp every rank gathers it
        # whole.
        last = llama.project_logits(
            self.params, hn.index_select(1, (length - 1).long())[:, 0],
            self.mesh)
        return (cache["k"], cache["v"]) + self._first_token(last, tokens,
                                                            greedy)

    def _first_token(self, last: torch.Tensor, tokens: torch.Tensor,
                     greedy: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """The admission's first token from the last prompt row's logits
        ``last`` (1, V) of the staged prompt ``tokens`` (1, S): penalized,
        banned, sampled (or argmax). Returns it ((1,) int32) and the
        prompt's seen mask with it set, as packed (Wn,) words."""
        a, V = self._admit_in, self.model_cfg.vocab_size
        seen = seen_mask(tokens, a["length"], V)                      # (1, V)
        last = apply_repetition_penalty(last, seen, a["rep_pen"])
        last = torch.where(unpack_mask(a["banned"], V)[None, :],
                           torch.full_like(last, NEG_INF), last)
        if greedy:
            first = last.float().argmax(dim=-1).to(torch.int32)
        else:
            first = sample(last, a["temp"], a["top_k"], a["top_p"],
                           self._admit_gen)
        seen = seen[0].index_fill(0, first.long(), True)
        return first, pack_mask(seen)

    @torch.no_grad()
    def _prefill_sp(self, bucket: int, greedy: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The one-shot admission of an sp mesh (the reference's sp
        branch of ``prefill``): the staged prompt padded to ``bucket``
        through the ring-attention prefill (``llama.apply_prefill_sp``),
        each layer's K/V blocks gathered over sp as the layers run and
        written into the staged page row (quantized per row under an int8
        pool, as ``_insert`` writes them), so no rank holds the bucket's
        whole K/V of every layer at once; then the first token from the
        last valid row's logits, equal on every rank. Returns the first
        token and the seen mask, for ``_arm``."""
        mcfg, dev, a = self.model_cfg, self.device, self._admit_in
        tokens = a["tokens"][:bucket][None, :]
        positions = torch.arange(bucket, dtype=torch.int32, device=dev)[None, :]
        page = self.cfg.page_size
        nb = bucket // page
        dest = a["row"][:nb].long()
        cache = self._state["cache"]
        quant = llama.kv_cache_quantized(cache)
        KV, hd = mcfg.num_kv_heads, mcfg.head_dim

        def write(i: int, k: torch.Tensor, v: torch.Tensor) -> None:
            for name, part in (("k", k), ("v", v)):
                whole = comm.all_gather(part[0], self.mesh, "sp")
                # (sp, S/sp, KV, hd) -> (nb, KV, page, hd): the pool's.
                blocks = whole.reshape(nb, page, KV, hd).transpose(1, 2)
                if quant:
                    rows, scales = quantize_rows(blocks)
                    cache[name][i, dest] = rows
                    cache[name + "s"][i, dest] = scales
                else:
                    cache[name][i, dest] = blocks.to(cache[name].dtype)

        _, _, last = llama.apply_prefill_sp(self.params, mcfg, tokens,
                                            positions, self.mesh,
                                            a["length"], kv_out=write)
        return self._first_token(last, tokens, greedy)

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
        mcfg, a = self._local_cfg, self._admit_in
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
        ``prefill_insert``, one program on the TTFT path); on an sp mesh
        the ring prefill, which writes the pool itself."""
        if self._sp:
            self._arm(*self._prefill_sp(bucket, greedy))
            return
        self._insert(*self._prefill(bucket, greedy))

    @torch.no_grad()
    def _rag_body(self, greedy: bool) -> None:
        """One fused-RAG admission (the reference's ``rag_admit``): the
        question staged in ``_rag_in`` through ``FusedRag.assemble``, the
        assembled tokens and length written over the staged admission
        inputs on the device, then the one-shot prefill and insert at the
        spec's bucket. ``_rag_aux`` gets [first token, length, top_ids]
        for the harvest."""
        fused, x = self._fused_rag, self._rag_in[1]
        spec, a = fused.spec, self._admit_in
        Se, Sq = spec.enc_bucket, spec.q_bucket
        tokens, length, top_ids = fused.assemble(
            x[:2 * Se].view(2, Se), x[2 * Se:2 * Se + Sq], x[-1:],
            share=(functools.partial(comm.broadcast_, mesh=self.mesh)
                   if self._multi else None))
        a["tokens"][:spec.bucket].copy_(tokens)
        a["length"].copy_(length)
        k, v, first, seen = self._prefill(spec.bucket, greedy)
        self._insert(k, v, first, seen)
        self._rag_aux.copy_(torch.cat([first, length, top_ids]))

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
            prefix_pages=self._prefix_pages if prefix else 0, mesh=self.mesh)
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
                             h.index_select(1, idx.long()),
                             self.mesh)[:, 0]                     # (1, V)
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
        tok_a = self._tail_sample()(
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

    def _tail_sample(self):
        """``fused_unembed_sample``, or under a sharded tail its tp form
        over this rank's vocab shard."""
        if self._tail_sharded:
            return functools.partial(fused_unembed_sample_tp, self.mesh)
        return fused_unembed_sample

    def _materialized_tail(self, h: torch.Tensor,
                           greedy: bool) -> torch.Tensor:
        """The materialized tail (``fused_tail=False``, the oracle): (B, V)
        float32 logits of every slot, penalized, banned and sampled with a
        full sort. Returns (B,) int32."""
        st, mcfg, V = self._state, self.model_cfg, self.model_cfg.vocab_size
        pen = apply_repetition_penalty(
            llama.unembed(self.params, mcfg, h, self.mesh),
            unpack_mask(st["seen"], V), st["rep_pen"])
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
            eff_pos % page, return_hidden=True, mesh=self.mesh)
        if self._tail_fused:
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

    def _verify_rows(self, h: torch.Tensor, seen_pos: torch.Tensor,
                     recent_pos: torch.Tensor, draft_grid: torch.Tensor,
                     greedy: bool, ba: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The verify round's sampling tail over the S scored rows of each
        slot (the reference's ``make_verify`` tail): each row is
        penalized, banned and sampled under the slot state it would carry
        after accepting the drafts before it (``seen_pos``, ``recent_pos``
        (B, S, ...)). A greedy row accepts its draft iff it is the row's
        argmax; a sampled row goes through rejection sampling
        (``fused_verify_sample``, or ``verify_reference_tiled`` under the
        materialized tail). Returns (accept (B, S) bool, the token each
        row emits at a rejection or the bonus position (B, S) int32)."""
        st, mcfg, B = self._state, self.model_cfg, self.cfg.max_slots
        S, V = self._spec_S, mcfg.vocab_size
        dev = h.device
        if self._tail_fused:
            act = st["act_idx"][:ba].long()
            rows = act.clamp(max=B - 1)

            def rep(name: str) -> torch.Tensor:
                return st[name].index_select(0, rows).repeat_interleave(
                    S, dim=0)

            hn = llama.unembed_norm(self.params, mcfg, h)        # (B, S, D)
            ha = llama.lm_head_input(
                self.params, hn.index_select(0, rows).reshape(ba * S, -1))
            hit, tail = self._bad_seq_hits(
                rep("bad_seq"), rep("bad_len"),
                recent_pos.index_select(0, rows).reshape(ba * S, -1))
            draft_r = draft_grid.index_select(0, rows).reshape(ba * S)
            common = dict(
                temp=rep("temp"), top_k=rep("top_k"), top_p=rep("top_p"),
                rep_pen=rep("rep_pen"),
                seen_words=seen_pos.index_select(0, rows).reshape(
                    ba * S, -1),
                banned_words=rep("banned"), ban_tok=tail, ban_hit=hit,
                tile=self._sampler_tile, cand_k=self.cfg.sampler_cand_k)

            def tile_fn(t0, tile):
                return llama.lm_head_tile(self.params, mcfg, ha, t0, tile,
                                          prescaled=True)
            if greedy:
                out_r = self._tail_sample()(tile_fn, V, noise=None,
                                            greedy=True, **common)
                acc_r = draft_r == out_r
            else:
                u = torch.rand((ba * S,), generator=self._round_gen,
                               device=dev)
                verify = (functools.partial(fused_verify_sample_tp, self.mesh)
                          if self._tail_sharded else fused_verify_sample)
                acc_r, out_r = verify(
                    tile_fn, V, noise=self._round_gen, u=u,
                    draft_ids=draft_r, **common)
            acc = torch.zeros((B + 1, S), dtype=torch.bool, device=dev)
            out = torch.zeros((B + 1, S), dtype=torch.int32, device=dev)
            acc = acc.index_copy(0, act, acc_r.reshape(ba, S))[:B]
            out = out.index_copy(0, act, out_r.reshape(ba, S))[:B]
            return acc, out
        # The materialized tail: (B*S, V) penalized logits.
        pen = apply_repetition_penalty(
            llama.unembed(self.params, mcfg, h, self.mesh).reshape(B * S, V),
            unpack_mask(seen_pos.reshape(B * S, -1), V),
            st["rep_pen"].repeat_interleave(S))
        pen = torch.where(
            unpack_mask(st["banned"].repeat_interleave(S, dim=0), V),
            torch.full_like(pen, NEG_INF), pen)
        hit, tail = self._bad_seq_hits(
            st["bad_seq"].repeat_interleave(S, dim=0),
            st["bad_len"].repeat_interleave(S, dim=0),
            recent_pos.reshape(B * S, -1))
        pen = pen.scatter_reduce(
            1, torch.where(hit, tail, torch.zeros_like(tail)).long(),
            torch.where(hit, torch.full_like(pen[:, :1], NEG_INF),
                        torch.full_like(pen[:, :1], float("inf"))
                        ).expand(hit.shape).contiguous(),
            reduce="amin")
        draft_r = draft_grid.reshape(B * S)
        if greedy:
            out_r = pen.float().argmax(dim=-1).to(torch.int32)
            acc_r = draft_r == out_r
        else:
            u = torch.rand((B * S,), generator=self._round_gen, device=dev)
            acc_r, out_r = verify_reference_tiled(
                pen, self._round_gen, u, st["temp"].repeat_interleave(S),
                st["top_k"].repeat_interleave(S),
                st["top_p"].repeat_interleave(S), draft_r,
                tile=self._sampler_tile)
        return acc_r.reshape(B, S), out_r.reshape(B, S)

    @torch.no_grad()
    def _verify_body(self, window: int, greedy: bool, ba: int) -> None:
        """One speculative verify round over every slot (the reference's
        ``make_verify``), in place: score S positions per slot (its last
        token and the ``n_draft`` drafts staged in ``drafts``) through
        ``apply_verify_paged`` over the first ``window`` pages of the
        table, sample every scored row (``_verify_rows``), and accept on
        the device: each active slot emits its longest agreed draft
        prefix plus one correction or bonus token, cut at eos or its
        length as sequential decode would cut it. Rows 0..S-1 of
        ``round_tokens`` get the emitted grid (-1 padded), row S the
        accepted draft counts. ``pos`` advances past the consumed inputs
        only, so rejected drafts' pool rows are never read."""
        st, mcfg = self._state, self.model_cfg
        B, S, page = self.cfg.max_slots, self._spec_S, self.cfg.page_size
        eos = int(self.tokenizer.eos_id)
        dev = self.device
        pos, active = st["pos"], st["active"]
        drafts, n_draft = st["drafts"][:, :S - 1], st["n_draft"]
        offs = torch.arange(S, dtype=torch.int32, device=dev)
        eff_pos = torch.where(active, pos, torch.zeros_like(pos))
        positions = eff_pos[:, None] + offs[None, :]               # (B, S)
        tokens = torch.cat([st["last_token"][:, None], drafts], dim=1)
        # Inactive slots and rows past a slot's drafts write the trash
        # page.
        write_ok = active[:, None] & (offs[None, :] <= n_draft[:, None])
        page_idx = (positions // page).clamp(0, self._pmax - 1).long()
        page_of = torch.gather(st["table"], 1, page_idx)
        wp = torch.where(write_ok, page_of, torch.zeros_like(page_of))
        h, _ = llama.apply_verify_paged(
            self.params, mcfg, tokens, positions, st["cache"],
            st["table"][:, :window], eff_pos + S, wp, positions % page,
            return_hidden=True, mesh=self.mesh)
        # Row j's sampler state: what the slot would carry after accepting
        # drafts 0..j-1 (only then is row j consumed).
        seen_l, recent_l = [st["seen"]], [st["recent"]]
        for j in range(1, S):
            d = drafts[:, j - 1]
            on = active & (j <= n_draft)
            seen_l.append(set_token_bits(seen_l[-1], d, on))
            recent_l.append(torch.where(
                on[:, None], torch.cat([recent_l[-1][:, 1:], d[:, None]],
                                       dim=1), recent_l[-1]))
        drafts_ext = torch.cat(
            [drafts, torch.full((B, 1), -1, dtype=torch.int32, device=dev)],
            dim=1)
        draft_grid = torch.where(offs[None, :] < n_draft[:, None],
                                 drafts_ext, torch.full_like(drafts_ext, -1))
        acc, out = self._verify_rows(h, torch.stack(seen_l, dim=1),
                                     torch.stack(recent_l, dim=1),
                                     draft_grid, greedy, ba)
        # The longest agreed prefix, then the correction or bonus token
        # of its first disagreeing (or bonus) row.
        valid = offs[None, :] < n_draft[:, None]
        a = torch.cumprod((acc & valid).to(torch.int32), dim=1).sum(dim=1)
        corr = torch.gather(out, 1, a[:, None].long())
        e = torch.where(offs[None, :] < a[:, None], drafts_ext, corr)
        rem0 = st["remaining"]
        stop_j = (((e == eos) & st["eos_ok"][:, None])
                  | ((rem0[:, None] - (offs[None, :] + 1)) <= 0))
        none_before = torch.cumprod(torch.cat(
            [torch.ones((B, 1), dtype=torch.int32, device=dev),
             (~stop_j[:, :-1]).to(torch.int32)], dim=1), dim=1)
        emit = ((offs[None, :] <= a[:, None]) & (none_before > 0)
                & active[:, None])
        m = emit.sum(dim=1).to(torch.int32)
        last_tok = torch.gather(e, 1, (m - 1).clamp(min=0)[:, None].long()
                                )[:, 0]
        finished = active & (emit & stop_j).any(dim=1)
        seen, recent = st["seen"], st["recent"]
        for j in range(S):
            on = emit[:, j]
            seen = set_token_bits(seen, e[:, j], on)
            recent = torch.where(
                on[:, None], torch.cat([recent[:, 1:], e[:, j:j + 1]],
                                       dim=1), recent)
        new = {"pos": torch.where(active, pos + m, pos),
               "last_token": torch.where(active, last_tok,
                                         st["last_token"]),
               "active": active & ~finished,
               "remaining": torch.where(active, rem0 - m, rem0),
               "seen": seen, "recent": recent}
        st["round_tokens"][:S].copy_(
            torch.where(emit, e, torch.full_like(e, -1)).T)
        st["round_tokens"][S].copy_(a * active)
        for name, value in new.items():
            st[name].copy_(value)

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
        ``(steps, greedy, ba)``, ``ba`` over the active-row ladder, and
        with speculative decoding on the verify rounds
        ``(window, greedy, ba)``, ``window`` over the page ladder. Sampled
        programs draw from a generator."""
        for C in sorted(self._buckets, reverse=True) if not self._sp else ():
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
        if self._spec is not None:
            for window in sorted(self._windows, reverse=True):
                for greedy in (True, False):
                    for ba in self._ba_ladder:
                        yield (self._verify_graphs, (window, greedy, ba),
                               functools.partial(self._verify_body, window,
                                                 greedy, ba),
                               None if greedy else self._round_gen)
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
        pool = self._graph_pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        if self._multi and self._pool_reserve is not None:
            # The captures' warm-ups hold collectives: every rank first
            # shows that the reserve the programs fit in is free.
            self._agreed(lambda: torch.empty(
                (self._pool_reserve,), dtype=torch.int8, device=dev))
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
        def ms(run, replays: int = replays) -> float:
            run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(replays):
                run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / replays

        steps, bucket = self.cfg.steps_per_round, self._buckets[-1]
        B = self.cfg.max_slots
        verify = 0.0
        if self._spec is not None:
            # The widest window: the gather's cost does not depend on
            # which slots are live, so this prices a full-table round.
            verify = ms(self._verify_graphs[
                (self._windows[-1], True, self._ba_ladder[-1])].replay) / (
                    self._spec_S * B)
        d2h = h2d = 0.0
        if self._kv_tier is not None:
            d2h, h2d = self.measure_page_io(min(32, self._n_pages - 1))
        if self._sp:
            # The eager ring admission, at the warm-up's staged inputs.
            prefill = ms(functools.partial(self._admit_body, bucket, True),
                         replays=1)
        else:
            prefill = ms(self._admit_graphs[(bucket, True)].replay)
        return StepCostModel(
            decode_step_ms=ms(self._round_graphs[(steps, True, B)].replay)
            / steps,
            prefill_ms_per_token=prefill / bucket,
            verify_ms_per_token=verify, d2h_ms_per_page=d2h,
            h2d_ms_per_page=h2d, slots=B, source="measured")

    def measure_page_io(self, pages: int, repeats: int = 3
                        ) -> tuple[float, float]:
        """(D2H, H2D) device ms per KV page on the card, by CUDA events,
        as the tier moves pages: the gather of ``pages`` pool pages (1..)
        and its copy into pinned host memory; the copy back and its
        scatter into the same pages (their bytes unchanged), at most the
        pool's. The serve loop must be stopped."""
        pages = min(pages, self._n_pages - 1)
        idx = torch.arange(1, pages + 1, device=self.device)
        cache = self._state["cache"]

        def timed(fn) -> float:
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / repeats / pages

        host = {k: torch.empty((v.shape[0], pages) + tuple(v.shape[2:]),
                               dtype=v.dtype, pin_memory=True)
                for k, v in cache.items()}

        def d2h() -> None:
            for k, v in cache.items():
                host[k].copy_(v.index_select(1, idx), non_blocking=True)

        def h2d() -> None:
            for k, v in cache.items():
                v.index_copy_(1, idx, host[k].to(self.device,
                                                 non_blocking=True))
        return timed(d2h), timed(h2d)

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
        stopped.

        Under tp the leader runs this while its followers follow: each
        attempt's slack is allocated on every rank and its outcome agreed
        before the serve (``_agreed``), as is each rebuild's pool, so an
        out-of-memory error on any one rank shrinks every rank's pool to
        the same page count (the ``"rebuild"`` header carries it). An
        out-of-memory error inside a program is not agreed on: it ends the
        engine."""
        if self._thread is not None:
            raise EngineError("prewarm() requires a stopped engine")
        oom = _AgreedOOM if self._multi else torch.cuda.OutOfMemoryError
        for attempt in range(self.PREWARM_RETRIES + 1):
            try:
                if attempt:
                    # Inside the try: the rebuild's own allocations can
                    # run out too, and that shrinks the pool again.
                    self._broadcast(("rebuild", self._n_pages))
                    self._rebuild()
                self._verify_alloc()
                return
            except oom as exc:
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

    def _alloc_slack(self) -> Optional[torch.Tensor]:
        """The 256 MiB ``prewarm`` holds spare on the card (None on the
        CPU)."""
        return (torch.empty((256 << 20,), dtype=torch.int8,
                            device=self.device)
                if self.device.type == "cuda" else None)

    def _verify_alloc(self) -> None:
        """``prewarm``'s serve: the two short streams, then, once they are
        done, the worst-case request, through the started loop, holding
        256 MiB spare on the card so the accepted size has headroom past
        the serve's peak (under tp on every rank, agreed)."""
        self._broadcast(("slack",))
        slack = self._agreed(self._alloc_slack)
        ids = [min(3, self.model_cfg.vocab_size - 1)] * \
            self.cfg.max_input_length
        streams = []
        if self.cfg.max_slots > 1 and self._tail_fused:
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
            self._broadcast(("slack_done",))

    def _rebuild(self) -> None:
        """Drop the pool, the state and every captured program, and build
        them again at ``_n_pages`` pages (``_build_device``). The serve
        loop is stopped; whatever it held is gone, every reference to the
        failed serve's tensors (its error, its requests and outputs)
        before the cache is emptied."""
        self._free_slots = list(range(self.cfg.max_slots))
        self._drain_intake()
        self._completed = queue.Queue()
        self._harvest_q = queue.Queue()
        self._inline = []
        self._marks = []
        self._inflight_rounds = 0
        self._chunk_behind = False
        self._ring.reset()
        self._ops = []
        recording, self._recording = self._recording, False
        try:
            self._drop_device_state()
            self._build_device()
        finally:
            self._recording = recording
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
        if self._watchdog_thread is None and self._watchdog_stall_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name="engine-watchdog")
            self._watchdog_thread.start()

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise EngineError("engine loop did not stop within 60s")
            self._thread = None
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=5)
            self._watchdog_thread = None
            self._stalled = False
        # Work handed to the serve thread that it did not reach.
        self._run_control()
        self._stop_harvest()
        self._complete_marks(0.0)
        # Cancel what is still live so no consumer blocks forever, and
        # deactivate the slots so a restart reuses no live pages.
        for req in list(self._slots.values()):
            self._release(req)
        for req in self._drain_intake():
            if not req.done:
                req.stream._finish("cancelled")

    def close(self) -> None:
        """Stop serving and hand the engine's device memory back: the pool
        and slot state, the staged admission arrays, every captured
        program and the graph pool behind them, the fused-RAG buffers, and
        the engine's hold on the parameters (weights that another holder
        still references stay allocated for it). A closed engine serves
        nothing more; closing it again does nothing."""
        if self.params is None:
            return
        self._closing = True
        self.stop()
        self._broadcast(("close",))
        self._recording = False
        self._admit_arrays = self._admit_host = self._graph_pool = None
        self._round_gen = self._admit_gen = None
        self.params = None
        self._drop_device_state()

    def _drop_device_state(self) -> None:
        """Drop the pool, the state, every captured program and the fused
        RAG buffers (the serve loop is stopped), and hand their memory
        back to the card."""
        self._fatal = None
        self._state = self._admit_in = None
        self._round_graphs = self._admit_graphs = {}
        self._extend_graphs = self._final_graphs = {}
        self._verify_graphs = {}
        self._io_pending = []
        self._fused_rag = self._rag_in = self._rag_aux = None
        self._rag_graphs = {}
        self._slots = {}
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reset(self) -> None:
        """Stop serving and start over: fail every live request and every
        queued control operation (a suspend queued before the reset must
        not run against the rebuilt state), stop the loop and rebuild the
        pool, the state and the captured programs. The pool's cached
        prefixes are dropped; the host tier keeps its blocks."""
        exc = EngineError("engine was reset")
        self._fail_control_ops("engine was reset")
        for req in list(self._slots.values()) + list(self._backlog):
            if not req.done:
                req.stream._fail(exc)
        self.stop()
        self._broadcast(("rebuild", self._n_pages))
        self._rebuild()

    def _fail_control_ops(self, reason: str) -> None:
        """Fail every queued control operation's caller; none of them
        runs."""
        while True:
            try:
                _fn, done, box = self._control.get_nowait()
            except queue.Empty:
                return
            box["error"] = EngineError(reason)
            done.set()

    # ------------------------------------------------------------ watchdog

    @property
    def stalled(self) -> bool:
        """The liveness watchdog's verdict: True while work is queued or
        in flight and no progress counter has moved for
        ``ENGINE_WATCHDOG_STALL_S``; it clears as soon as one moves."""
        return self._stalled

    def _progress_marks(self) -> tuple:
        """The counters a live engine moves."""
        with self._stats_lock:
            s = self._stats
            return (s["rounds_completed"], s["harvest_rounds"],
                    s["first_readbacks"], s["prefills"],
                    s["tokens_generated"])

    def _work_pending(self) -> bool:
        return (self._inflight_rounds > 0 or len(self._backlog) > 0
                or self._pending.qsize() > 0)

    def _watchdog_loop(self) -> None:
        """Poll the progress counters; with work pending and nothing
        moving for the threshold, declare a stall once: count it, log
        every thread's stack and the last round record, flip
        ``stalled``."""
        poll = max(0.05, min(1.0, self._watchdog_stall_s / 4.0))
        marks = self._progress_marks()
        last_move = time.monotonic()
        while not self._stopped.wait(poll):
            now = time.monotonic()
            cur = self._progress_marks()
            if cur != marks or not self._work_pending():
                if self._stalled:
                    self._stalled = False
                    log_event(logger, "engine_watchdog_recovered",
                              stalled_s=round(now - last_move, 2))
                marks, last_move = cur, now
                continue
            if self._stalled or now - last_move < self._watchdog_stall_s:
                continue
            self._stalled = True
            self._bump("watchdog_stalls")
            names = {t.ident: t.name for t in threading.enumerate()}
            stacks = {f"{names.get(tid, '?')}:{tid}":
                      "".join(traceback.format_stack(frame))[-2000:]
                      for tid, frame in sys._current_frames().items()}
            try:
                last_round = self.rounds.snapshot(
                    limit=1, engine_tag=self._engine_tag).get("rounds")
            except Exception:  # noqa: BLE001 - diagnostics never raise
                last_round = None
            log_event(logger, "engine_watchdog_stall",
                      stall_s=round(now - last_move, 2),
                      threshold_s=self._watchdog_stall_s,
                      queue_waiting=(len(self._backlog)
                                     + self._pending.qsize()),
                      inflight_rounds=self._inflight_rounds,
                      last_round=last_round, stacks=stacks)

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

    def pinned_round_budget(self, tokens: Optional[int] = None):
        """Context manager: the scheduler's round budget held at
        ``tokens`` (default: where the online calibrator left it) for the
        block, so runs compared with each other plan the same chunks.
        Yields the held budget; drive the engine from one thread."""
        return self._sched.pinned_budget(tokens)

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
        if self.role == "prefill" \
                and params.max_tokens > self._role_prefill_max_tokens \
                and not (request_id or "").startswith("engine-prewarm"):
            # A routing error, not a capacity one: the edges answer a
            # retryable 429. Prewarm's own probes run before the replica
            # takes traffic and need full decode rounds whatever the
            # role.
            raise RoleMismatchError(
                f"prefill-role engine refuses decode-bound request "
                f"(max_tokens={params.max_tokens} > role cap "
                f"{self._role_prefill_max_tokens}); route it to a "
                f"decode/unified replica")
        if len(prompt_ids) > self.cfg.max_input_length:
            raise EngineError(
                f"prompt length {len(prompt_ids)} exceeds max_input_length "
                f"{self.cfg.max_input_length}")
        if len(prompt_ids) == 0:
            raise EngineError("empty prompt")
        # A mid-stream resume (engine/resume.py) admits prompt + the
        # replayed generated ids: from here on they are prompt (the
        # prefix cache and the host tier make them cheap) and the stream
        # carries only new tokens. max_input_length bounds the original
        # prompt; max_tokens counts the replayed ids.
        rz = engine_resume.current_resume()
        replay = [int(t) for t in (rz or {}).get("ids", ())]
        ids = [int(t) for t in prompt_ids] + replay
        eff_max = min(params.max_tokens - len(replay),
                      self.cfg.max_cache_len - len(ids))
        if replay and eff_max < 1:
            raise EngineError(
                f"resume replays {len(replay)} tokens but the request has "
                f"no token budget left (max_tokens={params.max_tokens})")
        need = _ceil_div(len(ids) + eff_max, self.cfg.page_size)
        if need > self._n_pages - 1:
            raise EngineError(
                f"request needs {need} KV pages but the pool only has "
                f"{self._n_pages - 1} (kv_pool_tokens too small)")
        banned_np, bad_seq_np, bad_len_np = self._render_bad_words(params)
        stream = self._new_stream(request_id, len(ids), eff_max)
        req = _Request(stream=stream, prompt_ids=ids, params=params,
                       detok=IncrementalDetokenizer(self.tokenizer),
                       stop=StopWordTrap(params.stop_words),
                       eff_max=eff_max, extent=len(ids) + eff_max,
                       greedy=(params.top_k == 1 or params.temperature <= 0),
                       banned_np=banned_np, bad_seq_np=bad_seq_np,
                       bad_len_np=bad_len_np,
                       deadline_t=self._resolve_deadline(stream, deadline_t),
                       seq=next(self._arrival_seq), base_len=len(ids),
                       resume_offset=len(replay) if replay else None)
        if replay:
            # A fresh stop-word trap is right: text held back on the lost
            # replica never reached the caller. The detokenizer takes the
            # replayed ids as emitted context.
            req.detok.prime(replay)
            tl = stream.timeline
            if tl is not None:
                tl.annotate(resume_replayed=len(replay),
                            resume_attempt=int((rz or {}).get("attempt", 1)))
                tl.event("resume_admit", {"replayed": len(replay)})
        self._attach_drafter(req, ids)
        if self._kv_tier is not None:
            # The router's placement-miss hint: a bounded fetch on the
            # caller's thread, so the serve thread does no network I/O.
            self._transfer_prefetch(req)
        return self._enqueue(req)

    def _transfer_prefetch(self, req: _Request) -> None:
        """Cross-replica prefix-page import, on the submitting thread: when
        the chain server bound a donor (``X-KV-Transfer-From``), fetch the
        prompt-head blocks the host tier lacks from the donor's
        ``/control/kv_pages`` into the host tier. The admission's priced
        restore then copies them into the pool on the serve thread, as
        any host-tier hit. Any failure or timeout places the request
        cold."""
        tier = self._kv_tier
        src = kv_tier_mod.current_transfer_source()
        if tier is None or src is None or not req.prompt_ids:
            return
        if not kv_tier_mod.donor_allowed(src):
            # The hint header is client-suppliable on a replica reached
            # directly: a donor outside KV_TRANSFER_ALLOW is ignored.
            logger.warning("kv transfer: donor %s not in KV_TRANSFER_ALLOW; "
                           "ignoring hint", src)
            return
        if req.block_hashes is None:
            req.block_hashes = hash_blocks(req.prompt_ids, self.cfg.page_size)
        missing = [h for h in req.block_hashes[:tier.transfer_max_pages]
                   if not tier.store.has(h)]
        if not missing:
            return
        got = kv_tier_mod.fetch_blocks(
            src, missing, timeout_s=tier.transfer_timeout_s,
            max_pages=tier.transfer_max_pages,
            on_corrupt=lambda: self._bump("kv_restore_corrupt"))
        if not got:
            return
        meta, records = got
        if not tier.compatible(meta):
            logger.warning("kv transfer: donor %s pool geometry does not "
                           "match; ignoring payload", src)
            return
        # Only blocks this prompt asked for may land: an answer naming
        # any other hash is a donor bug or an attempt to poison unrelated
        # prefixes through the shared host store, dropped either way.
        wanted = set(missing)
        n = sum(1 for record in records
                if record.hash in wanted and tier.store.put(record))
        if n:
            self._bump("kv_tier_transfer_pages", n)
            tl = req.stream.timeline
            if tl is not None:
                tl.annotate(kv_transfer_pages=n)

    def _attach_drafter(self, req: _Request, context: Sequence[int]) -> None:
        """With speculative decoding on, the request's prompt-lookup index
        (built on the submitting thread) and its draft-length
        controller."""
        if self._spec is not None:
            req.drafter = PromptLookupDrafter(
                context, ngram_max=self._spec.ngram_max,
                ngram_min=self._spec.ngram_min)
            req.spec_ctrl = AdaptiveDraftController(self._spec)

    def _render_bad_words(self, params: SamplingParams
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``params.bad_words`` as the device inputs: the packed (Wn,)
        banned-token words, the (MAX_BAD_SEQS, MAX_BAD_LEN) sequence table
        (-1 padded) and its lengths. Built on the caller's thread."""
        banned_ids, bad_seqs = self._compile_bad_words(params)
        banned_row = np.zeros((self.model_cfg.vocab_size,), bool)
        banned_row[banned_ids] = True
        seq_tbl = np.full((self.MAX_BAD_SEQS, self.MAX_BAD_LEN), -1,
                          np.int32)
        seq_len = np.zeros((self.MAX_BAD_SEQS,), np.int32)
        for i, seq in enumerate(bad_seqs):
            seq_tbl[i, :len(seq)] = seq
            seq_len[i] = len(seq)
        return pack_mask_np(banned_row), seq_tbl, seq_len

    def _enqueue(self, req: _Request) -> TokenStream:
        """Queue a built request for the serve thread (refused at a full
        queue); returns its stream."""
        stream = req.stream
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

    # ------------------------------------------------------------ fused RAG

    def enable_fused_rag(self, enc_params, enc_cfg,
                         spec: FusedRagSpec) -> None:
        """Serve fused-RAG admissions (``engine/rag_fusion.py``): the
        question's retrieval, prompt assembly and prefill as one device
        program. The corpus comes through ``set_rag_corpus``, which on the
        card captures the program. A new spec drops the old one's
        programs. Refused: a bucket that is not a page multiple or leaves
        the cache no room (the reference's refusals), and encoder
        parameters on another device. Under tp the encoder's parameters
        go from the leader to every follower by broadcasts (the followers
        hold a replica each, as the reference's unsharded arrays are)."""
        if spec.bucket % self.cfg.page_size:
            raise EngineError("fused-RAG bucket must be a page multiple")
        if spec.bucket + 1 > self.cfg.max_cache_len:
            raise EngineError("fused-RAG bucket exceeds the cache extent")
        where = enc_params["embed"]["word"].device
        if where.type != self.device.type:
            raise EngineError(f"the encoder's parameters are on {where}; "
                              f"the engine runs on {self.device}")

        def install() -> None:
            flat = weight_cache.flatten(enc_params)
            self._broadcast(("rag_enable", enc_cfg, spec, [
                (name, tuple(t.shape), t.dtype) for name, t in flat.items()]))
            self._install_rag(enc_params, enc_cfg, spec)
        self._on_serve_thread(install)

    def _install_rag(self, enc_params, enc_cfg, spec: FusedRagSpec) -> None:
        """``enable_fused_rag``'s body, on every rank (a follower's
        ``enc_params`` are empty tensors the leader's broadcasts fill)."""
        self._drop_rag_programs()
        if self._multi:
            with self._collective():
                for t in weight_cache.flatten(enc_params).values():
                    comm.broadcast_(t, self.mesh)
        n = 2 * spec.enc_bucket + spec.q_bucket + 1
        self._fused_rag = FusedRag(enc_params, enc_cfg, spec, self.device)
        self._rag_in = (np.zeros((n,), np.int32),
                        torch.zeros((n,), dtype=torch.int32,
                                    device=self.device))
        self._rag_aux = torch.zeros((spec.top_k + 2,), dtype=torch.int32,
                                    device=self.device)

    @property
    def fused_rag_spec(self) -> Optional[FusedRagSpec]:
        """The spec of the fused-RAG program, or None when fused RAG is
        not enabled (a rebuild drops it): callers that keep a spec
        compare it with the engine's."""
        return self._fused_rag.spec if self._fused_rag is not None else None

    def set_rag_corpus(self, emb, toks, lens) -> None:
        """Upload or replace the device-resident retrieval corpus
        (``rag_fusion.corpus_rows`` builds toks/lens from chunk texts).
        While the serve thread runs, the upload runs there between two
        steps, so on the device it is ordered against every program in
        flight: an admission dispatched before it reads the old corpus,
        one after it the new. On the card the fused programs are captured
        here when missing, and again when the corpus outgrew its
        capacity (new buffers). Under tp the leader's rows then go to
        every follower by broadcasts (NCCL on the card, never through the
        pickled headers)."""
        if self._fused_rag is None:
            raise EngineError("enable_fused_rag() first")

        def upload() -> None:
            emb_np = np.asarray(emb, np.float32)
            self._broadcast(("rag_corpus", emb_np.shape[0],
                             emb_np.shape[1]))
            self._set_corpus(emb_np, toks, lens)
            self._capture_rag()
        self._on_serve_thread(upload)

    def _set_corpus(self, emb, toks, lens) -> None:
        """``set_rag_corpus``'s upload, on every rank (a follower's arrays
        are zeros of the leader's shapes, which the broadcasts fill)."""
        fused = self._fused_rag
        grew = fused.set_corpus(emb, toks, lens, copy=functools.partial(
            self._host_to_device, record=False))
        if self._multi:
            with self._collective():
                for t in fused.corpus.values():
                    comm.broadcast_(t, self.mesh)
        if grew:
            self._drop_rag_programs()

    # The slot state an admission writes (``_arm``).
    _SLOT_KEYS = ("table", "pos", "last_token", "active", "remaining",
                  "eos_ok", "temp", "top_k", "top_p", "rep_pen", "seen",
                  "banned", "bad_seq", "bad_len", "recent")

    def _capture_rag(self) -> None:
        """Capture the fused admission, greedy and sampled (which draws
        from ``_admit_gen``), into the engine's shared graph pool on its
        capture stream: on the card with graphs on, when not captured
        yet. The warm-up run before each capture writes the trash page
        and the state of slot 0 from zeroed staging inputs: the slot
        state is saved before and put back after, so a live request in
        slot 0 keeps its own. The programs' memory must fit beside the KV
        pool: running out raises ``EngineError``."""
        if not self._graphs_on or self._rag_graphs:
            return
        # The warm-ups hold collectives under tp: the followers capture
        # alongside, staging their own inputs (nothing is recorded).
        self._broadcast(("rag_capture",))
        recording, self._recording = self._recording, False
        try:
            self._capture_rag_programs()
        finally:
            self._recording = recording

    def _capture_rag_programs(self) -> None:
        dev, st, spec = self.device, self._state, self._fused_rag.spec
        saved = {name: st[name].clone() for name in self._SLOT_KEYS}
        for arr in self._admit_arrays.values():
            arr.fill(0)
        h = self._admit_host
        h["length"][0] = 1
        h["temp"][0] = h["top_p"][0] = h["rep_pen"][0] = 1.0
        self._copy_admission_inputs()
        self._rag_in[0].fill(0)
        self._host_to_device(self._rag_in[1], self._rag_in[0])
        before = torch.cuda.memory_reserved(dev)
        try:
            for greedy in (True, False):
                self._rag_graphs[(greedy,)] = graphs.capture(
                    functools.partial(self._rag_body, greedy), device=dev,
                    stream=self._capture_stream, pool=self._graph_pool,
                    generators=() if greedy else (self._admit_gen,))
        except torch.cuda.OutOfMemoryError as exc:
            self._rag_graphs = {}
            raise EngineError(
                f"the fused-RAG admission (bucket {spec.bucket}, corpus of "
                f"{self._fused_rag.capacity} rows) does not fit in the "
                f"device memory the KV pool left; shrink kv_pool_tokens"
            ) from exc
        finally:
            # After the warm-ups, also when one failed.
            torch.cuda.current_stream(dev).wait_stream(self._capture_stream)
            for name, t in saved.items():
                st[name].copy_(t)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self.rag_graph_bytes = torch.cuda.memory_reserved(dev) - before

    def _drop_rag_programs(self) -> None:
        """Forget the fused programs, once no replay of them is in flight
        (their graphs and pool blocks go with them)."""
        if self._rag_graphs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._rag_graphs = {}

    def _on_serve_thread(self, fn):
        """Run ``fn`` on the serve thread between two of its steps and
        return its result (its error is raised here); run it here when no
        serve thread runs or this is it."""
        thread = self._thread
        if thread is None or thread is threading.current_thread():
            return fn()
        done, box = threading.Event(), {}
        self._control.put((fn, done, box))
        self._wake.set()
        while not done.wait(0.05):
            self._alive()
            if self._thread is None:   # stopped meanwhile: run it here
                self._run_control()
        if "error" in box:
            raise box["error"]
        return box.get("out")

    def _run_control(self) -> bool:
        """Run the work handed over by ``_on_serve_thread``; True when
        there was some."""
        did = False
        while True:
            try:
                fn, done, box = self._control.get_nowait()
            except queue.Empty:
                return did
            did = True
            try:
                box["out"] = fn()
            except Exception as exc:  # noqa: BLE001 - raised to the caller
                box["error"] = exc
            finally:
                done.set()

    def submit_rag(self, question_ids: Sequence[int],
                   question_enc_ids: Sequence[int],
                   params: Optional[SamplingParams] = None,
                   request_id: Optional[str] = None,
                   deadline_t: Optional[float] = None) -> TokenStream:
        """Enqueue a fused-RAG request: retrieval and prompt assembly run
        on the device in its admission. ``question_ids`` are the
        question's tokens in the LLM vocabulary (no BOS),
        ``question_enc_ids`` in the encoder's (with any query prefix).
        The stream's ``source_ids`` get the retrieved corpus rows with
        the first token."""
        if self._fatal is not None:
            raise EngineError("engine is dead") from self._fatal
        fused = self._fused_rag
        if fused is None:
            raise EngineError("fused RAG is not enabled on this engine")
        params = params or SamplingParams()
        spec = fused.spec
        ids = [int(t) for t in question_ids]
        if len(ids) > spec.q_bucket:
            # As submit(): cutting the question would answer another one.
            raise EngineError(
                f"question is {len(ids)} tokens but the fused-RAG "
                f"question bucket is {spec.q_bucket}; use the host "
                "retrieval path for long questions")
        q_llm = np.zeros((spec.q_bucket,), np.int32)
        q_llm[:len(ids)] = ids
        q_enc = np.zeros((2, spec.enc_bucket), np.int32)
        eids = list(question_enc_ids)[:spec.enc_bucket]
        q_enc[0, :len(eids)] = eids
        q_enc[1, :len(eids)] = 1
        eff_max = min(params.max_tokens, self.cfg.max_cache_len - spec.bucket)
        if eff_max < 1:
            raise EngineError("fused-RAG bucket leaves no room to decode")
        need = _ceil_div(spec.bucket + eff_max, self.cfg.page_size)
        if need > self._n_pages - 1:
            # An extent the pool can never hold would wait forever.
            raise EngineError(
                f"fused-RAG request needs {need} KV pages but the pool "
                f"only has {self._n_pages - 1} (kv_pool_tokens too small)")
        banned_np, bad_seq_np, bad_len_np = self._render_bad_words(params)
        stream = self._new_stream(request_id, len(ids), eff_max)
        req = _Request(stream=stream, prompt_ids=[], params=params,
                       detok=IncrementalDetokenizer(self.tokenizer),
                       stop=StopWordTrap(params.stop_words),
                       eff_max=eff_max, extent=spec.bucket + eff_max,
                       greedy=(params.top_k == 1 or params.temperature <= 0),
                       banned_np=banned_np, bad_seq_np=bad_seq_np,
                       bad_len_np=bad_len_np,
                       deadline_t=self._resolve_deadline(stream, deadline_t),
                       seq=next(self._arrival_seq), base_len=spec.bucket,
                       rag=(q_llm, len(ids), q_enc))
        # The prompt is assembled on the device: the drafter indexes the
        # generated tokens only.
        self._attach_drafter(req, ())
        return self._enqueue(req)

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
        did = self._run_control()
        did |= self._drain_completed()
        self._pull_pending()
        did |= self._cull_backlog()
        self._poll_io()
        # Online calibration: fold new round evidence into the model
        # before this round is planned (a version check when idle).
        if self._calib is not None and self._sched.recalibrate():
            with self._stats_lock:
                self._stats["sched_round_budget_tokens"] = \
                    self._sched.round_budget_tokens
                self._stats["sched_budget_recalibrations"] += 1
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
                kind=("verify" if plan.decode_steps
                      and self._draft_plan is not None
                      else "decode" if plan.decode_steps else "prefill"),
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
        # CUDA events around the round's programs (``_replay``), for the
        # cost calibrator.
        self._span = ([None, None] if self.device.type == "cuda"
                      else None)
        if plan.decode_steps:
            if self._draft_plan is not None:
                self._dispatch_verify(self._draft_plan, rec)
                self._draft_plan = None
            else:
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
                elif prefilled and rec.kind == "decode":
                    rec.kind = "mixed"
                span = self._span
                if span is not None and span[1] is not None:
                    rec.device_events = tuple(span)
                self.rounds.seal(
                    rec, parts=parts, prefill_tokens=prefilled,
                    grants=grants, modeled_ms=self._modeled_round_ms(
                        rec, plan.decode_steps if dispatched else 0,
                        prefilled))
        self._span = None
        return admitted or bool(prefilled) or dispatched

    def _modeled_round_ms(self, rec, decode_steps: int,
                          prefill_tokens: int) -> float:
        """What the step-cost model predicts the round takes: the
        denominator of its drift ratio."""
        cost = self._sched.cost
        modeled = prefill_tokens * cost.prefill_ms_per_token
        if decode_steps and rec.verify_positions:
            modeled += rec.verify_positions * (cost.verify_ms_per_token
                                               or cost.prefill_ms_per_token)
        else:
            modeled += cost.decode_round_ms(decode_steps)
        if rec.kv_restore_pages:
            modeled += cost.restore_ms(rec.kv_restore_pages)
        return modeled

    def _round_device_ms(self, rec) -> float:
        """A completed round's device time for the calibrator: on the
        card the CUDA events around its programs, read only once the end
        event has completed (``query`` does not wait; a round whose
        events are not done yet feeds nothing); elsewhere the round
        record's host-clock estimate."""
        events = rec.device_events
        if events is None:
            return rec.device_ms if self.device.type != "cuda" else 0.0
        start, end = events
        return start.elapsed_time(end) if end.query() else 0.0

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
            # Only pure rounds are attributable: a mixed round's time
            # cannot be split.
            calib = self._calib
            ms = self._round_device_ms(rec) if calib is not None else 0.0
            if ms > 0:
                if rec.kind == "decode" and not rec.prefill_tokens:
                    calib.observe_decode(rec.decode_steps, ms)
                elif rec.kind == "verify" and not rec.prefill_tokens:
                    calib.observe_verify(rec.verify_positions, ms)
                elif rec.kind == "prefill":
                    # Per token the programs computed (their buckets): a
                    # short prompt padded to a bucket would otherwise
                    # price every prefill token as its whole bucket.
                    calib.observe_prefill(rec.prefill_computed, ms)
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
                faults.inject("engine.harvest")  # chaos: a readback fault
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
        if kind == "offload":
            self._harvest_offload(item)
        elif kind == "mark":
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
        kind, members, buf, rows, rec = item[:5]
        t0 = time.monotonic()
        grid = self._ring.read(buf, rows)
        accs = None
        if kind == "verify":
            # The last row holds the accepted draft counts.
            grid, accs = grid[:-1], grid[-1]
        if kind == "first":
            for req in members.values():
                if req.rag_aux is not None:
                    # Fused RAG: [first token, prompt length, top_ids].
                    aux, event = req.rag_aux
                    if event is not None:
                        event.synchronize()
                    vals = aux.tolist()
                    req.stream.rag_length = vals[1]
                    req.stream.source_ids = vals[2:]
                    req.rag_aux = None
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
        accepted = 0
        if accs is not None:
            accepted = self._finish_verify(members, accs, item[5], emitted)
        self.rounds.complete_part(rec, tokens=sum(emitted.values()),
                                  spec_accepted=accepted,
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
        verify_cost = None
        hold = False
        self._draft_plan = None
        if self._spec is not None and steps:
            # A verify round needs the exact host context, so it runs
            # only with the pipeline drained. With rounds in flight a
            # slot that looks draftable holds the next round back until
            # they drain; with nothing to draft the pipelined classic
            # rounds go on.
            if self._inflight_rounds == 0:
                self._draft_plan = self._plan_drafts(armed.values())
                if self._draft_plan is not None:
                    steps = 1
                    verify_cost = self._sched.cost.verify_cost_tokens(
                        self._spec_S * len(armed))
            else:
                hold = self._any_draftable(armed.values())
        # The depth gate: no new round while ``_depth`` are in flight.
        # Prompt chunks may take the place of the next round unless
        # chunks already followed the last one: they are granted what is
        # left beside that round, so one chunk step queues between two
        # rounds as at depth 1 (a request arriving beside decoding
        # streams waits for no extra round), and chunks never run back
        # to back ahead of the next round.
        gated = steps > 0 and (hold
                               or self._inflight_rounds >= self._depth)
        if gated and self._chunk_behind:
            return RoundPlan(decode_steps=0, active_decodes=len(armed))
        # A fused-RAG prompt is assembled on the device: it is charged the
        # spec's whole bucket (its ``base_len``).
        inflight = [PrefillJob(key=r, remaining=r.base_len - r.pf_pos,
                               deadline_t=r.deadline_t, seq=r.seq,
                               started=True)
                    for r in self._slots.values() if not r.prefill_done]
        backlog = [PrefillJob(key=r, remaining=r.base_len,
                              deadline_t=r.deadline_t, seq=r.seq)
                   for r in self._backlog] if self._free_slots else []
        plan = self._sched.plan_round(
            decode_steps=steps, active_decodes=len(armed), inflight=inflight,
            backlog=backlog, now=time.monotonic(),
            max_new=len(self._free_slots), decode_cost_tokens=verify_cost)
        if gated:
            plan.decode_steps = 0
        return plan

    def _any_draftable(self, armed) -> bool:
        """Could an armed slot propose a draft now? A hint read while
        rounds are in flight (the host context may lag the device): it
        decides whether to hold the next round for a verify round, never
        what is drafted."""
        for req in armed:
            if (req.drafter is not None and req.stream.token_ids
                    and min(req.spec_ctrl.k,
                            req.eff_max - req.generated - 1) > 0
                    and req.drafter.propose(1)):
                return True
        return False

    def _plan_drafts(self, armed) -> Optional[dict]:
        """Prompt-lookup proposals for a verify round, {slot: drafts}, or
        None when no slot drafts (a classic round runs instead). A slot
        whose first token is not read back yet drafts nothing (its index
        lags the device) but still rides the round as one row. Drafts
        never run past a request's remaining length, so no row writes
        past its pages."""
        plan: dict[int, list[int]] = {}
        for req in armed:
            if req.drafter is None or not req.stream.token_ids:
                continue
            k = min(req.spec_ctrl.k, self._spec.max_draft_tokens,
                    req.eff_max - req.generated - 1)
            if k <= 0:
                continue
            proposal = req.drafter.propose(k)
            if proposal:
                plan[req.slot] = proposal
        return plan or None

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
                ok = self._begin_prefill(req, rec)
                if ok is None:     # cancelled while it waited
                    admitted = True
                    continue
                if not ok:         # pool backpressure: stop admitting
                    break
                admitted = True
            n, computed = self._advance_prefill(req, grant)
            if n:
                prefilled += n
                grants.append((req.stream.request_id, n))
                if rec is not None:
                    rec.prefill_computed += computed
                    rec.hbm_bytes += (self._param_bytes
                                      + n * self._kv_bytes_per_token())
            if req.prefill_done:
                armed.append(req)
        return armed, prefilled, admitted, grants

    def _prefix_lookup(self, req: _Request):
        """Match the prompt's full blocks against the prefix cache and
        take refs on the usable prefix. Returns (the prompt's block
        hashes, how many leading blocks to map read-only, their pages).
        A full-cover match is capped one block short (COW demotion).
        Fused-RAG requests bypass the cache: the host never sees their
        prompt."""
        if self._prefix_cache is None or req.rag is not None:
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
        if self._prefix_cache is None or req.rag is not None:
            return
        for i in range(k_use, len(hashes)):
            parent = hashes[i - 1] if i else None
            if self._prefix_cache.insert(hashes[i], parent, req.pages[i]):
                req.cache_refs.append(hashes[i])
                req.cache_pages.add(req.pages[i])

    # ------------------------------------------------------ the host KV tier

    def _index_tensor(self, pages) -> torch.Tensor:
        """Page ids as an int64 device tensor, through a pinned buffer on
        the card (a pageable copy would wait for every round in
        flight)."""
        src = torch.from_numpy(np.asarray(pages, np.int64))
        if self.device.type == "cuda":
            src = src.pin_memory()
        return src.to(self.device, non_blocking=True)

    def _gather_pages(self, pages: Sequence[int]) -> Optional[dict]:
        """The whole model's KV of pool ``pages`` on the device, name ->
        (L, n, KV, page, hd) (``(L, n, KV, page)`` for the int8 pool's
        scales), gathered on the serve stream ahead of any later program.
        Under tp every rank gathers its own heads and they meet on the
        leader (a header first; None on a follower), each kv head taken
        from a rank that holds it (``llama.kv_heads_held``)."""
        idx = self._index_tensor(pages)
        local = {k: v.index_select(1, idx)
                 for k, v in self._state["cache"].items()}
        if not self._sharded:
            return local
        self._broadcast(("gather", list(pages)))
        tp, KV = self.mesh.tp, self.model_cfg.num_kv_heads
        out = {}
        with self._collective():
            for name, t in local.items():
                parts = comm.all_gather(t, self.mesh)   # (tp, L, n, KVl..)
                if not self.leader:
                    continue
                whole = t.new_empty((t.shape[0], t.shape[1], KV)
                                    + tuple(t.shape[3:]))
                for r in range(tp):
                    held = llama.kv_heads_held(self.model_cfg, tp, r)
                    whole[:, :, list(held)] = parts[r]
                out[name] = whole
        return out if self.leader else None

    def _scatter_pages(self, pages: Sequence[int],
                       arrays: Optional[dict]) -> None:
        """Write whole-model page KV (``arrays``: name -> (L, n, KV, ...)
        host tensors, the leader's) into pool ``pages``; under tp the
        leader sends a header, broadcasts the pages and each rank keeps
        its own heads. On the card the copies come from pinned memory,
        asynchronously."""
        idx = self._index_tensor(pages)
        cache = self._state["cache"]
        cuda = self.device.type == "cuda"

        def upload(name: str, pool: torch.Tensor) -> torch.Tensor:
            src = arrays[name].to(pool.dtype)
            if cuda:
                src = src.pin_memory()
            return src.to(self.device, non_blocking=True)

        if not self._multi:
            for name, pool in cache.items():
                pool.index_copy_(1, idx, upload(name, pool))
            return
        self._broadcast(("scatter", list(pages)))
        KV = self.model_cfg.num_kv_heads
        held = torch.tensor(llama.kv_heads_held(
            self.model_cfg, self.mesh.tp, self.mesh.tp_rank),
            device=self.device)
        with self._collective():
            for name, pool in cache.items():
                buf = (upload(name, pool) if self.leader else torch.empty(
                    (pool.shape[0], len(pages), KV) + tuple(pool.shape[3:]),
                    dtype=pool.dtype, device=self.device))
                comm.broadcast_(buf, self.mesh)
                pool.index_copy_(1, idx, buf.index_select(2, held))

    def _offload_victims(self, victims: list, rec=None) -> None:
        """Offload evicted refcount-0 prefix pages to the host tier: one
        gather of the victims into device staging on the serve stream
        (ordered before any later program overwrites the pages; under tp
        every rank's heads, into whole-model blocks on the leader), then
        on the card a copy into pinned host memory on a side stream under
        CUDA events; the harvest waits for it and files the records, off
        the scheduling path. A failure before the gather (an injected
        ``kv.offload`` too) or after it drops the pages, as the engine
        without a tier does; a failure in the gather's collectives ends
        the engine."""
        tier = self._kv_tier
        if tier is None or not victims:
            return
        try:
            faults.inject("kv.offload")
            fresh = [(h, par, pg) for h, par, pg in victims
                     if not tier.store.has(h)]
        except Exception:  # noqa: BLE001 - offload is best effort
            logger.debug("kv offload failed; pages dropped", exc_info=True)
            return
        if not fresh:
            return
        staged = self._gather_pages([pg for _, _, pg in fresh])
        try:
            events = None
            if self.device.type == "cuda":
                if self._io_stream is None:
                    self._io_stream = torch.cuda.Stream(self.device)
                io = self._io_stream
                io.wait_stream(torch.cuda.current_stream(self.device))
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                host = {}
                with torch.cuda.stream(io):
                    events[0].record()
                    for k, v in staged.items():
                        host[k] = torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=True)
                        host[k].copy_(v, non_blocking=True)
                        v.record_stream(io)
                    events[1].record()
            else:
                host = staged
            self._post(("offload", [(h, par) for h, par, _ in fresh], host,
                        events, None))
            if rec is not None:
                # The leader moves whole-model blocks (every rank's heads).
                rec.hbm_bytes += (len(fresh) * self.cfg.page_size
                                  * self._kv_bytes_per_token(local=False))
        except Exception:  # noqa: BLE001 - offload is best effort
            logger.debug("kv offload failed; pages dropped", exc_info=True)

    def _harvest_offload(self, item: tuple) -> None:
        """The harvest's half of an offload: wait for the copy, split it
        into per-block records for the host store, feed the D2H time (the
        CUDA events' on the card) to the calibrator."""
        _, metas, host, events, _ = item
        t0 = time.monotonic()
        if events is not None:
            events[1].synchronize()
            ms = events[0].elapsed_time(events[1])
        else:
            ms = (time.monotonic() - t0) * 1e3
        tier = self._kv_tier
        if tier is None:
            return
        for block in KVTier.split_pages(host, metas):
            tier.store.put(block)
        if self._calib is not None and events is not None:
            self._calib.observe_d2h(len(metas), ms)
        self._bump("kv_tier_offload_pages", len(metas))

    def _poll_io(self) -> None:
        """Feed the calibrator the restores whose CUDA events completed
        (``query`` does not wait)."""
        pending, self._io_pending = self._io_pending, []
        for pages, start, end in pending:
            if end.query():
                if self._calib is not None:
                    self._calib.observe_h2d(pages, start.elapsed_time(end))
            else:
                self._io_pending.append((pages, start, end))

    def _plan_restore(self, req: _Request, hashes: list,
                      k_use: int) -> list:
        """The host-tier half of the admission lookup: the chain's
        continuation ``hashes[k_use:]`` present in the host store, capped
        one block short of a full cover like any prefix match, and priced
        (``StepCostModel.restore_cheaper``; a refusal counts in
        ``kv_restore_skipped_cost``). Returns the records to restore."""
        tier, page = self._kv_tier, self.cfg.page_size
        avail = tier.store.match_chain(hashes[k_use:])
        if not avail:
            return []
        usable = usable_prefix_tokens(k_use + avail, len(req.prompt_ids),
                                      page) // page
        r = usable - k_use
        if r <= 0:
            return []
        if not self._sched.cost.restore_cheaper(r, page):
            self._bump("kv_restore_skipped_cost")
            return []
        recs = []
        for h in hashes[k_use:k_use + r]:
            record = tier.store.get(h)
            if record is None:
                break   # LRU raced: restore the run still held
            recs.append(record)
        return recs

    def _restore_blocks(self, req: _Request, hashes: list, k_use: int,
                        recs: list, rec=None) -> int:
        """Copy host-tier blocks into the request's fresh pages: one copy
        per pool leaf (from pinned memory on the card) and one scatter
        (``_scatter_pages``: under tp every rank's heads of the
        whole-model blocks), eagerly on the serve stream ahead of the
        prompt's chunk programs, so the first chunk reads them in order.
        Their indices vary, so this is not captured. The blocks enter the
        prefix cache as if prefilled (one ref held by the request).
        Returns the pages restored."""
        page, r = self.cfg.page_size, len(recs)
        t0 = time.monotonic()
        faults.inject("kv.restore")
        arrays = KVTier.stack_blocks(recs)          # name -> (L, r, ...)
        pages = req.pages[k_use:k_use + r]
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self._scatter_pages(pages, arrays)
        dt = time.monotonic() - t0
        if events is not None:
            events[1].record()
            self._io_pending.append((r, events[0], events[1]))
        elif self._calib is not None:
            self._calib.observe_h2d(r, dt * 1e3)
        record_stage("engine_kv_restore", dt)
        tl = req.stream.timeline
        if tl is not None:
            tl.stage("engine_kv_restore", dt)
        for i, pg in enumerate(pages):
            h = hashes[k_use + i]
            parent = hashes[k_use + i - 1] if (k_use + i) else None
            if self._prefix_cache.insert(h, parent, pg):
                req.cache_refs.append(h)
                req.cache_pages.add(pg)
        with self._stats_lock:
            self._stats["kv_tier_restore_pages"] += r
            self._stats["kv_tier_restore_hits"] += 1
        if rec is not None:
            rec.kv_restore_pages += r
            rec.hbm_bytes += r * page * self._kv_bytes_per_token(local=False)
        return r

    def _collect_blocks(self, hashes: list, start: int, stop: int,
                        into_store: bool = True) -> list:
        """Serve-thread body of an export or a suspend: the records of
        ``hashes[start:stop]``, each from the host tier or gathered out of
        the pool (one gather and one blocking copy: a control operation,
        off the token path; long chains come in slices, so rounds run
        between them). Stops at the first block in neither tier."""
        tier = self._kv_tier
        out: list = []
        gather_meta: list = []   # (out index, hash, parent, page)
        for i in range(start, min(stop, len(hashes))):
            h = hashes[i]
            record = tier.store.peek(h)
            if record is not None:
                out.append(record)
                continue
            pg = (self._prefix_cache.page_of(h)
                  if self._prefix_cache is not None else None)
            if pg is None:
                break
            gather_meta.append((len(out), h, hashes[i - 1] if i else None,
                                pg))
            out.append(None)
        if gather_meta:
            host = {k: v.cpu() for k, v in self._gather_pages(
                [pg for *_, pg in gather_meta]).items()}
            records = KVTier.split_pages(
                host, [(h, par) for _, h, par, _ in gather_meta])
            for (i, *_), record in zip(gather_meta, records):
                out[i] = record
                if into_store:
                    tier.store.put(record)
        return [r for r in out if r is not None]

    def _require_tier(self) -> KVTier:
        if self._kv_tier is None:
            raise EngineError("KV tiering is disabled (KV_HOST_POOL_TOKENS=0)")
        return self._kv_tier

    def export_blob(self, hashes: Sequence[bytes],
                    max_blocks: Optional[int] = None) -> tuple[bytes, int]:
        """The leading cached blocks of a hash chain, serialized (at most
        ``max_blocks``, default the tier's slice size): (blob, blocks); an
        empty chain gives a blob of no blocks. The serve thread gathers,
        the caller's thread serializes."""
        tier = self._require_tier()
        cap = int(max_blocks or tier.transfer_max_pages)
        chain = list(hashes)
        recs = self._on_serve_thread(
            lambda: self._collect_blocks(chain, 0, cap))
        return kv_tier_mod.to_blob(recs, tier.meta), len(recs)

    def suspend_session(self, token_ids: Sequence[int]) -> Optional[bytes]:
        """Demote an idle conversation's prefix chain out of both tiers
        into a blob: its pool pages return to the free list and its host
        copies go. Blocks a live request still maps (or that another
        chain shares) stay where they are but go into the blob all the
        same. None when nothing of the chain is cached."""
        tier = self._require_tier()
        hashes = hash_blocks(list(token_ids), self.cfg.page_size)
        records: list = []
        step = max(1, tier.transfer_max_pages)
        for lo in range(0, len(hashes), step):
            batch = self._on_serve_thread(
                lambda lo=lo: self._collect_blocks(hashes, lo, lo + step,
                                                   into_store=False))
            records.extend(batch)
            if len(batch) < min(step, len(hashes) - lo):
                break   # the chain ended in this slice
        if not records:
            return None
        n = len(records)

        def demote() -> None:
            for h in reversed(hashes[:n]):   # leaf first
                tier.store.pop(h)
                pg = self._prefix_cache.remove(h)
                if pg is not None:
                    self._free_pages.append(pg)
            self._bump("kv_tier_suspended_blocks", n)
        self._on_serve_thread(demote)
        return kv_tier_mod.to_blob(records, tier.meta)

    def resume_session(self, blob: bytes) -> int:
        """Seed a suspended session's blocks into the host tier (no
        device work: the conversation's next admission restores them).
        Returns the blocks taken. A malformed blob (counted in
        ``kv_restore_corrupt``) or another geometry raises
        ``EngineError``."""
        tier = self._require_tier()
        try:
            meta, records = kv_tier_mod.from_blob(blob)
        except (ValueError, KeyError, TypeError) as exc:
            self._bump("kv_restore_corrupt")
            raise EngineError(f"malformed KV blob: {exc}") from exc
        if not tier.compatible(meta):
            raise EngineError(
                f"KV blob geometry does not match this engine (blob "
                f"{meta!r} vs engine {tier.meta!r})")
        n = sum(1 for record in records if tier.store.put(record))
        self._bump("kv_tier_resumed_blocks", n)
        return n

    def export_handoff(self, token_ids: Sequence[int]
                       ) -> Optional[tuple[bytes, int]]:
        """Serialize a finished prompt's whole prefix chain for the push to
        a decode replica (docs/disaggregation.md). Unlike
        ``suspend_session`` the pages stay resident (this replica still
        answers ``/control/kv_pages`` pulls for the prefix); unlike
        ``export_blob`` the chain is not capped, but collected in slices
        of the transfer cap, one serve-thread op each, so decode rounds
        run between them. Returns ``(blob, blocks)``, or None when
        nothing of the chain is cached. The serve thread gathers; the
        caller's thread serializes."""
        tier = self._require_tier()
        hashes = hash_blocks(list(token_ids), self.cfg.page_size)
        records: list = []
        step = max(1, tier.transfer_max_pages)
        for lo in range(0, len(hashes), step):
            batch = self._on_serve_thread(
                lambda lo=lo: self._collect_blocks(hashes, lo, lo + step))
            records.extend(batch)
            if len(batch) < min(step, len(hashes) - lo):
                break   # the chain ended in this slice
        if not records:
            return None
        self._bump("kv_tier_export_pages", len(records))
        return kv_tier_mod.to_blob(records, tier.meta), len(records)

    def _begin_prefill(self, req: _Request, rec=None) -> Optional[bool]:
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
        # The host tier: plan the priced restore of the chain's
        # continuation before eviction, so this admission's own offloads
        # cannot push its records out.
        restore_recs: list = []
        if self._kv_tier is not None and req.rag is None and hashes:
            restore_recs = self._plan_restore(req, hashes, k_use)
        need_new = n_alloc - k_use
        if need_new > len(self._free_pages):
            if self._prefix_cache is not None:
                victims: list = []
                sink = None
                if self._kv_tier is not None:
                    sink = (lambda h, e:
                            victims.append((h, e.parent, e.page)))
                self._free_pages.extend(self._prefix_cache.evict(
                    need_new - len(self._free_pages), sink=sink))
                self._offload_victims(victims, rec)
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
        restored = 0
        if restore_recs:
            try:
                restored = self._restore_blocks(req, hashes, k_use,
                                                restore_recs, rec)
            except Exception:  # noqa: BLE001 - falls back to recompute
                if self._fatal is not None:
                    raise     # a tp rank's collective failed
                # The pages may hold part of the copy: the prefill
                # recomputes over them from the pool-hit boundary.
                logger.warning("kv restore failed; recomputing the prefix",
                               exc_info=True)
        start_tok = (k_use + restored) * page
        req.proj_pos = req.base_len
        req.pf_pos = start_tok
        if self._prefix_cache is not None and req.rag is None:
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
        # The admission's sampling seed. A resume's is a function of its
        # replay offset alone, so the same seed continues the same way.
        salt = (((req.resume_offset + 1) << 20)
                if req.resume_offset is not None
                else next(self._step_counter) << 16)
        req.pf = {"row": row, "start_tok": start_tok, "hashes": hashes,
                  "k_use": k_use + restored, "seen0": seen0,
                  "dispatch_s": 0.0,
                  "seed": ((self.cfg.seed << 32) ^ salt
                           ^ req.params.random_seed)}
        # The queue wait, and the slack left at admission after the
        # modeled prefill of the uncached suffix (clamped at 0).
        now = time.monotonic()
        qwait = now - req.stream.submit_time
        record_stage("engine_admit_pickup", qwait)
        if req.deadline_t is not None:
            slack = (req.deadline_t - now) - self._sched.cost.prefill_s(
                req.base_len - start_tok)
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

    def _advance_prefill(self, req: _Request, grant: int
                         ) -> tuple[int, int]:
        """Admission, second half, once per round: run one prefill program
        for up to ``grant`` prompt tokens. A cold prompt that fits its
        grant keeps the one-program admission (``_admit_body``); otherwise
        a chunk padded to its bucket runs (``_chunk_extend_body``, or
        ``_chunk_final_body`` for the prompt's last tokens, which arms the
        slot); a fused-RAG request runs its program whole
        (``_dispatch_rag``). Returns (the prompt tokens prefilled, the
        tokens the program computed: its bucket)."""
        if req.rag is not None:
            return self._dispatch_rag(req)
        pf = req.pf
        if req.pf_pos > pf["start_tok"]:
            # Between chunks only: a started admission's first program
            # runs, and the harvest notices a cancel or a deadline at the
            # first token.
            if req.stream.cancelled:
                self._abort_prefill(req, "cancelled")
                return 0, 0
            if req.deadline_t is not None \
                    and time.monotonic() > req.deadline_t:
                self._bump("deadline_stops")
                self._abort_prefill(req, "deadline")
                return 0, 0
        total, page = len(req.prompt_ids), self.cfg.page_size
        n = min(grant, total - req.pf_pos, self._buckets[-1])
        final = req.pf_pos + n >= total
        if not final:
            n = (n // page) * page
            if n <= 0:
                return 0, 0
        C = self._bucket_for(n)
        seeding = req.pf_pos == pf["start_tok"] and pf["seen0"] is not None
        self._stage_admission(req, req.pf_pos, n, C,
                              pf["seen0"] if seeding else None)
        if final:
            self._admit_gen.manual_seed(pf["seed"])
            if self._recording:
                self._ops.append(("admit_seed", pf["seed"]))
        faults.inject("engine.dispatch")
        t0 = time.monotonic()
        if final and req.pf_pos == 0:
            self._replay(self._program_table("_admit_body"),
                         self._admit_body, C, req.greedy)
        elif final:
            self._replay(self._program_table("_chunk_final_body"),
                         self._chunk_final_body, C, req.greedy, seeding)
            self._bump("prefill_chunks")
        else:
            mode = ("seed" if seeding else
                    "replace" if req.pf_pos == 0 else "accum")
            self._replay(self._program_table("_chunk_extend_body"),
                         self._chunk_extend_body, C, mode)
            self._bump("prefill_chunks")
        pf["dispatch_s"] += time.monotonic() - t0
        self._bump("prefill_dispatches")
        req.pf_pos += n
        if final:
            self._arm_slot(req)
        return n, C

    def _dispatch_rag(self, req: _Request) -> tuple[int, int]:
        """A fused-RAG admission: retrieval, assembly and prefill are one
        program, so it runs whole whatever the grant (a grant cannot split
        an assembly done on the device; the scheduler charged the whole
        bucket). Its programs are captured first if no corpus upload has
        yet; then the page row and sampling inputs are staged as a
        one-shot admission's, the question into ``_rag_in``, the program
        runs, the aux row starts its copy into a pinned host buffer and
        the slot is armed. Returns (the bucket, the bucket)."""
        fused, pf = self._fused_rag, req.pf
        spec = fused.spec
        self._capture_rag()
        self._stage_admission(req, 0, 0, spec.bucket, None)
        q_llm, q_len, q_enc = req.rag
        host, dev_in = self._rag_in
        host[:q_enc.size] = q_enc.reshape(-1)
        host[q_enc.size:-1] = q_llm
        host[-1] = q_len
        self._host_to_device(dev_in, host)
        self._admit_gen.manual_seed(pf["seed"])
        if self._recording:
            self._ops.append(("admit_seed", pf["seed"]))
        faults.inject("engine.dispatch")
        t0 = time.monotonic()
        self._replay(self._rag_graphs, self._rag_body, req.greedy)
        pf["dispatch_s"] += time.monotonic() - t0
        cuda = self.device.type == "cuda"
        aux = torch.empty(self._rag_aux.shape, dtype=torch.int32,
                          pin_memory=cuda)
        aux.copy_(self._rag_aux, non_blocking=True)
        event = torch.cuda.Event() if cuda else None
        if event is not None:
            event.record()
        req.rag_aux = (aux, event)
        self._bump("prefill_dispatches")
        self._bump("rag_admissions")
        req.pf_pos = spec.bucket
        self._arm_slot(req)
        return spec.bucket, spec.bucket

    def _replay(self, table: dict, body, *key) -> None:
        """Run one device program: with graphs on, the replay of the
        capture ``table`` keeps under ``key`` (a missing one raises), else
        ``body(*key)`` eagerly (also for ``table`` None: a program that
        runs eagerly by design). A leader first sends its followers the
        program's header with the host writes staged since the last
        one."""
        if self._recording:
            ops, self._ops = self._ops, []
            comm.broadcast_header(("run", body.__name__, key, ops),
                                  self.mesh)
        span = self._span
        if span is not None and span[0] is None:
            span[0] = torch.cuda.Event(enable_timing=True)
            span[0].record()
        if self._graphs_on and table is not None:
            table[key].replay()
        else:
            body(*key)
        if span is not None:
            if span[1] is None:
                span[1] = torch.cuda.Event(enable_timing=True)
            span[1].record()

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

    def _host_to_device(self, dst: torch.Tensor, arr: np.ndarray,
                        record: bool = True) -> None:
        """Copy a host array into device state, in place. On the card it
        goes through a fresh pinned buffer, asynchronously (a copy from
        pageable memory would wait for every round in flight); the caching
        host allocator keeps that buffer until the copy has run, so each
        program in flight keeps its own source. A leader stages the
        write for its followers unless ``record`` is False (the caller
        sends the data another way)."""
        if self._recording and record:
            self._ops.append(("copy", self._state_name(dst), arr.copy()))
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
        faults.inject("engine.dispatch")
        members = self._armed()
        greedy = all(r.greedy for r in members.values())
        B = self.cfg.max_slots
        ba = self._ba_for(len(members))
        self._stage_act_idx(members)
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
        if self._tail_fused:
            self._bump("sampler_rows_sampled", ba * steps)
            self._bump("sampler_rows_skipped", (B - ba) * steps)

    def _stage_act_idx(self, members: dict) -> None:
        """Under the fused tail, the armed slots sorted and padded with B
        into ``act_idx``."""
        if self._tail_fused:
            B = self.cfg.max_slots
            act = np.full((B,), B, np.int32)
            act[:len(members)] = sorted(members)
            self._host_to_device(self._state["act_idx"], act)

    def _dispatch_verify(self, drafts: dict, rec=None) -> None:
        """One speculative verify round (the reference's
        ``_dispatch_verify``): every armed slot rides it, the slots in
        ``drafts`` with their proposals staged into ``drafts`` /
        ``n_draft``, the others as one-token rows. The page window is the
        smallest rung covering every scored position; the pipeline is
        drained, so ``proj_pos`` is exact. Its (S + 1, B) grid (the
        emitted tokens, then the accepted counts) goes to the harvest as
        one copy."""
        faults.inject("engine.dispatch")
        members = self._armed()
        S, B, page = self._spec_S, self.cfg.max_slots, self.cfg.page_size
        need = max(min(r.proj_pos + S, r.extent) + 1
                   for r in members.values())
        pages = min(_ceil_div(need, page), self._pmax)
        window = next(w for w in self._windows if w >= pages)
        greedy = all(r.greedy for r in members.values())
        ba = self._ba_for(len(members))
        self._stage_act_idx(members)
        draft_np = np.zeros((B, max(1, S - 1)), np.int32)
        n_np = np.zeros((B,), np.int32)
        drafted: dict[int, int] = {}
        for slot, toks in drafts.items():
            k = min(len(toks), S - 1)
            draft_np[slot, :k] = toks[:k]
            n_np[slot] = drafted[slot] = k
        self._host_to_device(self._state["drafts"], draft_np)
        self._host_to_device(self._state["n_draft"], n_np)
        t0 = time.monotonic()
        self._replay(self._verify_graphs, self._verify_body, window, greedy,
                     ba)
        dt = time.monotonic() - t0
        buf = self._ring.copy(self._state["round_tokens"][:S + 1],
                              self._alive)
        record_stage("engine_verify", dt)
        for req in members.values():
            if req.stream.timeline is not None:
                req.stream.timeline.stage("engine_verify", dt)
        if rec is not None:
            pages_read = sum(_ceil_div(r.proj_pos + 1, page)
                             for r in members.values())
            rec.decode_slots = len(members)
            rec.spec_drafted = sum(drafted.values())
            rec.verify_positions = S * len(members)
            rec.pages_touched += pages_read
            rec.hbm_bytes += (self._param_bytes + pages_read * page
                              * self._kv_bytes_per_token())
        for req in members.values():
            req.proj_pos = min(req.proj_pos + S, req.extent - 1)
        with self._pipe_lock:
            self._inflight_rounds += 1
            depth = self._inflight_rounds
        with self._stats_lock:
            self._stats["dispatch_depth_peak"] = max(
                self._stats["dispatch_depth_peak"], depth)
        self._post(("verify", members, buf, S + 1, rec, drafted))
        self._chunk_behind = False
        self._bump("decode_steps")
        self._bump("spec_verify_rounds")
        if self._tail_fused:
            self._bump("sampler_rows_sampled", ba * S)
            self._bump("sampler_rows_skipped", (B - ba) * S)

    def _finish_verify(self, members: dict, accs: list, drafted: dict,
                       emitted: dict) -> int:
        """The harvest's bookkeeping of one verify round: the spec
        stats, each request's draft and accept events and controller,
        and the ``proj_pos`` re-anchor (the dispatch raised it by the
        full S; ``base_len + generated - 1`` is the slot's exact device
        position). Returns the drafts accepted."""
        accept_total = 0
        for slot, req in members.items():
            k = drafted.get(slot, 0)
            a = min(int(accs[slot]), k)
            accept_total += a
            if k > 0 and req.spec_ctrl is not None:
                req.spec_ctrl.update(k, a)
            tl = req.stream.timeline
            if tl is not None and (k or emitted.get(slot)):
                tl.event("spec_drafted", k)
                tl.event("spec_accepted", a)
            if req.prefill_done and not req.done:
                req.proj_pos = min(req.extent - 1,
                                   req.base_len + req.generated - 1)
        with self._stats_lock:
            self._stats["spec_draft_tokens"] += sum(drafted.values())
            self._stats["spec_accepted_tokens"] += accept_total
            self._stats["spec_verify_tokens"] += sum(emitted.values())
            self._stats["spec_verify_slot_steps"] += sum(
                1 for n in emitted.values() if n)
        return accept_total

    def _emit_token(self, req: _Request, token: int, now: float) -> None:
        """Deliver one generated token, read back at host time ``now``
        (on the harvest thread, or the serve thread without one); finish
        the stream when the request ends and post it for the serve thread
        to retire. The finish rule mirrors the device-side termination, so
        host and device agree on each slot's last token."""
        req.generated += 1
        req.stream.token_ids.append(token)
        req.stream.token_times.append(now)
        if req.drafter is not None:
            # The prompt-lookup index follows the stream (drafts are only
            # proposed with every round read back).
            req.drafter.extend((token,))
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
        if self._recording:
            self._ops.append(("deactivate", req.slot))
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
