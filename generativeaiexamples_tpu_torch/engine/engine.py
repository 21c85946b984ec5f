"""Continuous-batching inference engine over a paged KV pool — the reduced
port of the reference's ``engine/engine.py``.

- **Decode slots.** ``max_slots`` requests decode together; every decode
  step runs the whole slot batch, inactive slots masked. Requests join and
  leave between rounds.
- **Paged KV pool.** KV lives in a pool of fixed-size pages shared through
  per-slot block tables. Admission allocates a request's whole extent
  (prompt + max_tokens) and waits when the pool is exhausted. Physical
  page 0 is the trash page: inactive slots and prefill-bucket overhang
  write there, and no live slot ever reads it.
- **Bucketed prefill.** A prompt is padded to the nearest bucket (a page
  multiple), prefilled into a dense cache, and its KV scattered into the
  slot's pages (``_prefill`` + ``_insert``).
- **Multi-step decode rounds.** Each round runs ``steps_per_round`` decode
  steps with device-side eos/length termination; tokens come back to the
  host once per round (``_decode_round``). On CUDA each layer of each step
  launches the hand-written paged-attention kernel.

One serve thread plans, dispatches and harvests. Waiting for later
slices: prefix cache, chunked prefill, speculative decoding, the KV tier,
roles, the watchdog, the flight recorder, the calibrated scheduler and the
fused vocab-tiled sampler (the materialized sampling tail runs instead).
"""

from __future__ import annotations

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
from ..models.tokenizer import Tokenizer
from ..ops.paged_attention import kernel_supported
from ..ops.sampling import (NEG_INF, apply_repetition_penalty, mask_words,
                            pack_mask, pack_mask_np, sample, seen_mask,
                            set_token_bits, unpack_mask)
from ..utils.device import resolve_device
from ..utils.errors import ConfigError, EngineError, SchedulerFullError
from .detokenizer import IncrementalDetokenizer, StopWordTrap
from .sampling_params import SamplingParams

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


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

    def __post_init__(self) -> None:
        if self.page_size <= 0:
            raise ConfigError(f"page_size={self.page_size} must be > 0")
        if self.dtype not in _DTYPES:
            raise ConfigError(f"dtype={self.dtype!r} not supported; use one "
                              f"of {sorted(_DTYPES)}")
        if self.max_slots < 1 or self.steps_per_round < 1:
            raise ConfigError("max_slots and steps_per_round must be >= 1")
        if not (self.kv_pool_tokens is None or self.kv_pool_tokens == "auto"
                or isinstance(self.kv_pool_tokens, int)):
            raise ConfigError(f"kv_pool_tokens={self.kv_pool_tokens!r}: use "
                              f"'auto', None or a token count")

    @property
    def max_cache_len(self) -> int:
        return self.max_input_length + self.max_output_length


class TokenStream:
    """Thread-safe stream of text chunks for one request."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._q: "queue.Queue[tuple[str, object]]" = queue.Queue()
        self._error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        self.token_ids: list[int] = []
        self.submit_time = time.monotonic()
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.cancelled = False

    def _put_chunk(self, text: str) -> None:
        if text:
            self._q.put(("chunk", text))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self.finish_time = time.monotonic()
        self._q.put(("done", reason))

    def _fail(self, exc: BaseException) -> None:
        self._error = exc   # sticky: re-iteration re-raises, never hangs
        self.finish_reason = "error"
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

    @property
    def done(self) -> bool:
        return self.stream.finish_reason is not None


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
        self._buckets = tuple(sorted(
            {page_up(min(b, cfg.max_input_length))
             for b in cfg.prefill_buckets}
            | {page_up(cfg.max_input_length)}))
        if self.device.type == "cuda" and not kernel_supported(
                page, model_cfg.num_heads, model_cfg.num_kv_heads,
                model_cfg.head_dim):
            raise ConfigError(
                f"the paged decode kernel does not take heads "
                f"{model_cfg.num_heads}/{model_cfg.num_kv_heads}, head_dim "
                f"{model_cfg.head_dim}, page {page}")

        self._n_pages = 1 + self._resolve_pool_pages()
        self._free_pages = list(range(1, self._n_pages))
        self._state = self._init_device_state()
        self._step_counter = itertools.count()
        self._round_gen = torch.Generator(device=self.device)
        self._round_gen.manual_seed(cfg.seed)

        self._slots: dict[int, _Request] = {}
        self._free_slots = list(range(cfg.max_slots))
        self._pending: "queue.Queue[_Request]" = queue.Queue(
            maxsize=cfg.max_queue)
        self._backlog: list[_Request] = []
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        self._ids = itertools.count()
        self._stats_lock = threading.Lock()
        self._stats: dict[str, float] = {
            "requests": 0, "prefills": 0, "decode_rounds": 0,
            "decode_steps": 0, "tokens_generated": 0, "rejected_full": 0}

    # -------------------------------------------------------------- sizing

    def _kv_bytes_per_token(self) -> int:
        m = self.model_cfg
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
        # and activations).
        free, _ = torch.cuda.mem_get_info(self.device)
        m, S = self.model_cfg, self._buckets[-1]
        reserve = (2 * S * self._kv_bytes_per_token()
                   + 4 * m.hidden_size * m.vocab_size
                   + 64 * S * m.hidden_size + (512 << 20))
        pages = int(0.9 * (free - reserve)) // (
            cfg.page_size * self._kv_bytes_per_token())
        return min(full, max(self._pmax, pages))

    def _init_device_state(self) -> dict[str, torch.Tensor]:
        """Device-side slot state plus the page pool."""
        B, dev = self.cfg.max_slots, self.device
        Wn = mask_words(self.model_cfg.vocab_size)

        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "cache": llama.init_paged_kv_cache(
                self.model_cfg, self._n_pages, self.cfg.page_size,
                self._dtype, device=dev),
            "table": z(B, self._pmax),
            "pos": z(B), "last_token": z(B), "remaining": z(B),
            "active": z(B, dtype=torch.bool),
            "eos_ok": z(B, dtype=torch.bool),
            "temp": z(B, dtype=torch.float32),
            "top_k": z(B),
            "top_p": z(B, dtype=torch.float32),
            "rep_pen": torch.ones((B,), dtype=torch.float32, device=dev),
            "seen": z(B, Wn, dtype=torch.int64),
            "banned": z(B, Wn, dtype=torch.int64),
            "bad_seq": torch.full((B, self.MAX_BAD_SEQS, self.MAX_BAD_LEN),
                                  -1, dtype=torch.int32, device=dev),
            "bad_len": z(B, self.MAX_BAD_SEQS),
            "recent": torch.full((B, self.MAX_BAD_LEN - 1), -1,
                                 dtype=torch.int32, device=dev),
        }

    @property
    def stats(self) -> dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
        out["queue_waiting"] = len(self._backlog) + self._pending.qsize()
        out["active_slots"] = len(self._slots)
        out["free_pages"] = len(self._free_pages)
        out["pool_pages"] = self._n_pages - 1
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    # ------------------------------------------------------ device functions

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor, length: int, sp: SamplingParams,
                 banned: torch.Tensor, generator: torch.Generator,
                 greedy: bool):
        """tokens: (1, S_bucket) on the device. Returns the bucket's dense
        K/V (L, 1, S, KV, hd), the first token (a 0-d device tensor) and
        the prompt's seen mask as packed (Wn,) words."""
        mcfg, dev = self.model_cfg, self.device
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        cache = llama.init_kv_cache(mcfg, 1, S, self._dtype, device=dev)
        length_t = torch.tensor([length], dtype=torch.int32, device=dev)
        hn, cache = llama.apply(self.params, mcfg, tokens, positions, cache,
                                kv_valid_len=length_t, return_hidden=True)
        # Only the last prompt row is projected (the reference projects
        # every row and takes this one).
        last = llama.project_logits(self.params, hn[:, length - 1])  # (1, V)
        V = mcfg.vocab_size
        seen = seen_mask(tokens, length_t, V)                         # (1, V)
        rep = torch.tensor([sp.repetition_penalty], dtype=torch.float32,
                           device=dev)
        last = apply_repetition_penalty(last, seen, rep)
        last = torch.where(unpack_mask(banned, V)[None, :],
                           torch.full_like(last, NEG_INF), last)
        if greedy:
            first = last[0].float().argmax().to(torch.int32)
        else:
            first = sample(
                last,
                torch.tensor([sp.temperature], dtype=torch.float32,
                             device=dev),
                torch.tensor([sp.top_k], dtype=torch.int32, device=dev),
                torch.tensor([sp.top_p], dtype=torch.float32, device=dev),
                generator)[0]
        seen = seen[0].clone()
        seen[first.long()] = True
        return cache["k"], cache["v"], first, pack_mask(seen)

    @torch.no_grad()
    def _insert(self, k_new: torch.Tensor, v_new: torch.Tensor, slot: int,
                length: int, first: torch.Tensor, seen: torch.Tensor,
                req: _Request, banned: torch.Tensor) -> None:
        """Scatter a prefilled bucket into the slot's pages and arm the
        slot. Page-table entries past the allocated extent are 0, so the
        bucket's overhang lands in the trash page. The pool and the slot
        state are updated in place (the reference returned a new state
        from a donated jit)."""
        mcfg, st, dev = self.model_cfg, self._state, self.device
        page, L = self.cfg.page_size, mcfg.num_layers
        sp = req.params
        row = np.zeros((self._pmax,), np.int32)
        row[:len(req.pages)] = req.pages
        row_t = torch.from_numpy(row).to(dev)
        S = k_new.shape[2]
        nb = S // page
        dest = row_t[:nb].long()
        # (L, 1, S, KV, hd) -> (L, nb, KV, page, hd): KV heads ahead of the
        # page dim, the pool's layout.
        for name, new in (("k", k_new), ("v", v_new)):
            blocks = new.reshape(L, nb, page, mcfg.num_kv_heads,
                                 mcfg.head_dim).transpose(2, 3)
            st["cache"][name][:, dest] = blocks.to(st["cache"][name].dtype)
        eos = int(self.tokenizer.eos_id)
        eos_ok = not sp.ignore_eos
        remaining = req.eff_max - 1
        # A slot whose first token already ends it (eos, or max_tokens
        # == 1) never activates.
        active = torch.tensor(remaining > 0, device=dev) & ~(
            (first == eos) & eos_ok)
        st["table"][slot] = row_t
        st["pos"][slot] = length
        st["last_token"][slot] = first
        st["active"][slot] = active
        st["remaining"][slot] = remaining
        st["eos_ok"][slot] = eos_ok
        st["temp"][slot] = sp.temperature
        st["top_k"][slot] = sp.top_k
        st["top_p"][slot] = sp.top_p
        st["rep_pen"][slot] = sp.repetition_penalty
        st["seen"][slot] = seen
        st["banned"][slot] = banned
        st["bad_seq"][slot] = torch.from_numpy(req.bad_seq_np).to(dev)
        st["bad_len"][slot] = torch.from_numpy(req.bad_len_np).to(dev)
        # Sequence bans match generated tokens only: a fresh ring seeded
        # with the first sampled token.
        st["recent"][slot] = -1
        st["recent"][slot, -1] = first

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

    @torch.no_grad()
    def _decode_round(self, steps: int, greedy: bool) -> torch.Tensor:
        """``steps`` decode steps over every slot; returns (steps, B) int32
        tokens with -1 for slots inactive at step entry. eos and length
        stops happen on the device (``active`` drops), so the host reads
        the tokens once per round. Attention takes the whole block table:
        the kernel loops over each slot's live pages only (the reference's
        gather path sliced a page window instead). The pool is updated in
        place by each layer's attention call; the slot state is replaced
        step by step (the reference carried both through a scan)."""
        st, mcfg = self._state, self.model_cfg
        page, V = self.cfg.page_size, mcfg.vocab_size
        eos = int(self.tokenizer.eos_id)
        out = []
        for _ in range(steps):
            pos, active = st["pos"], st["active"]
            # A retired slot's stale pos may point past its table: clamp
            # (the reference's gather clamps), the row is masked anyway.
            pidx = (pos // page).clamp(max=self._pmax - 1).long()
            page_of = torch.gather(st["table"], 1, pidx[:, None])[:, 0]
            wp = torch.where(active, page_of, torch.zeros_like(page_of))
            # Inactive slots attend over nothing (length 0) and write the
            # trash page.
            eff_pos = torch.where(active, pos, torch.zeros_like(pos))
            logits, _ = llama.apply_decode_paged(
                self.params, mcfg, st["last_token"][:, None],
                eff_pos[:, None], st["cache"], st["table"], wp,
                eff_pos % page)
            pen = apply_repetition_penalty(
                logits[:, 0], unpack_mask(st["seen"], V), st["rep_pen"])
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
                tok = pen.float().argmax(dim=-1).to(torch.int32)
            else:
                tok = sample(pen, st["temp"], st["top_k"], st["top_p"],
                             self._round_gen)
            out.append(torch.where(active, tok, torch.full_like(tok, -1)))
            remaining = torch.where(active, st["remaining"] - 1,
                                    st["remaining"])
            finished = active & (((tok == eos) & st["eos_ok"])
                                 | (remaining <= 0))
            st = dict(
                st,
                pos=torch.where(active, pos + 1, pos),
                last_token=torch.where(active, tok, st["last_token"]),
                active=active & ~finished,
                remaining=remaining,
                seen=set_token_bits(st["seen"], tok, active),
                recent=torch.where(
                    active[:, None],
                    torch.cat([st["recent"][:, 1:], tok[:, None]], dim=1),
                    st["recent"]))
        self._state = st
        return torch.stack(out)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is None:
            self._stopped.clear()
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
        # Cancel what is still live so no consumer blocks forever, and
        # deactivate the slots so a restart reuses no live pages.
        for req in list(self._slots.values()):
            self._state["active"][req.slot] = False
            self._retire(req, "cancelled")
        for req in self._drain_intake():
            if not req.done:
                req.stream._finish("cancelled")

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

    def submit(self, prompt_ids: Sequence[int],
               params: Optional[SamplingParams] = None,
               request_id: Optional[str] = None) -> TokenStream:
        """Enqueue a request; returns its stream immediately."""
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
        stream = TokenStream(request_id or f"req-{next(self._ids)}")
        req = _Request(stream=stream, prompt_ids=ids, params=params,
                       detok=IncrementalDetokenizer(self.tokenizer),
                       stop=StopWordTrap(params.stop_words),
                       eff_max=eff_max, extent=len(ids) + eff_max,
                       greedy=(params.top_k == 1 or params.temperature <= 0),
                       banned_np=pack_mask_np(banned_row),
                       bad_seq_np=seq_tbl, bad_len_np=seq_len)
        if len(self._backlog) + self._pending.qsize() >= self.cfg.max_queue:
            self._reject_full()
        try:
            self._pending.put_nowait(req)
        except queue.Full:
            self._reject_full()
        if self._fatal is not None:
            stream._fail(self._fatal)
        self._bump("requests")
        self._wake.set()
        return stream

    def _reject_full(self) -> None:
        self._bump("rejected_full")
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
                    request_id: Optional[str] = None) -> TokenStream:
        self.start()
        return self.submit(self.tokenizer.encode(prompt), params,
                           request_id=request_id)

    # ------------------------------------------------------------ scheduler

    def _bucket_for(self, n: int) -> int:
        return next((b for b in self._buckets if n <= b), self._buckets[-1])

    def _drain_intake(self) -> list[_Request]:
        out, self._backlog = self._backlog, []
        while True:
            try:
                out.append(self._pending.get_nowait())
            except queue.Empty:
                return out

    def _run(self) -> None:
        """Serve thread: retire, admit, run one decode round, harvest."""
        try:
            while not self._stopped.is_set():
                if not self._step():
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
        except BaseException as exc:  # noqa: BLE001 - report to all streams
            self._fatal = exc
            for req in list(self._slots.values()) + self._drain_intake():
                if not req.done:
                    req.stream._fail(exc)

    def _step(self) -> bool:
        """One iteration of the serve loop; False when there was nothing
        to do."""
        did = False
        for req in [r for r in self._slots.values() if r.done]:
            self._release(req)
            did = True
        while True:
            try:
                self._backlog.append(self._pending.get_nowait())
            except queue.Empty:
                break
        firsts: list[tuple[_Request, torch.Tensor]] = []
        while self._backlog and self._free_slots:
            req = self._backlog[0]
            if req.stream.cancelled:
                self._backlog.pop(0)
                req.stream._finish("cancelled")
                did = True
                continue
            first = self._admit(req)
            if first is None:
                break  # pool backpressure: wait for pages to free
            self._backlog.pop(0)
            firsts.append((req, first))
        if firsts:
            # First tokens go to the host before the round, so a request's
            # time to first token is its prefill, not prefill + a round.
            host = torch.stack([f for _, f in firsts]).cpu().numpy()
            for (req, _), tok in zip(firsts, host):
                if not req.done:
                    self._emit_token(req, int(tok))
        toks, members = self._dispatch_round()
        if toks is None:
            return did or bool(firsts)
        grid = toks.cpu().numpy()   # the round's one device->host transfer
        for k in range(grid.shape[0]):
            for slot, req in members.items():
                tok = int(grid[k, slot])
                if tok >= 0 and not req.done:
                    self._emit_token(req, tok)
        return True

    def _admit(self, req: _Request) -> Optional[torch.Tensor]:
        """Allocate a slot and pages, prefill and insert. Returns the first
        token (a device scalar), or None when the pool is exhausted."""
        page = self.cfg.page_size
        n_alloc = _ceil_div(req.extent, page)
        if n_alloc > len(self._free_pages):
            return None
        req.slot = self._free_slots.pop()
        req.pages = [self._free_pages.pop() for _ in range(n_alloc)]
        req.proj_pos = len(req.prompt_ids)
        sp = req.params
        total = len(req.prompt_ids)
        bucket = self._bucket_for(total)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :total] = req.prompt_ids
        tokens = torch.from_numpy(ids).to(self.device)
        banned = torch.from_numpy(req.banned_np).to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.cfg.seed << 32)
                        ^ (next(self._step_counter) << 16) ^ sp.random_seed)
        k_new, v_new, first, seen = self._prefill(
            tokens, total, sp, banned, gen, req.greedy)
        self._insert(k_new, v_new, req.slot, total, first, seen, req, banned)
        self._slots[req.slot] = req
        self._bump("prefills")
        return first

    def _dispatch_round(self):
        """Run one decode round over the armed slots, right-sized against
        the power-of-two step ladder. Returns ((steps, B) device tokens,
        members) or (None, {}) when no slot needs tokens."""
        members = {s: r for s, r in self._slots.items() if not r.done}
        # proj_pos is the device pos after the last dispatched step; the
        # first token came from prefill, so extent - 1 - proj_pos steps
        # remain at most.
        need_steps = max((r.extent - 1 - r.proj_pos
                          for r in members.values()), default=0)
        if need_steps <= 0:
            return None, {}
        steps = self.cfg.steps_per_round
        while steps // 2 >= need_steps:
            steps //= 2
        greedy = all(r.greedy for r in members.values())
        toks = self._decode_round(steps, greedy)
        for req in members.values():
            req.proj_pos = min(req.proj_pos + steps, req.extent - 1)
        self._bump("decode_rounds")
        self._bump("decode_steps", steps)
        return toks, members

    def _emit_token(self, req: _Request, token: int) -> None:
        """Deliver one generated token; finish the stream when the request
        ends. The finish rule mirrors the device-side termination, so host
        and device agree on each slot's last token."""
        req.generated += 1
        req.stream.token_ids.append(token)
        self._bump("tokens_generated")
        if req.stream.first_token_time is None:
            req.stream.first_token_time = time.monotonic()
        finish: Optional[str] = None
        if token == self.tokenizer.eos_id and not req.params.ignore_eos:
            finish = "eos"
        elif req.generated >= req.eff_max:
            finish = "length"
        if req.stream.cancelled and finish is None:
            finish = "cancelled"
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

    def _release(self, req: _Request) -> None:
        """Deactivate a finished request's slot on the device (a
        host-detected finish such as a stop word leaves it live there),
        then return its slot and pages."""
        self._state["active"][req.slot] = False
        self._retire(req, req.stream.finish_reason or "cancelled")

    def _retire(self, req: _Request, finish: str) -> None:
        del self._slots[req.slot]
        self._free_slots.append(req.slot)
        self._free_pages.extend(req.pages)
        req.pages = []
        if not req.done:
            req.stream._finish(finish)
