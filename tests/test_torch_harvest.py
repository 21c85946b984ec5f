"""The engine's harvest worker (``engine/engine.py``, ``dispatch_depth``)
on the CPU, over the golden-tiny checkpoint and its real sentencepiece
vocabulary (so detokenization and stop-word scanning do real work).

``dispatch_depth=2`` (a harvest thread reads each round back while the
next one is dispatched) must give ``dispatch_depth=1``'s greedy tokens,
text and finish reasons, exactly, under mixed traffic; a round's host
buffer is never refilled before it is read; a failing worker fails every
stream. Every wait is bounded, so a hang fails its test instead of
running out the suite's clock.
"""

import os
import threading
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine.engine import _HostRing
from generativeaiexamples_tpu_torch.engine.graphs import rung_for
from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY as CFG
from generativeaiexamples_tpu_torch.models.import_hf import load_checkpoint
from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
from generativeaiexamples_tpu_torch.utils.errors import (ConfigError,
                                                         EngineError)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tiny")
# Buckets capped at 32 tokens and a 48-token round budget: longer prompts
# go in chunks beside the decode rounds of 4 steps.
ENGINE_KW = dict(max_slots=3, max_input_length=128, max_output_length=48,
                 prefill_buckets=(32, 64, 128), page_size=16,
                 max_prefill_bucket=32, steps_per_round=4,
                 sched_round_budget_tokens=48, dtype="float32",
                 kv_pool_tokens=None)
LONG = ("Paged KV caching shares the pages of a prompt prefix between "
        "requests, so a follow-up that repeats a system prompt skips its "
        "prefill and only the new question is computed.")
TIMEOUT = 120


@pytest.fixture(scope="module")
def golden():
    params = load_checkpoint(GOLDEN, CFG, dtype=torch.float32, device="cpu")
    return params, get_tokenizer(GOLDEN)


def _within(seconds, fn, *args):
    """``fn(*args)`` in a thread; fails if it does not return in time."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{fn} did not return within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def _engine(golden, depth, **kw):
    params, tok = golden
    return Engine(params, CFG, tok, EngineConfig(
        **{**ENGINE_KW, **kw, "dispatch_depth": depth}), device="cpu")


def _stall_harvest(engine, depth):
    """Hold the harvest back until ``depth`` rounds were in flight at
    once (at most 30 s), so the serve thread fills the pipeline whatever
    the machine's speed."""
    real = engine._harvest

    def stalled(item):
        deadline = time.monotonic() + 30
        while (engine.stats["dispatch_depth_peak"] < depth
               and time.monotonic() < deadline):
            time.sleep(0.002)
        real(item)

    engine._harvest = stalled


def _serve(engine, batches):
    """Run ``batches`` of (prompt, SamplingParams) through the started
    engine, each batch after the previous one finished; returns the
    streams."""
    tok = engine.tokenizer
    out = []
    with engine:
        for batch in batches:
            streams = [engine.submit(tok.encode(p), sp) for p, sp in batch]
            for s in streams:
                _within(TIMEOUT, s.text)
            out.extend(streams)
    return out


def _mixed(stop_word):
    greedy = dict(top_k=1, ignore_eos=True)
    first = [
        (LONG, SamplingParams(max_tokens=10, **greedy)),     # chunked; ends
        ("Continuous batching admits", SamplingParams(        # mid-round
            max_tokens=30, top_k=1, stop_words=[stop_word])),
        ("The router sends each request", SamplingParams(max_tokens=6,
                                                         **greedy)),
    ]
    # A prefix hit: LONG's first pages are cached by then.
    second = [(LONG[:90] + " Then the scheduler", SamplingParams(
        max_tokens=9, **greedy)),
        ("Continuous batching admits", SamplingParams(max_tokens=30,
                                                      top_k=1))]
    return [first, second]


@pytest.fixture(scope="module")
def stop_word(golden):
    """A stop word that spans several tokens of the greedy continuation
    of the stop-word prompt, from its middle."""
    params, tok = golden
    with _engine(golden, 1) as eng:
        s = eng.submit(tok.encode("Continuous batching admits"),
                       SamplingParams(max_tokens=30, top_k=1))
        text = _within(TIMEOUT, s.text)
    word = text[len(text) // 3:len(text) // 3 + 9]
    assert len(tok.encode(word, add_bos=False)) >= 2, word
    return word


@pytest.mark.parametrize("depth,stall", [(2, False), (2, True), (3, True)],
                         ids=["depth2", "depth2-full", "depth3-full"])
def test_depths_give_the_same_tokens_and_finishes(golden, stop_word, depth,
                                                  stall):
    """Chunked admissions, a stop word across a multi-token burst,
    max_tokens ending mid-round and a prefix hit: the harvest worker's
    tokens, texts and finish reasons equal the in-line harvest's, each
    request's tokens in order (with the harvest held back until
    ``depth`` rounds were in flight, too)."""
    base = _serve(_engine(golden, 1), _mixed(stop_word))
    eng = _engine(golden, depth)
    if stall:
        _stall_harvest(eng, depth)
    got = _serve(eng, _mixed(stop_word))
    st = eng.stats
    assert [s.token_ids for s in got] == [s.token_ids for s in base]
    assert [s.text() for s in got] == [s.text() for s in base]
    assert [s.finish_reason for s in got] == [s.finish_reason for s in base]
    assert [s.finish_reason for s in base] == ["length", "stop", "length",
                                               "length", "length"]
    assert stop_word not in base[1].text() and len(base[1].token_ids) < 30
    assert all(s.token_times == sorted(s.token_times) for s in got)
    assert st["prefill_chunks"] >= 3 and st["prefix_cache_hits"] >= 1
    assert st["dispatch_queue_depth"] == 0 and st["active_slots"] == 0
    assert st["free_pages"] == st["pool_pages"]
    if stall:
        assert st["dispatch_depth_peak"] == depth
    assert _engine(golden, 1).stats["dispatch_depth_peak"] == 0


def test_a_full_pipeline_queues_one_chunk_step_between_rounds(golden):
    """A long prompt admitted while a stream decodes, with the harvest
    holding the pipeline full: a chunk may take the place of the round
    the shut gate holds back (so the prompt waits for no extra round),
    granted no more than what is left beside a round, and at most one
    such chunk step queues between two rounds (chunks back to back would
    stall the stream); the tokens equal the in-line engine's."""
    tok = golden[1]
    greedy = dict(top_k=1, ignore_eos=True)
    budget = ENGINE_KW["sched_round_budget_tokens"]
    page = ENGINE_KW["page_size"]

    def run(depth):
        eng = _engine(golden, depth)
        plans, box = [], {}
        plan_round = eng._plan_round

        def recorded():
            armed = eng._armed()
            need = max((r.extent - 1 - r.proj_pos for r in armed.values()),
                       default=0)
            plan = plan_round()
            plans.append((need, plan.decode_steps, len(armed),
                          sum(g for _, g in plan.chunks)))
            return plan

        eng._plan_round = recorded

        def arrive():
            box["b"] = eng.submit(tok.encode(LONG + " " + LONG),
                                  SamplingParams(max_tokens=8, **greedy))

        if depth > 1:
            # Each harvest waits (up to 0.3 s) for a full pipeline and
            # then three more plans, so the serve thread keeps meeting a
            # shut gate. The long prompt arrives during such a hold, once
            # the stream has tokens, and the hold lasts until the serve
            # thread planned with it: it meets a shut gate whatever the
            # machine's speed.
            real = eng._harvest

            def held(item):
                n0, deadline = len(plans), time.monotonic() + 0.3
                while ((eng._inflight_rounds < depth or len(plans) < n0 + 3)
                       and time.monotonic() < deadline):
                    time.sleep(0.001)
                a = box.get("a")
                if ("b" not in box and a is not None
                        and len(a.token_ids) >= 2
                        and eng._inflight_rounds >= depth):
                    arrive()
                    n0, deadline = len(plans), time.monotonic() + 0.3
                    while len(plans) < n0 + 2 and time.monotonic() < deadline:
                        time.sleep(0.001)
                real(item)

            eng._harvest = held
        with eng:
            a = box["a"] = eng.submit(tok.encode("Continuous batching admits"),
                                      SamplingParams(max_tokens=40, **greedy))
            deadline = time.monotonic() + TIMEOUT
            while len(a.token_ids) < 2:
                assert time.monotonic() < deadline, "no tokens"
                time.sleep(0.002)
            if depth == 1:
                arrive()
            while "b" not in box:
                assert time.monotonic() < deadline, "the prompt never arrived"
                time.sleep(0.002)
            for s in (a, box["b"]):
                _within(TIMEOUT, s.text)
        return [a.token_ids, box["b"].token_ids], plans, eng.stats

    want, _, _ = run(1)
    got, plans, st = run(2)
    assert got == want
    assert st["prefill_chunks"] >= 3 and st["dispatch_depth_peak"] == 2
    # What the plans dispatched while the stream needed steps, in order:
    # a round, then the chunks beside it, or chunks in a gated round's
    # place. Never two chunk steps without a round between them.
    kinds = [k for need, steps, _, granted in plans if need > 0
             for k in ["round"] * bool(steps) + ["chunk"] * bool(granted)]
    alone = [i for i, (need, steps, _, granted) in enumerate(plans)
             if need > 0 and granted and not steps]
    assert alone, kinds
    assert all(k == "round" for k, prev in zip(kinds[1:], kinds)
               if prev == "chunk"), kinds
    for need, steps, armed, granted in plans:
        if need > 0 and granted and not steps:
            rung = rung_for(ENGINE_KW["steps_per_round"], need)
            assert granted <= max(budget - rung * armed, page), plans
    assert st["sched_interleaved_rounds"] + len(alone) >= 3


@pytest.mark.parametrize("depth", [1, 2])
def test_arrival_ttft_measurement(golden, depth):
    """``profile_decode.measure_arrival_ttft`` times each request that
    arrives beside decoding streams to its first token, and leaves the
    engine idle with every slot and page free."""
    from generativeaiexamples_tpu_torch.tools.profile_decode import \
        measure_arrival_ttft

    eng = _engine(golden, depth, max_output_length=300)
    out = _within(TIMEOUT, measure_arrival_ttft, eng, depth, 2, 40, 20, 3,
                  0.01)
    assert out["dispatch_depth"] == depth and len(out["ttft_ms"]) == 3
    assert all(t > 0 for t in out["ttft_ms"])
    assert not eng._slots and eng._harvest_thread is None
    assert eng.stats["free_pages"] == eng.stats["pool_pages"]
    assert 1 <= eng.stats["dispatch_depth_peak"] <= depth


class _HostToDevice(TorchDispatchMode):
    """Records the operations by which host code reads a device value
    (``.item()``, ``bool()``, ``nonzero``) or copies a host value into
    device state synchronously: a Python scalar assigned by index is
    lifted to a host tensor and copied with ``non_blocking=False``, on
    the card from pageable memory, which waits for every round in
    flight. The staged admission inputs are lifted too, but copied
    ``non_blocking`` (through pinned buffers on the card)."""

    BAD = ("_local_scalar_dense", "is_nonzero", "nonzero")

    def __init__(self):
        super().__init__()
        self.seen, self.lifted = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        if any(b in name for b in self.BAD):
            self.seen.append(name)
        if (name.startswith("copy_") and not kwargs.get(
                "non_blocking", args[2] if len(args) > 2 else False)
                and any(args[1] is t for t in self.lifted)):
            self.seen.append(name)
        out = func(*args, **kwargs)
        if name.startswith("lift_fresh"):
            self.lifted.append(out)
        return out


@pytest.mark.parametrize("how,finish", [("finish", "length"),
                                        ("cancel", "cancelled"),
                                        ("stop", "cancelled")])
def test_the_serve_loop_copies_no_host_value_to_the_device(golden, how,
                                                           finish):
    """A request's whole life on the serve thread (admission in chunks,
    rounds, the finish, a cancel or a stop, its retirement) reads no
    device value and copies no host value into device state
    synchronously, so the serve thread never waits for the rounds in
    flight."""
    tok = golden[1]
    eng = _engine(golden, 1)
    stream = eng.submit(tok.encode(LONG), SamplingParams(
        max_tokens=6 if how == "finish" else 40, top_k=1, ignore_eos=True))
    with _HostToDevice() as mode:
        for _ in range(40):
            if len(stream.token_ids) >= 2 and how == "cancel":
                stream.cancel()
            if len(stream.token_ids) >= 2 and how == "stop":
                eng.stop()
            if eng.stats["active_slots"] == 0 and stream.finish_reason:
                break
            eng._step()
    assert stream.finish_reason == finish
    assert eng.stats["active_slots"] == 0 and not eng._state["active"].any()
    assert len(mode.lifted) >= 2 and mode.seen == [], mode.seen


def test_inline_harvest_peaks_at_one(golden):
    eng = _engine(golden, 1)
    _serve(eng, [[("Paged KV", SamplingParams(max_tokens=9, top_k=1,
                                              ignore_eos=True))]])
    assert eng.stats["dispatch_depth_peak"] == 1
    assert eng._harvest_thread is None
    with pytest.raises(ConfigError, match="dispatch_depth"):
        EngineConfig(dispatch_depth=0)


def test_cancel_with_a_round_in_flight(golden):
    """A cancel while rounds are in flight ends the stream "cancelled"
    with a prefix of the uncancelled tokens, and the slot, its pages and
    its device flag are freed."""
    tok = golden[1]
    sp = SamplingParams(max_tokens=40, top_k=1, ignore_eos=True)
    prompt = tok.encode("Continuous batching admits")
    with _engine(golden, 1) as ref:
        full = ref.submit(prompt, sp)
        _within(TIMEOUT, full.text)
    eng = _engine(golden, 2)
    real, go = eng._harvest, threading.Event()
    box = {}

    def held(item):
        # Past 6 tokens the harvest waits for the cancel: the round it
        # holds is in flight when the cancel comes.
        s = box.get("stream")
        if s is not None and len(s.token_ids) >= 6:
            go.wait(TIMEOUT)
        real(item)

    eng._harvest = held
    with eng:
        s = box["stream"] = eng.submit(prompt, sp)
        deadline = time.monotonic() + TIMEOUT
        while len(s.token_ids) < 6 or not eng.stats["dispatch_queue_depth"]:
            assert time.monotonic() < deadline, "no round in flight"
            time.sleep(0.002)
        s.cancel()
        go.set()
        _within(TIMEOUT, s.text)
        while eng.stats["active_slots"]:
            assert time.monotonic() < deadline, "the slot was not freed"
            time.sleep(0.005)
    assert s.finish_reason == "cancelled"
    assert 6 <= len(s.token_ids) < 40
    assert s.token_ids == full.token_ids[:len(s.token_ids)]
    assert not eng._state["active"].any()
    assert eng.stats["free_pages"] == eng.stats["pool_pages"]


def test_a_round_buffer_is_never_refilled_before_it_is_read(golden):
    """With the pipeline full, every copy the serve thread starts lands
    in a buffer whose previous tokens were already read."""
    eng = _engine(golden, 2)
    _stall_harvest(eng, 2)
    ring = eng._ring
    unread, clashes, lock = set(), [], threading.Lock()
    copy, read = ring.copy, ring.read

    def tracked_copy(src, alive):
        i = copy(src, alive)
        with lock:
            if i in unread:
                clashes.append(i)
            unread.add(i)
        return i

    def tracked_read(i, rows):
        out = read(i, rows)
        with lock:
            unread.discard(i)
        return out

    ring.copy, ring.read = tracked_copy, tracked_read
    greedy = dict(top_k=1, ignore_eos=True)
    streams = _serve(eng, [[
        ("Paged KV caching", SamplingParams(max_tokens=40, **greedy)),
        ("The router", SamplingParams(max_tokens=33, **greedy))]])
    assert [len(s.token_ids) for s in streams] == [40, 33]
    assert not clashes and not unread
    assert eng.stats["dispatch_depth_peak"] == 2


def test_host_ring_waits_for_a_buffer_to_be_read():
    """The ring hands buffers out in turn; copying into a buffer whose
    tokens are unread waits until they are read (or ``alive`` raises)."""
    ring = _HostRing(2, (4, 3), torch.device("cpu"))
    a = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    assert ring.copy(a, lambda: None) == 0
    assert ring.copy(a + 100, lambda: None) == 1
    done = threading.Event()
    box = {}

    def third():
        box["i"] = ring.copy(a[:1] + 500, lambda: None)
        done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not done.wait(0.3)             # buffer 0 is still unread
    assert ring.read(0, 4) == a.tolist()
    assert done.wait(10) and box["i"] == 0
    assert ring.read(1, 4) == (a + 100).tolist()
    assert ring.read(0, 1) == [[500, 501, 502]]

    def dead():
        raise EngineError("dead")

    ring.copy(a, lambda: None)
    ring.copy(a, lambda: None)
    with pytest.raises(EngineError, match="dead"):
        _within(10, ring.copy, a, dead)
    ring.reset()
    ring.copy(a, dead)                    # every buffer free: no wait


def test_a_failing_worker_fails_every_stream(golden):
    """An exception in the harvest worker becomes the engine's fatal
    error: every live stream raises, a new request is refused, and
    ``stop()`` returns."""
    eng = _engine(golden, 2)
    real, calls = eng._harvest, []

    def failing(item):
        calls.append(item[0])
        if len(calls) == 3:
            raise RuntimeError("injected harvest failure")
        real(item)

    eng._harvest = failing
    tok = eng.tokenizer
    sp = SamplingParams(max_tokens=40, top_k=1, ignore_eos=True)
    eng.start()
    streams = [eng.submit(tok.encode(p), sp) for p in
               ("Paged KV", "Continuous batching", "The router")]
    for s in streams:
        with pytest.raises(EngineError):
            _within(TIMEOUT, s.text)
        assert s.finish_reason == "error"
    with pytest.raises(EngineError, match="dead"):
        eng.submit(tok.encode("again"), sp)
    _within(TIMEOUT, eng.stop)
    assert eng._harvest_thread is None and eng._thread is None
    assert isinstance(eng._fatal, RuntimeError)
