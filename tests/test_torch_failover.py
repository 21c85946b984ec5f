"""The port's mid-stream failover (the router's transcript replay over the
engine's resume) on the CPU: the scenarios of the reference's
``tests/test_failover.py`` over port replicas.

Unit: the router's per-request ``Transcript`` (UTF-8 boundary holdback,
overflow and non-UTF-8 opt-out; the same bytes out as the reference's),
KV blob CRC32 (bit-flip detection, v1 blobs), heartbeat crash-loop
backoff, the engine's liveness watchdog. Engine level: stop words
straddling the kill point replay correctly; a sampled resume with the same
seed draws the same continuation; a replay with no budget left is refused.
Acceptance: kill a port replica mid-stream under load over a 3-replica
fleet; the client stream completes with no error frame and the greedy
text equals an uninterrupted run; with resume off the same kill gives the
classic ``replica_lost`` error frame; a draining sibling takes the resume.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

import torch

import aiohttp  # noqa: F401 — skip cleanly where aiohttp is absent
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.server import create_app
from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                             SamplingParams)
from generativeaiexamples_tpu_torch.engine import kv_tier
from generativeaiexamples_tpu_torch.engine import resume as engine_resume
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.router.flight import Transcript
from generativeaiexamples_tpu_torch.router.server import create_router_app
from generativeaiexamples_tpu_torch.utils import faults, resilience
from generativeaiexamples_tpu_torch.utils.errors import EngineError

pytestmark = []


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    resilience.reset_breakers()
    yield
    faults.clear()
    resilience.reset_breakers()


def _run(coro):
    loop = asyncio.get_event_loop_policy().new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _words(tag: str, n_chars: int) -> str:
    import hashlib
    h = hashlib.blake2b(tag.encode(), digest_size=32).hexdigest()
    return (h * (n_chars // len(h) + 1))[:n_chars]


# ------------------------------------------------------------- transcript


def test_transcript_holds_back_split_utf8_and_flushes():
    snow = "☃".encode("utf-8")  # 3 bytes
    t = Transcript(max_bytes=1024)
    assert t.push(b"ab" + snow[:1]) == b"ab"       # partial char withheld
    assert t.push(snow[1:]) == snow                # completed -> released
    assert t.text == "ab☃"
    assert t.flush() == b""

    # clean EOF / failed resume: the raw tail is flushed to the caller
    t = Transcript(max_bytes=1024)
    assert t.push(b"x" + snow[:2]) == b"x"
    assert t.flush() == snow[:2]

    # successful resume: the tail is DISCARDED — the sibling regenerates
    # that token and the caller sees its bytes exactly once
    t = Transcript(max_bytes=1024)
    t.push(b"y" + snow[:2])
    t.discard_pending()
    assert t.flush() == b""
    assert t.text == "y"


def test_transcript_overflow_and_non_utf8_disable_resume():
    t = Transcript(max_bytes=8)
    assert t.push(b"12345") == b"12345"
    assert not t.overflowed
    # past the cap: forwarding continues untouched, transcript stops
    assert t.push(b"67890") == b"67890"
    assert t.overflowed and t.size == 0

    # a stream that is not UTF-8 at all: forwarded verbatim, resume off
    t = Transcript(max_bytes=1024)
    blob = bytes([0xFF, 0xFE, 0xFD, 0xFC, 0xFB])
    assert t.push(blob) == blob
    assert t.overflowed


def test_transcript_matches_the_reference_byte_for_byte():
    """Random byte feeds (multibyte UTF-8 split anywhere, the cap, the
    discard-on-resume path) give the same forwarded bytes, text and
    flags as the reference's Transcript."""
    from generativeaiexamples_tpu.router.flight import \
        Transcript as JTranscript
    rng = np.random.default_rng(3)
    text = "héllo ✓ wörld ☃ 𝄞 plain ascii " * 6
    raw = text.encode("utf-8")
    for trial in range(40):
        cap = int(rng.integers(8, 400))
        ours, theirs = Transcript(max_bytes=cap), JTranscript(max_bytes=cap)
        data = raw if trial % 5 else raw + bytes([0xFF, 0xFE])
        pos = 0
        while pos < len(data):
            n = int(rng.integers(1, 9))
            chunk = data[pos:pos + n]
            pos += n
            assert ours.push(chunk) == theirs.push(chunk)
            assert (ours.text, ours.size, ours.overflowed) == \
                (theirs.text, theirs.size, theirs.overflowed)
        if trial % 2:
            ours.discard_pending()
            theirs.discard_pending()
        assert ours.flush() == theirs.flush()


# ----------------------------------------------------------- KV blob CRC


def _one_block_blob():
    rec = kv_tier.BlockRecord(
        hash=b"\x01" * 16, parent=None,
        arrays={"k": torch.arange(64, dtype=torch.float32).reshape(4, 16)})
    return kv_tier.to_blob([rec], {"page_size": 16})


def test_kv_blob_crc_bit_flip_detected():
    blob = _one_block_blob()
    meta, recs = kv_tier.from_blob(blob)          # round-trips clean
    assert meta["page_size"] == 16
    assert recs[0].arrays["k"][3, 15] == 63.0
    bad = bytearray(blob)
    bad[-1] ^= 0x40                               # one flipped bit
    with pytest.raises(ValueError, match="CRC mismatch"):
        kv_tier.from_blob(bytes(bad))


def test_kv_blob_v1_without_checksums_still_parses():
    """Blobs written before the CRC header (magic GAIEKV1, no ``crc32``
    keys) must keep parsing — already-suspended sessions survive the
    upgrade."""
    blob = _one_block_blob()
    head_len = int.from_bytes(blob[8:16], "little")
    header = json.loads(blob[16:16 + head_len].decode("utf-8"))
    for b in header["blocks"]:
        for spec in b["arrays"].values():
            spec.pop("crc32")
    head = json.dumps(header).encode("utf-8")
    v1 = kv_tier.BLOB_MAGIC_V1 + len(head).to_bytes(8, "little") \
        + head + blob[16 + head_len:]
    meta, recs = kv_tier.from_blob(v1)
    assert meta["page_size"] == 16
    assert recs[0].arrays["k"][0, 1] == 1.0


# --------------------------------------------- fleet fixtures (3 engines)


@pytest.fixture(scope="module")
def model_bits():
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LlamaConfig

    # vocab_size=131: specials (0..2) + the ASCII bytes (3..130). Resume
    # replays TEXT, so its byte-exactness contract requires the
    # tokenizer to round-trip the emitted text (docs/robustness.md) —
    # true for real models emitting valid text, but a random-weight
    # model over the FULL byte vocab emits invalid UTF-8 that decodes
    # lossily (U+FFFD). Capping the vocab at ASCII keeps this model's
    # output exactly round-trippable, so the byte-identity assertions
    # test the failover path, not the toy model's garbage bytes.
    cfg = LlamaConfig(vocab_size=131, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16,
                      max_position_embeddings=2048)
    params = llama.init_params(cfg, seed=21, dtype=torch.float32,
                               device="cpu")
    return params, cfg


def _engine_config(**over):
    kw = dict(max_slots=2, max_input_length=2048, max_output_length=64,
              prefill_buckets=(64,), max_prefill_bucket=64,
              dtype="float32", page_size=16, kv_pool_tokens=4096,
              max_queue=16, steps_per_round=4, kv_host_pool_tokens=4096)
    kw.update(over)
    return EngineConfig(**kw)


@pytest.fixture(scope="module")
def trio_engines(model_bits):
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    params, cfg = model_bits
    # Three replicas over SHARED params — weights are read-only; each
    # gets its own KV pool, prefix cache, and host tier.
    engines = [Engine(params, cfg, ByteTokenizer(), _engine_config(),
                      device="cpu") for _ in range(3)]
    for e in engines:
        e.start()
    yield engines
    for e in engines:
        e.stop()


def _apps(engines):
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import (
        QAChatbot)
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    cfg = from_dict(AppConfig, {
        "embeddings": {"model_engine": "hash", "dimensions": 32},
    })
    return [create_app(QAChatbot(llm=EngineLLM(e),
                                 embedder=HashEmbedder(dim=32),
                                 config=cfg, fused_rag=False), config=cfg)
            for e in engines]


class _LiveServer:
    """A replica app on its own thread+loop, killable mid-stream: kill()
    force-closes in-flight connections after a 0.2 s grace — the wire
    shape of a pod dying, which aiohttp's in-loop TestServer cannot
    produce."""

    def __init__(self, app):
        self._app = app
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._runner = None
        self.port = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._runner = web.AppRunner(self._app)
            await self._runner.setup()
            site = web.TCPSite(self._runner, "127.0.0.1", 0,
                               shutdown_timeout=0.2)
            await site.start()
            self.port = self._runner.addresses[0][1]
        self._loop.run_until_complete(boot())
        self._started.set()
        self._loop.run_forever()

    def start(self) -> str:
        self._thread.start()
        assert self._started.wait(30), "replica server failed to boot"
        return f"http://127.0.0.1:{self.port}"

    def kill(self):
        fut = asyncio.run_coroutine_threadsafe(self._runner.cleanup(),
                                               self._loop)
        try:
            fut.result(timeout=30)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=10)


def _delta(snap0: dict, snap1: dict, key: str) -> float:
    return snap1.get(key, 0.0) - snap0.get(key, 0.0)


# ---------------------------------------------------------- acceptance


def test_acceptance_midstream_failover_resume(trio_engines):
    """Kill a replica mid-stream under open-loop load over a 3-replica
    fleet: the client stream completes with ZERO error frames and its
    body is byte-identical to an uninterrupted greedy reference;
    ``router_resume_total{outcome="ok"}`` and the timeline's ``resume``
    event prove the failover path ran. A second kill against a router
    with ``resume_attempts=0`` reproduces the classic ``replica_lost``
    error frame."""
    engines = trio_engines
    servers = [_LiveServer(app) for app in _apps(engines)]
    urls = [s.start() for s in servers]
    killed = [False, False, False]

    payload = {"question": _words("fo-q", 40),
               "context": _words("fo-sys", 320),
               "use_knowledge_base": False, "num_tokens": 48}

    async def fn():
        router_app = create_router_app(
            [(f"r{i}", u) for i, u in enumerate(urls)],
            policy="affinity", heartbeat_s=0.3, run_heartbeat=True)
        client = TestClient(TestServer(router_app))
        await client.start_server()

        # ---- uninterrupted greedy reference (same payload)
        resp = await client.post("/generate", json=payload,
                                 headers={"X-Request-ID": "fo-ref"})
        assert resp.status == 200, await resp.text()
        reference = (await resp.read()).decode("utf-8")
        assert reference and "[error]" not in reference

        # ---- open-loop background load while the kill happens
        stop_bg = asyncio.Event()
        bg_rows: list = []

        async def bg(i: int):
            n = 0
            while not stop_bg.is_set():
                r = await client.post("/generate", json={
                    "question": _words(f"bg-{i}-{n}", 40),
                    "context": _words(f"bg-sys-{i}", 200),
                    "use_knowledge_base": False, "num_tokens": 8})
                body = (await r.read()).decode("utf-8", errors="replace")
                bg_rows.append((r.status, body))
                n += 1

        bg_tasks = [asyncio.create_task(bg(i)) for i in range(2)]

        snap0 = obs_metrics.REGISTRY.snapshot()
        faults.set_plan("engine.dispatch=delay:0.05")  # stretch decode
        try:
            resp = await client.post("/generate", json=payload,
                                     headers={"X-Request-ID": "fo-kill"})
            assert resp.status == 200
            home = resp.headers["X-Routed-Replica"]
            home_i = int(home[1])
            first = await resp.content.read(1)   # streaming has begun
            killed[home_i] = True
            servers[home_i].kill()
            tail = await resp.content.read()
        finally:
            faults.clear()
            stop_bg.set()
        await asyncio.gather(*bg_tasks)

        body = (first + tail).decode("utf-8")
        # ZERO error frames, byte-identical to the reference
        assert "event: error" not in body and "[error]" not in body, body
        assert body == reference, (body, reference)
        # the background streams saw no error frames either
        for status, bg_body in bg_rows:
            if status == 200:
                assert "event: error" not in bg_body, bg_body

        # the metric and the timeline prove the resume path ran
        snap1 = obs_metrics.REGISTRY.snapshot()
        assert _delta(snap0, snap1,
                      'router_resume_total{outcome="ok"}') >= 1
        dbg = await (await client.get("/debug/requests")).json()
        row = next(r for r in dbg["completed"] + dbg["in_flight"]
                   if r["request_id"] == "fo-kill")
        assert row["meta"].get("outcome") == "ok"        # NOT midstream_loss
        assert int(row["meta"].get("resumed", 0)) >= 1
        resume_evs = [e for e in row["events"] if e["event"] == "resume"]
        assert resume_evs, row["events"]
        assert resume_evs[-1]["value"]["outcome"] == "ok"
        assert resume_evs[-1]["value"]["from"] == home
        await client.close()

        # ---- off-switch: resume_attempts=0 reproduces the classic frame
        live_i = next(i for i in range(3) if not killed[i])
        off_app = create_router_app(
            [(f"r{live_i}", urls[live_i])], policy="affinity",
            heartbeat_s=0.3, run_heartbeat=True, resume_attempts=0)
        off_client = TestClient(TestServer(off_app))
        await off_client.start_server()
        faults.set_plan("engine.dispatch=delay:0.05")
        try:
            resp = await off_client.post(
                "/generate", json=payload,
                headers={"X-Request-ID": "fo-off"})
            assert resp.status == 200
            off_first = await resp.content.read(1)
            killed[live_i] = True
            servers[live_i].kill()
            off_tail = await resp.content.read()
        finally:
            faults.clear()
        off_body = (off_first + off_tail).decode("utf-8", errors="replace")
        head, sep, rest = off_body.partition("\n[error] replica ")
        assert sep, off_body
        # the streamed prefix is a greedy prefix of the reference —
        # byte-for-byte today's contract, just cut short by the kill
        assert reference.startswith(head), (head, reference)
        name, sep2, frame = rest.partition(
            " lost mid-stream\n\nevent: error\ndata: ")
        assert sep2 and name == f"r{live_i}", off_body
        evt = json.loads(frame.strip())
        assert evt["error"] == "replica_lost"
        assert evt["replica"] == f"r{live_i}"
        assert evt["request_id"] == "fo-off"
        await off_client.close()

    try:
        _run(fn())
    finally:
        for i, s in enumerate(servers):
            if not killed[i]:
                try:
                    s.kill()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass


def test_resume_lands_on_draining_sibling(trio_engines):
    """The rollout contract: a draining replica takes no new work but a
    resume is the continuation of a stream the fleet already accepted —
    the only healthy sibling being mid-drain must not turn a recoverable
    kill into an error frame."""
    engines = trio_engines[:2]
    servers = [_LiveServer(app) for app in _apps(engines)]
    urls = [s.start() for s in servers]
    killed = [False, False]

    payload = {"question": _words("dr-q", 40),
               "context": _words("dr-sys", 320),
               "use_knowledge_base": False, "num_tokens": 32}

    async def fn():
        async with aiohttp.ClientSession() as s:
            # reference from the future sibling BEFORE it drains
            async with s.post(urls[1] + "/generate",
                              json=payload) as resp:
                assert resp.status == 200
                reference = (await resp.read()).decode("utf-8")

        router_app = create_router_app(
            [(f"r{i}", u) for i, u in enumerate(urls)],
            policy="affinity", heartbeat_s=0.3, run_heartbeat=True)
        client = TestClient(TestServer(router_app))
        await client.start_server()

        # drain r1, then force a heartbeat so the table sees it
        async with aiohttp.ClientSession() as s:
            async with s.post(urls[1] + "/control/drain") as resp:
                assert resp.status == 200
        await client.post("/control/heartbeat")

        faults.set_plan("engine.dispatch=delay:0.05")
        try:
            resp = await client.post("/generate", json=payload,
                                     headers={"X-Request-ID": "dr-kill"})
            assert resp.status == 200
            # the draining r1 is not placeable — the stream is on r0
            assert resp.headers["X-Routed-Replica"] == "r0"
            first = await resp.content.read(1)
            killed[0] = True
            servers[0].kill()
            tail = await resp.content.read()
        finally:
            faults.clear()
        body = (first + tail).decode("utf-8", errors="replace")
        assert "event: error" not in body and "[error]" not in body, body
        assert body == reference, (body, reference)
        await client.close()

    try:
        _run(fn())
    finally:
        for i, s in enumerate(servers):
            if not killed[i]:
                try:
                    s.kill()
                except Exception:  # noqa: BLE001
                    pass


# -------------------------------------------- engine-level resume pins


def test_stop_word_straddling_kill_point_replays_correctly(trio_engines):
    """The dead replica's StopWordTrap withheld any partial stop-word
    prefix, so the transcript never ends inside a stop word; the
    sibling's FRESH trap must re-trip on the straddling stop word — no
    leak past it, no duplicate, byte-parity with the uninterrupted
    stopped run."""
    eng = trio_engines[0]
    prompt = _words("straddle", 48)
    full = eng.stream_text(prompt, SamplingParams(max_tokens=32,
                                                  ignore_eos=True)).text()
    assert len(full) >= 10, full
    stop = full[8:10]
    idx = full.find(stop)
    assert idx >= 0
    if idx < 4:
        stop = full[12:14]
        idx = full.find(stop)
        assert idx >= 4, (full, stop, idx)

    ref = eng.stream_text(prompt, SamplingParams(
        max_tokens=32, ignore_eos=True, stop_words=[stop])).text()
    assert ref == full[:idx]

    # resume from just before the stop word — the kill point straddles it
    cut = max(1, idx - 3)
    replay = eng.tokenizer.encode(full[:cut], add_bos=False)
    token = engine_resume.bind_resume({"ids": replay, "attempt": 1})
    try:
        cont = eng.stream_text(prompt, SamplingParams(
            max_tokens=32, ignore_eos=True, stop_words=[stop])).text()
    finally:
        engine_resume.unbind_resume(token)
    assert full[:cut] + cont == ref, (full[:cut], cont, ref)


def test_temperature_resume_same_seed_same_continuation(trio_engines):
    """temp>0 resume is not byte-pinned to the uninterrupted run, but it
    IS deterministic: the continuation draw comes from a (seed, offset)
    admission key, not the engine's global step counter — the same
    replay with the same seed yields the same next token no matter how
    much the engine has served in between."""
    eng = trio_engines[1]
    prompt = _words("temp-resume", 40)
    replay = eng.tokenizer.encode(_words("temp-gen", 12), add_bos=False)

    def one() -> str:
        sp = SamplingParams(max_tokens=len(replay) + 1, temperature=0.9,
                            top_k=3, random_seed=1234, ignore_eos=True)
        token = engine_resume.bind_resume({"ids": list(replay),
                                           "attempt": 1})
        try:
            return eng.stream_text(prompt, sp).text()
        finally:
            engine_resume.unbind_resume(token)

    first = one()
    # burn engine state between the two resumes: the global step counter
    # advances, the admission key must not care
    eng.stream_text(_words("temp-noise", 30),
                    SamplingParams(max_tokens=6, ignore_eos=True)).text()
    second = one()
    assert first == second
    assert len(first) >= 1


def test_resume_with_no_token_budget_left_is_refused(trio_engines):
    """A replay that already spent the request's max_tokens has nothing
    left to generate — admission refuses loudly (the router maps this to
    its rejected fallback) instead of admitting a zero-budget request."""
    eng = trio_engines[0]
    replay = eng.tokenizer.encode(_words("spent", 8), add_bos=False)
    token = engine_resume.bind_resume({"ids": list(replay), "attempt": 1})
    try:
        with pytest.raises(EngineError, match="no token budget"):
            eng.submit(eng.tokenizer.encode(_words("spent-q", 16)),
                       SamplingParams(max_tokens=len(replay)))
    finally:
        engine_resume.unbind_resume(token)


def test_corrupt_kv_blob_import_counts_and_refuses(trio_engines):
    """A corrupt session/handoff blob is counted (``kv_restore_corrupt``)
    and refused with EngineError — never silently dropped, never garbage
    pages in the pool."""
    eng = trio_engines[2]
    blob = _one_block_blob()
    bad = bytearray(blob)
    bad[-1] ^= 0x01
    before = int(eng.stats.get("kv_restore_corrupt", 0))
    with pytest.raises(EngineError, match="malformed KV blob"):
        eng.resume_session(bytes(bad))
    assert int(eng.stats["kv_restore_corrupt"]) == before + 1


# ---------------------------------------------- heartbeat backoff


def test_heartbeat_crash_loop_backoff_and_reset():
    """Consecutive probe failures space a dead replica's probes out
    exponentially (capped); a skipped sweep does not advance the
    last-observation timestamp (``router_heartbeat_age_seconds`` keeps
    growing); recovery resets the cadence. The table's cumulative
    ``heartbeat_failures`` contract is untouched."""
    from generativeaiexamples_tpu_torch.router.server import FleetRouter
    from generativeaiexamples_tpu_torch.router.table import ReplicaTable

    table = ReplicaTable()
    table.add("r0", "http://127.0.0.1:9")   # nothing listens there
    router = FleetRouter(table, heartbeat_s=0.1, heartbeat_timeout_s=0.2,
                         heartbeat_max_backoff_s=0.8)

    async def fn():
        await router.start(run_heartbeat=False, run_autoscale=False)
        try:
            await router.heartbeat_once()
            assert router._hb_fail_streak["r0"] == 1
            rep = table.get("r0")
            t_obs = rep.last_heartbeat_t
            fails = rep.heartbeat_failures

            # immediately again: the replica is backed off -> skipped
            await router.heartbeat_once()
            assert router._hb_fail_streak["r0"] == 1
            assert table.get("r0").last_heartbeat_t == t_obs  # no observe
            assert table.get("r0").heartbeat_failures == fails

            # forced probes (the /control/heartbeat path) ignore backoff
            deltas = []
            for _ in range(4):
                await router.heartbeat_once(force=True)
                deltas.append(router._hb_next_t["r0"] - time.monotonic())
            assert router._hb_fail_streak["r0"] == 5
            # doubling, then pinned at the cap
            assert deltas[0] < deltas[1] < deltas[2] <= 0.8 + 0.05
            assert deltas[3] <= 0.8 + 0.05
            # cumulative failure counter kept counting every real probe
            assert table.get("r0").heartbeat_failures == fails + 4

            # recovery: one successful observation resets the cadence
            table.update_health("r0", ok=True, body=None)
            router._hb_update_backoff(table.get("r0"))
            assert "r0" not in router._hb_fail_streak
            assert "r0" not in router._hb_next_t
        finally:
            await router.stop()

    _run(fn())


# ---------------------------------------------- engine liveness watchdog


def test_engine_watchdog_flags_hang_and_health_503(model_bits,
                                                   monkeypatch):
    """FAULT_PLAN=engine.harvest=hang wedges the serve loop mid-round;
    the watchdog (ENGINE_WATCHDOG_STALL_S) must flag the stall — counted
    in ``watchdog_stalls``, ``stalled`` flipped, /health 503 —
    and recover once the hang clears."""
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    params, cfg = model_bits
    monkeypatch.setenv("ENGINE_WATCHDOG_STALL_S", "0.5")
    eng = Engine(params, cfg, ByteTokenizer(), _engine_config(),
                 device="cpu")
    eng.start()
    try:
        # warm the geometry first so the hang lands mid-round, not
        # mid-compile (a compile is progress, not a stall)
        eng.stream_text(_words("wd-warm", 24),
                        SamplingParams(max_tokens=8,
                                       ignore_eos=True)).text()
        assert not eng.stalled
        faults.set_plan("engine.harvest=hang")
        stream = eng.stream_text(_words("wd-hang", 24),
                                 SamplingParams(max_tokens=8,
                                                ignore_eos=True))
        deadline = time.monotonic() + 20
        while not eng.stalled and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stalled, "watchdog never flagged the wedged loop"
        assert int(eng.stats["watchdog_stalls"]) >= 1

        # readiness is truthful while stalled: /health answers 503
        app = _apps([eng])[0]

        async def fn():
            client = TestClient(TestServer(app))
            await client.start_server()
            resp = await client.get("/health")
            body = await resp.json()
            assert resp.status == 503
            assert body["status"] == "engine_stalled"
            await client.close()

        _run(fn())

        faults.clear()               # release the hang
        assert stream.text() is not None   # the wedged request completes
        deadline = time.monotonic() + 10
        while eng.stalled and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not eng.stalled
    finally:
        faults.clear()
        eng.stop()
