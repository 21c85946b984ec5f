"""The port's fleet router (``router/``) over port chain-server replicas
on the CPU: the scenarios of the reference's ``tests/test_router.py``, and
parity with the reference's router.

Unit: affinity hashing (equal to the reference's hashes), the sketch, the
placement score (the port's and the reference's tables fed the same
heartbeats and prompts place the same sequence), drain and health
exclusion, retry-budget accounting, replica-table race safety, fault-plan
tag scoping. Chain server: readiness truthfulness over drain and breaker
transitions. Router: forwarding, connect-only retry, drain observation,
caller disconnects, membership churn. Acceptance: two port engine replicas
behind the router; a multi-turn session sticks to one replica and reuses
its prefix pages (read from the engines' prefix-hit counters and the
router's placement counters, not from wall-clock times), while round robin
bounces it; killing that replica mid-stream ends the stream with a real
error frame, and the next turn lands on the survivor.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

import aiohttp  # noqa: F401 — skip cleanly where aiohttp is absent
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.server import (DRAIN_STATE,
                                                    GENERATE_BREAKER,
                                                    create_app)
from generativeaiexamples_tpu_torch.router import metrics as router_metrics
from generativeaiexamples_tpu_torch.router.server import create_router_app
from generativeaiexamples_tpu_torch.router.table import (ReplicaTable,
                                                   affinity_blocks)
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.utils import faults, resilience

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


def _snapshot(name: str) -> float:
    return obs_metrics.REGISTRY.snapshot().get(name, 0.0)


class EchoExample(BaseExample):
    """Minimal real chain-server example: streams a deterministic echo."""

    def llm_chain(self, context, question, num_tokens):
        yield f"echo:{question[:32]}"

    def rag_chain(self, prompt, num_tokens):
        yield f"rag:{prompt[:32]}"

    def ingest_docs(self, data_dir, filename):
        pass


# --------------------------------------------------------------- affinity


def test_affinity_blocks_chained_prefix_semantics():
    a = affinity_blocks("s" * 300, block_bytes=64)
    b = affinity_blocks("s" * 300, block_bytes=64)
    assert a and a == b  # deterministic
    # Shared 128-byte head -> identical first 2 blocks, then divergence.
    c = affinity_blocks("s" * 128 + "t" * 172, block_bytes=64)
    assert c[:2] == a[:2] and c[2:] != a[2:4]
    # head cap bounds the block count
    assert len(affinity_blocks("x" * 10_000, block_bytes=64,
                               head_bytes=256)) == 4


def test_affinity_scoring_beats_load_only_on_shared_prefix():
    """Two sessions, two replicas: the affinity policy keeps each
    session pinned to the replica that served it even when a load blip
    would tempt a load-only scorer away; with affinity_weight=0 the
    same blip bounces the session (and would cost a cold prefill)."""
    def sticky_fraction(affinity_weight: float) -> float:
        table = ReplicaTable(affinity_weight=affinity_weight)
        table.add("r0", "http://a")
        table.add("r1", "http://b")
        sessions = {s: affinity_blocks(f"system prompt {s} " + "x" * 400)
                    for s in ("A", "B")}
        homes = {}
        for s, blocks in sessions.items():
            rep = table.place(blocks)
            table.record_placement(rep, blocks)
            homes[s] = rep.name
        assert homes["A"] != homes["B"]  # tie-break spread them out
        sticky = 0
        for s, blocks in sessions.items():
            # A load blip on THIS session's home (its sibling is idle):
            # the moment a load-only scorer would bounce — and cold-miss.
            for name in ("r0", "r1"):
                table.update_health(name, ok=True, body={
                    "load": {"queue_depth": 1 if name == homes[s] else 0}})
            rep = table.place(blocks)
            table.record_placement(rep, blocks)
            sticky += rep.name == homes[s]
        return sticky / len(sessions)

    assert sticky_fraction(affinity_weight=2.0) == 1.0
    assert sticky_fraction(affinity_weight=0.0) == 0.0


def test_sketch_is_bounded_lru():
    table = ReplicaTable(sketch_cap=8)
    rep = table.add("r0", "http://a")
    for i in range(10):
        table.record_placement(rep, affinity_blocks(f"{i:03d}" * 100))
    assert len(rep.sketch) <= 8
    # the most recent prompt's blocks survived
    last = affinity_blocks("009" * 100)
    assert table._match(rep, last) > 0


def test_draining_replica_receives_zero_placements():
    table = ReplicaTable()
    table.add("r0", "http://a")
    table.add("r1", "http://b")
    table.mark_draining("r0")
    for i in range(8):
        rep = table.place(affinity_blocks(f"p{i}" * 50))
        assert rep.name == "r1"
        table.record_placement(rep, ())
    table.mark_draining("r0", False)
    names = {table.place((), exclude=("r1",)).name}
    assert names == {"r0"}  # placeable again after undrain


def test_unreachable_unready_and_breaker_open_are_excluded():
    table = ReplicaTable(breaker_failures=2)
    r0 = table.add("r0", "http://a")
    table.add("r1", "http://b")
    table.update_health("r0", ok=False, ready=False)
    assert table.place(()).name == "r1"
    table.update_health("r0", ok=True, ready=False)  # 503: drain/breaker
    assert table.place(()).name == "r1"
    table.update_health("r0", ok=True, ready=True)
    r0.breaker.record_failure()
    r0.breaker.record_failure()  # threshold 2 -> OPEN
    assert r0.breaker.state == resilience.OPEN
    assert all(table.place(()).name == "r1" for _ in range(4))
    # no placeable replica at all -> None (the router's 503 no_replicas)
    table.mark_draining("r1")
    assert table.place(()) is None


def test_replica_table_add_remove_races_are_safe():
    """Placement keeps working while replicas churn from other threads —
    no exceptions, and every returned replica is a real table member of
    the moment (or a just-removed one, which the forward path handles
    via its breaker; what matters here is no corruption)."""
    table = ReplicaTable()
    table.add("stable", "http://s")
    stop = threading.Event()
    errors: list = []

    def churn(i: int):
        try:
            while not stop.is_set():
                table.add(f"r{i}", f"http://{i}")
                table.update_health(f"r{i}", ok=True,
                                    body={"load": {"queue_depth": i}})
                table.remove(f"r{i}")
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=churn, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        blocks = affinity_blocks("shared prefix " * 40)
        for _ in range(300):
            rep = table.place(blocks)
            assert rep is not None
            table.record_placement(rep, blocks)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors
    assert table.get("stable") is not None
    snap = table.snapshot()
    assert any(r["name"] == "stable" for r in snap)


def test_round_robin_policy_ignores_affinity():
    table = ReplicaTable(policy="round_robin")
    table.add("r0", "http://a")
    table.add("r1", "http://b")
    blocks = affinity_blocks("same prefix " * 40)
    seen = []
    for _ in range(4):
        rep = table.place(blocks)
        table.record_placement(rep, blocks)
        seen.append(rep.name)
    assert seen == ["r0", "r1", "r0", "r1"]


# ------------------------------------------------------- fault tag scoping


def test_fault_plan_tag_scoping():
    plan = faults.parse_plan("router.forward[r0]=fail:conn; "
                             "replica.heartbeat=delay:0")
    assert set(plan) == {"router.forward[r0]", "replica.heartbeat"}
    with pytest.raises(faults.FaultPlanError):
        faults.parse_plan("router.forward[r0=fail")  # malformed tag
    with pytest.raises(faults.FaultPlanError):
        faults.parse_plan("not.a.point[r0]=fail")

    faults.set_plan("router.forward[r0]=fail:conn")
    faults.inject("router.forward", tag="r1")   # other tag: no fire
    faults.inject("router.forward")             # untagged call: no fire
    with pytest.raises(ConnectionError):
        faults.inject("router.forward", tag="r0")
    assert faults.fired("router.forward[r0]") == 1
    assert faults.fired("router.forward") == 0

    faults.set_plan("router.forward=fail:conn")  # untagged: every tag
    with pytest.raises(ConnectionError):
        faults.inject("router.forward", tag="anything")
    with pytest.raises(ConnectionError):
        faults.inject("router.forward")


# --------------------------------------------- readiness truthfulness (s2)


def test_health_truthful_across_drain_transitions():
    app = create_app(EchoExample())

    async def fn():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.get("/health")
            assert resp.status == 200
            body = await resp.json()
            assert body["status"] == "ok" and body["draining"] is False
            assert "in_flight" in body["load"]

            resp = await client.post("/control/drain")
            assert resp.status == 200
            # not ready while draining — k8s and the router both see it
            resp = await client.get("/health")
            assert resp.status == 503
            body = await resp.json()
            assert body["status"] == "draining" and body["draining"]
            # and every work endpoint sheds with the draining contract
            for path, payload in (
                    ("/generate", {"question": "q"}),
                    ("/documentSearch", {"content": "c"})):
                resp = await client.post(path, json=payload)
                assert resp.status == 429
                err = await resp.json()
                assert err["error"]["type"] == "draining"
                assert "Retry-After" in resp.headers

            resp = await client.post("/control/undrain")
            assert resp.status == 200
            resp = await client.get("/health")
            assert resp.status == 200
            assert (await resp.json())["status"] == "ok"
            resp = await client.post("/generate", json={"question": "hi"})
            assert resp.status == 200  # admission re-opened
        finally:
            await client.close()

    _run(fn())


def test_health_truthful_across_breaker_transitions():
    app = create_app(EchoExample())
    breaker = app[GENERATE_BREAKER]

    async def fn():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert (await client.get("/health")).status == 200
            for _ in range(breaker.failure_threshold):
                breaker.record_failure()
            assert breaker.state == resilience.OPEN
            resp = await client.get("/health")
            assert resp.status == 503
            assert (await resp.json())["status"] == "breaker_open"
            breaker.record_success()  # probe succeeded -> closed
            resp = await client.get("/health")
            assert resp.status == 200
            assert (await resp.json())["status"] == "ok"
        finally:
            await client.close()

    _run(fn())


def test_drain_counts_in_flight_streams():
    """The drain body/health expose the live in-flight count, and the
    counter returns to 0 when the stream finishes (what the preStop
    drain CLI polls)."""
    release = threading.Event()

    class SlowExample(BaseExample):
        def llm_chain(self, context, question, num_tokens):
            yield "first"
            release.wait(timeout=30)
            yield "second"

        def rag_chain(self, prompt, num_tokens):
            yield from self.llm_chain("", prompt, num_tokens)

        def ingest_docs(self, data_dir, filename):
            pass

    app = create_app(SlowExample())
    drain_state = app[DRAIN_STATE]

    async def fn():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.post("/generate", json={
                "question": "q", "use_knowledge_base": False})
            assert resp.status == 200  # first chunk arrived; stream open
            body = await (await client.post("/control/drain")).json()
            assert body["in_flight"] == 1
            # new work refused while the stream runs on
            assert (await client.post("/generate",
                                      json={"question": "x"})).status == 429
            release.set()
            assert (await resp.read()).decode().endswith("second")
            deadline = time.monotonic() + 10
            while drain_state.in_flight and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            assert drain_state.in_flight == 0
        finally:
            await client.close()

    _run(fn())


# ----------------------------------------------------- router HTTP surface


def test_router_forwards_generate_and_relays_identity():
    app = create_app(EchoExample())

    async def fn():
        replica = TestServer(app)
        await replica.start_server()
        url = f"http://127.0.0.1:{replica.port}"
        router_app = create_router_app([("r0", url)], policy="affinity",
                                       heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            resp = await client.post(
                "/generate",
                json={"question": "hello", "use_knowledge_base": False},
                headers={"X-Request-ID": "fwd-1"})
            assert resp.status == 200
            assert resp.headers["X-Routed-Replica"] == "r0"
            assert resp.headers["X-Request-ID"] == "fwd-1"
            assert (await resp.read()).decode() == "echo:hello"
            # non-2xx relays verbatim (422 from the replica's validation)
            resp = await client.post("/generate", json={})
            assert resp.status == 422
        finally:
            await client.close()
            await replica.close()

    _run(fn())


def test_router_draining_replica_zero_new_placements_e2e():
    apps = [create_app(EchoExample()), create_app(EchoExample())]

    async def fn():
        servers = [TestServer(a) for a in apps]
        for s in servers:
            await s.start_server()
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        router_app = create_router_app(
            [(f"r{i}", u) for i, u in enumerate(urls)],
            policy="affinity", heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            # Establish affinity: the session's first turn lands
            # somewhere; note WHICH replica, then drain exactly it.
            session = {"question": "turn", "context": "system " * 60,
                       "use_knowledge_base": False}
            resp = await client.post("/generate", json=session)
            assert resp.status == 200
            home = resp.headers["X-Routed-Replica"]
            other = "r1" if home == "r0" else "r0"
            home_url = urls[int(home[1])]
            before_retry = _snapshot(
                'router_retries_total{reason="draining"}')
            async with aiohttp.ClientSession() as s:
                async with s.post(home_url + "/control/drain") as resp:
                    assert resp.status == 200
            # BEFORE any heartbeat the router still prefers the home
            # (affinity); the home 429s as draining and the router
            # transparently retries on the sibling — the caller sees a
            # 200 (nothing lost in the race window).
            resp = await client.post("/generate", json=session)
            assert resp.status == 200
            assert resp.headers["X-Routed-Replica"] == other
            assert _snapshot('router_retries_total{reason="draining"}') \
                >= before_retry + 1
            # After the heartbeat the router knows; the draining replica
            # gets ZERO placements.
            await client.post("/control/heartbeat")
            placed_home = _snapshot(
                f'router_placed_total{{replica="{home}"}}')
            for i in range(6):
                resp = await client.post("/generate", json=session)
                assert resp.status == 200
                assert resp.headers["X-Routed-Replica"] == other
            assert _snapshot(
                f'router_placed_total{{replica="{home}"}}') == placed_home
            # Undrain + heartbeat: placeable again (rollback path).
            async with aiohttp.ClientSession() as s:
                async with s.post(home_url + "/control/undrain") as resp:
                    assert resp.status == 200
            await client.post("/control/heartbeat")
            snap = await (await client.get("/router/replicas")).json()
            rhome = next(r for r in snap["replicas"] if r["name"] == home)
            assert rhome["placeable"]
        finally:
            await client.close()
            for s in servers:
                await s.close()

    _run(fn())


def test_router_connect_retry_budget_and_no_replicas():
    app = create_app(EchoExample())

    async def fn():
        replica = TestServer(app)
        await replica.start_server()
        url = f"http://127.0.0.1:{replica.port}"
        router_app = create_router_app(
            [("r0", url), ("r1", url)], policy="affinity",
            heartbeat_s=30, retry_attempts=2, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            # Both replicas partitioned at connect: the budget (2) is
            # spent and the caller gets a typed 502, not a hang.
            faults.set_plan("router.forward=fail:conn")
            before = _snapshot('router_retries_total{reason="connect"}')
            resp = await client.post(
                "/generate", json={"question": "q",
                                   "use_knowledge_base": False})
            assert resp.status == 502
            body = await resp.json()
            assert body["error"]["type"] == "replica_error"
            assert _snapshot('router_retries_total{reason="connect"}') \
                == before + 2  # budget honored: exactly 2 attempts
            # One replica partitioned: retry lands on the other, caller
            # sees success (single-failure transparency).
            faults.set_plan("router.forward[r0]=fail:conn")
            resp = await client.post(
                "/generate", json={"question": "q2",
                                   "use_knowledge_base": False})
            assert resp.status == 200
            assert resp.headers["X-Routed-Replica"] == "r1"
            faults.clear()
            # Every replica excluded (drained) -> 503 no_replicas.
            async with aiohttp.ClientSession() as s:
                for u in {url}:
                    async with s.post(u + "/control/drain"):
                        pass
            await client.post("/control/heartbeat")
            resp = await client.post(
                "/generate", json={"question": "q3",
                                   "use_knowledge_base": False})
            assert resp.status == 503
            assert (await resp.json())["error"]["type"] == "no_replicas"
            assert "Retry-After" in resp.headers
        finally:
            await client.close()
            await replica.close()

    _run(fn())


def test_router_all_replicas_draining_relays_429_not_502():
    """A rollout must look like backpressure to callers: when every
    placeable replica answers 429 draining (single-replica fleets hit
    this on every rollout), the router relays the 429 + Retry-After
    instead of inventing a 502."""
    app = create_app(EchoExample())

    async def fn():
        replica = TestServer(app)
        await replica.start_server()
        url = f"http://127.0.0.1:{replica.port}"
        router_app = create_router_app(
            [("r0", url)], policy="affinity", heartbeat_s=30,
            run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(url + "/control/drain") as resp:
                    assert resp.status == 200
            # No heartbeat has run: the router still thinks r0 is
            # placeable, forwards, and gets the draining refusal with
            # nobody else to hand it to.
            resp = await client.post(
                "/generate", json={"question": "q",
                                   "use_knowledge_base": False})
            assert resp.status == 429
            body = await resp.json()
            assert body["error"]["type"] == "draining"
            assert "Retry-After" in resp.headers
        finally:
            await client.close()
            await replica.close()

    _run(fn())


class _SlowEchoExample(BaseExample):
    """Streams many small chunks so a caller can hang up mid-stream."""

    def llm_chain(self, context, question, num_tokens):
        for i in range(60):
            yield f"tok{i} "
            time.sleep(0.04)

    def rag_chain(self, prompt, num_tokens):
        yield "rag"

    def ingest_docs(self, data_dir, filename):
        pass


def test_caller_disconnect_does_not_penalize_replica():
    """A client hanging up mid-stream is the CALLER's doing — it must
    not feed the replica's breaker or mark it unreachable (three
    impatient clients would otherwise open the breaker and 503 a
    perfectly healthy single-replica fleet)."""
    app = create_app(_SlowEchoExample())

    async def fn():
        replica = TestServer(app)
        await replica.start_server()
        url = f"http://127.0.0.1:{replica.port}"
        router_app = create_router_app(
            [("r0", url)], policy="affinity", heartbeat_s=30,
            run_heartbeat=False)
        from generativeaiexamples_tpu_torch.router.server import ROUTER
        router = router_app[ROUTER]
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            for _ in range(3):  # would trip the breaker if misfiled
                resp = await client.post(
                    "/generate", json={"question": "slow",
                                       "use_knowledge_base": False,
                                       "num_tokens": 8})
                assert resp.status == 200
                await resp.content.read(4)   # stream has begun
                resp.close()                 # caller hangs up
                await asyncio.sleep(0.3)     # router hits the dead pipe
            rep = router.table.get("r0")
            assert rep.breaker.state == resilience.CLOSED
            assert rep.placeable()
            # ... and the replica still serves the next caller fully.
            resp = await client.post(
                "/generate", json={"question": "after",
                                   "use_knowledge_base": False,
                                   "num_tokens": 8})
            assert resp.status == 200
            body = (await resp.read()).decode()
            assert "tok59" in body and "[error]" not in body
        finally:
            await client.close()
            await replica.close()

    _run(fn())


def test_parse_replicas_names_and_duplicate_rejection():
    from generativeaiexamples_tpu_torch.router.__main__ import parse_replicas

    assert parse_replicas("r0=http://a:1, r1=http://b:2") \
        == [("r0", "http://a:1"), ("r1", "http://b:2")]
    assert parse_replicas("http://a:1,http://b:2") \
        == [("r0", "http://a:1"), ("r1", "http://b:2")]
    with pytest.raises(ValueError, match="duplicate"):
        parse_replicas("r0=http://a:1,r0=http://b:2")
    with pytest.raises(ValueError, match="duplicate"):
        # bare URL at position 1 auto-names to r1, colliding with the
        # explicit r1 — must be loud, not last-writer-wins
        parse_replicas("r1=http://a:1,http://b:2")


def test_recent_rejects_first_heartbeat_is_baseline():
    """A replica's lifetime rejected_total must not count as 'recent'
    shed on the router's FIRST observation of it (router restart /
    re-add) — only between-heartbeat diffs are load signal."""
    table = ReplicaTable()
    table.add("r0", "http://a")
    table.update_health(
        "r0", ok=True, body={"load": {"rejected_total": 10_000}})
    assert table.get("r0").recent_rejects == 0.0
    table.update_health(
        "r0", ok=True, body={"load": {"rejected_total": 10_007}})
    assert table.get("r0").recent_rejects == 7.0
    # re-add resets the baseline too
    table.add("r0", "http://a")
    table.update_health(
        "r0", ok=True, body={"load": {"rejected_total": 10_007}})
    assert table.get("r0").recent_rejects == 0.0


# ------------------------------------------------- acceptance (two engines)


class _LiveServer:
    """A replica app on its own thread+loop, killable mid-stream: stop()
    force-closes in-flight connections after a 0.2 s grace — the wire
    shape of a pod being killed, which aiohttp's in-loop TestServer
    cannot produce."""

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


def _convo_words(tag: str, n_chars: int) -> str:
    import hashlib
    h = hashlib.blake2b(tag.encode(), digest_size=32).hexdigest()
    return (h * (n_chars // len(h) + 1))[:n_chars]


@pytest.fixture(scope="module")
def fleet_engines():
    import torch

    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = LlamaConfig(vocab_size=259 + 5, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16,
                      max_position_embeddings=2048)
    params = llama.init_params(cfg, seed=21, dtype=torch.float32,
                               device="cpu")
    ecfg = EngineConfig(
        max_slots=2, max_input_length=2048, max_output_length=64,
        prefill_buckets=(64,), max_prefill_bucket=64,
        dtype="float32", page_size=16, kv_pool_tokens=4096, max_queue=16,
        steps_per_round=4)
    # Two replicas over shared params: each has its own KV pool and prefix
    # cache (that separation is the point).
    engines = [Engine(params, cfg, ByteTokenizer(), ecfg, device="cpu")
               for _ in range(2)]
    for e in engines:
        e.start()
    yield engines
    for e in engines:
        e.stop()


def _fleet_apps(engines):
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


def test_acceptance_affinity_fleet_prefix_reuse_and_failover(
        fleet_engines):
    """Two port engine replicas behind the router. A multi-turn chat
    session with a shared system prompt lands on one replica, and the
    engines' prefix-hit counters show its pages reused; a forced
    round-robin placement bounces the same kind of session and reuses
    fewer. Killing the session's replica mid-stream ends the stream with
    a machine-readable error frame, not a hang, and the next turn lands
    on the survivor. Read from counters and headers, never from wall-clock
    times."""
    engines = fleet_engines
    servers = [_LiveServer(app) for app in _fleet_apps(engines)]
    urls = [s.start() for s in servers]
    killed = [False, False]

    async def convo(post, turns, tag, *, system_chars=600, user_chars=40,
                    num_tokens=8):
        """One chat session: a shared system prompt and a growing
        history. Returns the replica of each turn."""
        system = _convo_words(f"sys-{tag}", system_chars)
        history, placed = "", []
        for t in range(turns):
            question = _convo_words(f"{tag}-t{t}", user_chars)
            resp = await post({"question": question,
                               "context": system + history,
                               "use_knowledge_base": False,
                               "num_tokens": num_tokens})
            assert resp.status == 200
            answer = (await resp.read()).decode("utf-8", errors="replace")
            placed.append(resp.headers.get("X-Routed-Replica", ""))
            history += f"\nUser: {question}\nAssistant: {answer}"
        return placed

    def hits():
        return sum(int(e.stats.get("prefix_cache_hit_tokens", 0))
                   for e in engines)

    async def fn():
        # resume_attempts=0: this pins the classic mid-stream-loss
        # contract (an error frame, no failover);
        # tests/test_torch_failover.py covers the resume path.
        router_app = create_router_app(
            [(f"r{i}", u) for i, u in enumerate(urls)],
            policy="affinity", heartbeat_s=0.3, run_heartbeat=True,
            resume_attempts=0)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        hits0 = hits()
        placed = await convo(lambda j: client.post("/generate", json=j),
                             turns=4, tag="aff")
        assert len(set(placed)) == 1, f"session bounced: {placed}"
        home = placed[0]
        home_i = int(home[1])
        aff_hits = hits() - hits0
        assert aff_hits > 0
        assert _snapshot(f'router_placed_total{{replica="{home}"}}') >= 4

        rr_app = create_router_app(
            [(f"r{i}", u) for i, u in enumerate(urls)],
            policy="round_robin", heartbeat_s=0.3, run_heartbeat=True)
        rr_client = TestClient(TestServer(rr_app))
        await rr_client.start_server()
        hits1 = hits()
        rr_placed = await convo(
            lambda j: rr_client.post("/generate", json=j), turns=4,
            tag="rr")
        rr_hits = hits() - hits1
        assert len(set(rr_placed)) == 2      # it really bounces
        await rr_client.close()
        assert aff_hits > rr_hits

        faults.set_plan("engine.dispatch=delay:0.05")  # stretch decode
        try:
            resp = await client.post(
                "/generate",
                json={"question": _convo_words("aff-kill", 40),
                      "context": _convo_words("sys-aff", 600),
                      "use_knowledge_base": False, "num_tokens": 48},
                headers={"X-Request-ID": "acc-kill"})
            assert resp.status == 200
            assert resp.headers["X-Routed-Replica"] == home
            await resp.content.read(1)  # streaming has begun
            killed[home_i] = True
            servers[home_i].kill()
            tail = (await resp.content.read()).decode(
                "utf-8", errors="replace")
        finally:
            faults.clear()
        assert "event: error" in tail and "replica_lost" in tail, tail

        resp = await client.post(
            "/generate",
            json={"question": _convo_words("aff-after", 40),
                  "context": _convo_words("sys-aff", 600),
                  "use_knowledge_base": False, "num_tokens": 8})
        assert resp.status == 200
        assert resp.headers["X-Routed-Replica"] == f"r{1 - home_i}"
        await resp.read()
        snap = await (await client.get("/router/replicas")).json()
        dead = next(r for r in snap["replicas"] if r["name"] == home)
        assert not dead["placeable"]
        await client.close()

    try:
        _run(fn())
    finally:
        for i, s in enumerate(servers):
            if not killed[i]:
                try:
                    s.kill()
                except Exception:  # noqa: BLE001 - teardown best effort
                    pass


# ------------------------------------------------------- membership churn


def test_replica_churn_under_load_resets_state_without_poisoning():
    """Add/remove/re-add a replica while sessions
    stream through the fleet. The removed member's affinity sketch,
    breaker, SLO-window rows, and shed baseline are dropped with it;
    the re-added one starts clean and placement keeps working
    throughout — no 5xx, no placement onto the absent member."""
    from generativeaiexamples_tpu_torch.router.server import ROUTER

    apps = [create_app(EchoExample()), create_app(EchoExample())]

    async def fn():
        servers = [TestServer(a) for a in apps]
        for s in servers:
            await s.start_server()
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        router_app = create_router_app(
            [("r0", urls[0]), ("r1", urls[1])], policy="affinity",
            heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        router = router_app[ROUTER]
        table = router.table
        stop = asyncio.Event()
        statuses: list = []

        async def traffic(worker: int):
            i = 0
            while not stop.is_set():
                resp = await client.post(
                    "/generate",
                    json={"question": f"churn w{worker} q{i}",
                          "context": f"churn session {worker} "
                                     + "z" * 180,
                          "use_knowledge_base": False})
                statuses.append(resp.status)
                body = await resp.read()
                if resp.status == 200:
                    assert b"[error]" not in body
                i += 1
                await asyncio.sleep(0.01)

        workers = [asyncio.ensure_future(traffic(w)) for w in range(3)]
        try:
            await asyncio.sleep(0.2)   # sessions teach r0/r1 sketches
            # Dirty r0's state so the reset is observable: window rows,
            # sketch entries, a tripped breaker, a shed baseline.
            rep = table.get("r0")
            assert len(rep.sketch) > 0
            rep.breaker.record_failure()
            router.flight.slo.record(replica="r0", outcome="error")
            table.update_health("r0", ok=True, body={
                "load": {"rejected_total": 500}})
            # remove (drain) while traffic flows...
            resp = await client.post(
                "/control/replicas",
                json={"op": "remove", "name": "r0", "wait_s": 10})
            assert resp.status == 200
            assert table.get("r0") is None
            await asyncio.sleep(0.2)   # every request lands on r1
            # ... and re-add (the "restarted pod" reopens admission
            # first — drain-on-remove closed it): state must be CLEAN,
            # not inherited.
            async with aiohttp.ClientSession() as s:
                await (await s.post(
                    f"{urls[0]}/control/undrain")).read()
            resp = await client.post(
                "/control/replicas",
                json={"op": "add", "name": "r0", "url": urls[0]})
            assert resp.status == 200
            fresh = table.get("r0")
            assert len(fresh.sketch) == 0
            assert fresh.breaker.state == "closed"
            assert fresh.placements == 0
            assert fresh.recent_rejects == 0.0
            window = router.flight.slo.snapshot(["r0"])["r0"]
            assert window["requests"] == 0     # forgotten on remove
            # shed baseline restarts: a huge lifetime counter on the
            # next heartbeat is baseline, not recent shed
            table.update_health("r0", ok=True, body={
                "load": {"rejected_total": 10_000}})
            assert table.get("r0").recent_rejects == 0.0
            await asyncio.sleep(0.2)   # traffic flows over both again
        finally:
            stop.set()
            await asyncio.gather(*workers)
            await client.close()
            for s in servers:
                await s.close()
        assert statuses and set(statuses) == {200}
        assert table.get("r0").placeable()

    _run(fn())


# ------------------------------------------------ parity with the reference


@pytest.mark.parametrize("block_bytes,head_bytes", [(64, 4096), (16, 256),
                                                    (128, 1024)])
def test_affinity_blocks_equal_the_reference(block_bytes, head_bytes):
    """The router hashes bytes with the engine's chained block hash: the
    port's hashes are the reference's, ASCII, multibyte UTF-8 and the
    head cap included."""
    from generativeaiexamples_tpu.router.table import \
        affinity_blocks as ref
    rng = np.random.default_rng(5)
    texts = ["", "s" * 63, "s" * 64, "s" * 300, "héllo wörld ✓ " * 40,
             "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 900))]
    for text in texts:
        ours = affinity_blocks(text, block_bytes=block_bytes,
                               head_bytes=head_bytes)
        assert ours == ref(text, block_bytes=block_bytes,
                           head_bytes=head_bytes)
        assert len(ours) == min(len(text.encode()), head_bytes) \
            // block_bytes


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_replica_tables_place_the_same_sequence(policy):
    """The port's and the reference's tables, fed the same heartbeats
    (load, roles, drain, failures) and the same prompts, choose the same
    replica with the same evidence, request for request."""
    from generativeaiexamples_tpu.router.table import \
        ReplicaTable as JTable
    rng = np.random.default_rng(11)
    tables = [ReplicaTable(policy=policy, sketch_cap=64),
              JTable(policy=policy, sketch_cap=64)]
    names = [f"r{i}" for i in range(4)]
    for t in tables:
        for n in names:
            t.add(n, f"http://{n}")
    sessions = [f"system prompt {k} " * 12 for k in range(6)]
    seq = [[], []]
    for step in range(80):
        if step % 7 == 0:
            body = {"load": {"in_flight": int(rng.integers(0, 4)),
                             "queue_depth": int(rng.integers(0, 6)),
                             "rejected_total": int(step * 3)},
                    "draining": bool(rng.random() < 0.15),
                    "role": "unified"}
            name = names[int(rng.integers(0, 4))]
            ok = bool(rng.random() > 0.1)
            for t in tables:
                t.update_health(name, ok=ok, ready=not body["draining"],
                                body=body)
        text = sessions[int(rng.integers(0, len(sessions)))] \
            + f"turn {step} " * int(rng.integers(1, 8))
        for t, out in zip(tables, seq):
            blocks = t.affinity_blocks(text)
            rep, decision = t.place_explained(blocks)
            if rep is not None:
                t.record_placement(rep, blocks)
            out.append((rep.name if rep else None,
                        json.dumps(decision, sort_keys=True, default=str)))
    assert seq[0] == seq[1]
    assert len({name for name, _ in seq[0]}) > 1


# ----------------------------------------------------------------- the CLI


def test_cli_serve_starts_the_router_over_replicas(tmp_path):
    """``python -m generativeaiexamples_tpu_torch.router serve`` starts
    the router: it answers /router/replicas with the replicas named on
    the command line."""
    import os
    import socket
    import subprocess
    import sys
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "GAIE_RUN_DIR": str(tmp_path),
           "ROUTER_HEARTBEAT_S": "30"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "generativeaiexamples_tpu_torch.router",
         "serve", "--replicas", "r0=http://127.0.0.1:1,r1=http://127.0.0.1:2",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=root, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        body = None
        for _ in range(300):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/router/replicas",
                        timeout=2) as resp:
                    body = json.loads(resp.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                time.sleep(0.1)
        assert body is not None, "the router did not start"
        assert sorted(r["name"] for r in body["replicas"]) == ["r0", "r1"]
        assert (tmp_path / f"router-{port}.pid").exists()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_cli_drain_and_undrain_over_urllib(capsys):
    """``drain`` flips a replica to draining and waits for its in-flight
    streams (none here); ``undrain`` reopens it; a dead replica is a
    clean nonzero exit, not a traceback."""
    from generativeaiexamples_tpu_torch.router.__main__ import main
    app = create_app(EchoExample())
    loop = asyncio.new_event_loop()
    box: dict = {}
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            box["runner"] = web.AppRunner(app)
            await box["runner"].setup()
            site = web.TCPSite(box["runner"], "127.0.0.1", 0)
            await site.start()
            box["port"] = box["runner"].addresses[0][1]
        loop.run_until_complete(boot())
        started.set()
        loop.run_forever()
        loop.run_until_complete(box["runner"].cleanup())
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(30)
    url = f"http://127.0.0.1:{box['port']}"
    try:
        assert main(["drain", "--url", url, "--wait", "5",
                     "--poll", "0.05"]) == 0
        assert app[DRAIN_STATE].draining
        assert main(["undrain", "--url", url]) == 0
        assert not app[DRAIN_STATE].draining
        assert main(["drain", "--url", "http://127.0.0.1:1",
                     "--wait", "1"]) == 1
        assert main(["undrain", "--url", "http://127.0.0.1:1"]) == 1
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
    out = capsys.readouterr()
    assert "admission closed" in out.out and "reopened" in out.out


def test_is_connect_failure_over_urllib():
    """Only a failure while connecting may be replayed: a refused connect
    (as urllib raises it) and an injected builtin ConnectionError are;
    an HTTP error answer, a reset or a broken pipe mid-response are
    not (the reference's contract, over urllib)."""
    import io
    import urllib.error
    import urllib.request

    from generativeaiexamples_tpu_torch.serving.client import \
        is_connect_failure
    with pytest.raises(urllib.error.URLError) as refused:
        urllib.request.urlopen("http://127.0.0.1:1/health", timeout=5)
    assert is_connect_failure(refused.value)
    assert is_connect_failure(ConnectionError("injected"))
    assert is_connect_failure(ConnectionRefusedError())
    assert is_connect_failure(urllib.error.URLError(TimeoutError()))
    assert not is_connect_failure(urllib.error.HTTPError(
        "http://x", 503, "unavailable", {}, io.BytesIO(b"")))
    assert not is_connect_failure(ConnectionResetError())
    assert not is_connect_failure(BrokenPipeError())
    assert not is_connect_failure(TimeoutError())
    assert not is_connect_failure(ValueError("not a network error"))
