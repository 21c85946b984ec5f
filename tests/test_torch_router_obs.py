"""The port's fleet observability spine (``router/flight.py``,
``router/fleet.py``) on the CPU: the scenarios of the reference's
``tests/test_router_fleet_obs.py`` over port replicas, and parity with
the reference's validators.

Unit: SLO-window attainment and aging, router flight outcomes,
placement-decision evidence, fleet snapshot assembly and its schema
validation (and that the validators fail on doctored data); the port's
snapshot and router timelines pass the reference's validators, and the
reference's pass the port's. Live: one ``X-Request-ID`` appears in the
router's ``/debug/requests``, the replica's and the engine's round
records; a ``FAULT_PLAN`` partitioning one of two port engine replicas
shows in ``/debug/fleet`` within one heartbeat, and after recovery a
request's router timeline records the placement, the retry and a
router-observed TTFT no smaller than the replica's for the same ID.
"""

import asyncio
import time

import pytest

import aiohttp  # noqa: F401 — skip cleanly where aiohttp is absent
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.obs import flight as obs_flight
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.obs import rounds as obs_rounds
from generativeaiexamples_tpu_torch.router import fleet as router_fleet
from generativeaiexamples_tpu_torch.router.flight import (ROUTER_SELF,
                                                    RouterFlightRecorder,
                                                    SloWindow)
from generativeaiexamples_tpu_torch.router.server import ROUTER, create_router_app
from generativeaiexamples_tpu_torch.router.table import ReplicaTable
from generativeaiexamples_tpu_torch.utils import faults, resilience


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    resilience.reset_breakers()
    yield
    faults.clear()
    resilience.reset_breakers()


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


def _run(coro):
    loop = asyncio.get_event_loop_policy().new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------------- SLO window


def test_slo_window_deadline_vs_ttft_semantics():
    win = SloWindow(window_s=60.0, slo_ttft_ms=100.0)
    # No deadline: TTFT under the default SLO attains.
    assert win.record(replica="r0", outcome="ok", ttft_ms=50.0,
                      duration_ms=200.0)
    assert not win.record(replica="r0", outcome="ok", ttft_ms=150.0,
                          duration_ms=200.0)
    # With a deadline, attainment is deadline-met — TTFT is irrelevant.
    assert win.record(replica="r0", outcome="ok", ttft_ms=900.0,
                      duration_ms=900.0, deadline_ms=1000.0)
    assert not win.record(replica="r0", outcome="ok", ttft_ms=10.0,
                          duration_ms=1500.0, deadline_ms=1000.0)
    # Non-ok outcomes never attain, whatever the numbers say.
    assert not win.record(replica="r0", outcome="midstream_loss",
                          ttft_ms=1.0, duration_ms=2.0, deadline_ms=1e6)
    snap = win.snapshot()["r0"]
    assert snap["requests"] == 5 and snap["attained"] == 2
    assert snap["attainment"] == 0.4
    assert snap["midstream_loss_rate"] == 0.2


def test_slo_window_rates_and_total_consistency():
    win = SloWindow(window_s=60.0)
    win.record(replica="r0", outcome="ok", ttft_ms=5.0, duration_ms=9.0)
    win.record(replica="r0", outcome="shed")
    win.record(replica="r1", outcome="connect_fail")
    win.record(replica="r1", outcome="error")
    win.record(replica="r1", outcome="disconnect")
    snap = win.snapshot(["r0", "r1", "r2"])
    assert snap["r0"]["shed_rate"] == 0.5
    # connect_fail + error count as errors; disconnect does NOT
    assert snap["r1"]["error_rate"] == round(2 / 3, 4)
    assert snap["r2"]["requests"] == 0 and snap["r2"]["attainment"] is None
    total = snap["_total"]
    assert total["requests"] == sum(
        snap[r]["requests"] for r in ("r0", "r1", "r2"))
    assert total["attained"] == sum(
        snap[r]["attained"] for r in ("r0", "r1", "r2"))


def test_slo_window_rows_age_out():
    win = SloWindow(window_s=0.05)
    win.record(replica="r0", outcome="error")
    assert win.snapshot()["r0"]["error_rate"] == 1.0
    time.sleep(0.08)
    win.record(replica="r0", outcome="ok", ttft_ms=1.0, duration_ms=2.0)
    snap = win.snapshot()["r0"]
    # the old incident aged out of the window; only the fresh row counts
    assert snap["requests"] == 1 and snap["error_rate"] == 0.0


# ----------------------------------------------------- router flight unit


def test_router_flight_outcome_and_timeline_contract():
    rec = RouterFlightRecorder(slo=SloWindow(window_s=60.0))
    tl = rec.begin_request({"X-Request-ID": "rf-1",
                            "X-Deadline-Ms": "5000"}, "/generate")
    assert tl.request_id == "rf-1"
    assert tl.meta["deadline_ms"] == 5000.0
    rec.placement(tl, replica="r0", affinity_blocks=3,
                  candidates=[{"replica": "r0", "score": 6.0,
                               "affinity_blocks": 3, "queue_depth": 0,
                               "in_flight": 1}],
                  t_start=tl.t_start, kv_donor="http://r1:8081")
    rec.attempt_failed(tl, replica="r0", reason="connect", retried=True)
    rec.first_byte(tl)
    rec.first_byte(tl)   # idempotent: only the first byte stamps TTFT
    rec.complete_request(tl, outcome="ok", replica="r1", status=200)
    rec.complete_request(tl, outcome="error")   # first outcome wins
    d = tl.to_dict()
    assert router_fleet.validate_router_timeline(d) == []
    names = [e["event"] for e in d["events"]]
    assert names.count("router_ttft") == 1
    for expected in ("router_place", "place", "kv_transfer_hint",
                     "retry", "finish"):
        assert expected in names, names
    place = next(e for e in d["events"] if e["event"] == "place")
    assert place["value"]["replica"] == "r0"
    assert place["value"]["candidates"][0]["score"] == 6.0
    assert d["meta"]["outcome"] == "ok" and d["meta"]["replica"] == "r1"
    # the connect failure landed one attempt row against r0; the final
    # ok (within its deadline) against r1
    snap = rec.slo.snapshot()
    assert snap["r0"]["outcomes"] == {"connect_fail": 1}
    assert snap["r1"]["attained"] == 1
    # and the recorder's completed ring serves /debug/requests
    assert rec.snapshot(limit=5)["completed"][0]["request_id"] == "rf-1"


def test_place_explained_matches_choice_evidence():
    table = ReplicaTable()
    table.add("r0", "http://a")
    table.add("r1", "http://b")
    blocks = table.affinity_blocks("shared system prompt " + "x" * 300)
    rep, dec = table.place_explained(blocks)
    table.record_placement(rep, blocks)
    rep2, dec2 = table.place_explained(blocks)
    # the sketch learned the prompt: the home replica wins with a
    # nonzero affinity match, and the evidence says so
    assert rep2.name == rep.name
    assert dec2["affinity_blocks"] > 0
    assert len(dec2["candidates"]) == 2
    by_name = {c["replica"]: c for c in dec2["candidates"]}
    assert by_name[rep.name]["score"] > by_name[
        "r1" if rep.name == "r0" else "r0"]["score"]
    assert dec["policy"] == "affinity"


# ------------------------------------------------- fleet snapshot (unit)


def _stub_replica(kill_mid_stream: bool = False):
    """A minimal replica app for kill scenarios: /generate streams two
    chunks; with ``kill_mid_stream`` it hard-closes the TCP transport
    after the first (a crashed pod, not a graceful error), and its
    /health dies with it."""
    from aiohttp import web

    state = {"dead": False}

    async def generate(request):
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "X-Request-ID": request.headers.get("X-Request-ID", "stub")})
        await resp.prepare(request)
        await resp.write(b"partial answer ")
        if kill_mid_stream:
            await asyncio.sleep(0.05)  # let the first chunk flush
            state["dead"] = True
            request.transport.close()
            return resp
        await resp.write(b"complete")
        await resp.write_eof()
        return resp

    async def health(request):
        if state["dead"]:
            request.transport.close()
            return web.Response()
        return web.json_response({
            "status": "ok", "draining": False, "breaker": "closed",
            "load": {"in_flight": 0, "queue_depth": 0,
                     "rejected_total": 0}})

    app = web.Application()
    app.router.add_post("/generate", generate)
    app.router.add_get("/health", health)
    return app


def _seeded_state(table_cls=ReplicaTable, window_cls=SloWindow):
    table = table_cls()
    table.add("r0", "http://r0:1")
    table.add("r1", "http://r1:1")
    table.update_health("r0", ok=True, body={
        "load": {"in_flight": 2, "queue_depth": 3, "rejected_total": 0,
                 "prefix_hit_rate": 0.5},
        "rounds": {"rounds_completed": 4, "tokens_per_sec": 300.0,
                   "wall_tokens_per_sec": 40.0, "avg_device_ms": 5.0,
                   "avg_bw_util": 0.2, "avg_drift_ratio": 1.0,
                   "interleaved_share": 0.1},
        "capacity": {"slots": 4, "decode_step_ms": 2.0,
                     "model_source": "test",
                     "capacity_tokens_per_sec": 2000.0},
        "kv_tier": {"host_pages": 7, "offload_pages": 9,
                    "restore_pages": 3, "transfer_pages": 1},
    })
    table.update_health("r1", ok=False)
    win = window_cls(window_s=600.0)
    win.record(replica="r0", outcome="ok", ttft_ms=10.0, duration_ms=20.0)
    win.record(replica="r1", outcome="connect_fail")
    win.record(replica=ROUTER_SELF, outcome="shed")
    return table, win


def test_fleet_snapshot_contract_and_headroom():
    table, win = _seeded_state()
    snap = router_fleet.build_fleet_snapshot(table, win, heartbeat_s=2.0)
    assert router_fleet.validate_fleet_snapshot(snap) == []
    rows = {r["name"]: r for r in snap["replicas"]}
    r0, r1 = rows["r0"], rows["r1"]
    # headroom = modeled capacity - observed wall token rate
    assert r0["capacity_tokens_per_sec"] == 2000.0
    assert r0["headroom_tokens_per_sec"] == 1960.0
    assert r0["kv_tier"]["host_pages"] == 7
    # the partitioned sibling: heartbeat failure counted, no telemetry
    assert r1["heartbeat_failures"] == 1 and not r1["reachable"]
    assert r1["rounds"] is None and r1["capacity"] is None
    assert r1["headroom_tokens_per_sec"] is None
    # fleet totals are sums of the rows (incl. the _router shed bucket
    # in window_requests — totals aggregate every outcome row)
    fl = snap["fleet"]
    assert fl["replicas_total"] == 2 and fl["replicas_placeable"] == 1
    assert fl["capacity_tokens_per_sec"] == 2000.0
    assert fl["headroom_tokens_per_sec"] == 1960.0
    assert fl["window_requests"] == 3
    assert fl["kv_tier_host_pages"] == 7
    # fleet attainment is REQUEST-level: the connect_fail attempt row
    # leaves the denominator (the request it belonged to has its own
    # terminal row); the shed and the ok remain -> 1 of 2
    assert fl["slo_attainment"] == 0.5


def test_fleet_capacity_counts_placeable_replicas_only():
    """A dead or draining replica's last-seen capacity block must not
    inflate the fleet headroom an autoscaler reads — lost capacity has
    to LOOK lost."""
    table, win = _seeded_state()
    before = router_fleet.build_fleet_snapshot(table, win, heartbeat_s=2.0)
    assert before["fleet"]["capacity_tokens_per_sec"] == 2000.0
    table.mark_draining("r0")
    snap = router_fleet.build_fleet_snapshot(table, win, heartbeat_s=2.0)
    rows = {r["name"]: r for r in snap["replicas"]}
    # the row keeps its numbers (state is visible right next to them)...
    assert rows["r0"]["capacity_tokens_per_sec"] == 2000.0
    assert rows["r0"]["draining"] and not rows["r0"]["placeable"]
    # ... but the fleet totals no longer count it
    assert snap["fleet"]["capacity_tokens_per_sec"] == 0.0
    assert snap["fleet"]["headroom_tokens_per_sec"] == 0.0


def test_fleet_validators_actually_fail():
    table, win = _seeded_state()
    snap = router_fleet.build_fleet_snapshot(table, win, heartbeat_s=2.0)
    import copy
    broken = copy.deepcopy(snap)
    broken["replicas"][0]["headroom_tps"] = \
        broken["replicas"][0].pop("headroom_tokens_per_sec")
    errs = router_fleet.validate_fleet_snapshot(broken)
    assert any("headroom_tokens_per_sec" in e for e in errs)
    assert any("unknown key" in e for e in errs)
    broken = copy.deepcopy(snap)
    broken["fleet"]["slo_attainment"] = "high"
    assert any("slo_attainment" in e
               for e in router_fleet.validate_fleet_snapshot(broken))
    # the timeline validator too (the preflight check leans on both)
    tl = {"request_id": "x", "started_unix_ms": 1, "age_ms": 1.0,
          "done": True, "meta": {}, "events": [{"t_ms": 0.1}],
          "events_dropped": 0}
    assert any("events[0]" in e
               for e in router_fleet.validate_router_timeline(tl))


def test_snapshots_and_timelines_pass_both_validators():
    """The port's fleet snapshot and router timeline pass the reference's
    validators, and the reference's pass the port's; a doctored snapshot
    fails both."""
    import copy

    from generativeaiexamples_tpu.router import fleet as jfleet
    from generativeaiexamples_tpu.router import flight as jflight
    from generativeaiexamples_tpu.router import table as jtable
    snaps = []
    for table_mod, flight_mod, fleet_mod in (
            (None, None, router_fleet), (jtable, jflight, jfleet)):
        if table_mod is None:
            table, win = _seeded_state()
        else:
            table, win = _seeded_state(table_mod.ReplicaTable,
                                       flight_mod.SloWindow)
        snaps.append(fleet_mod.build_fleet_snapshot(table, win,
                                                    heartbeat_s=2.0))
        rec = (RouterFlightRecorder() if flight_mod is None
               else flight_mod.RouterFlightRecorder())
        tl = rec.begin_request({"X-Request-ID": "v-1"}, "/generate")
        rec.placement(tl, replica="r0", affinity_blocks=2,
                      candidates=[{"replica": "r0", "score": 1.0}],
                      t_start=time.monotonic())
        rec.first_byte(tl)
        rec.complete_request(tl, outcome="ok", replica="r0", status=200)
        snaps.append(rec.snapshot(limit=5)["completed"][0])
    for validate_fleet, validate_tl in (
            (router_fleet.validate_fleet_snapshot,
             router_fleet.validate_router_timeline),
            (jfleet.validate_fleet_snapshot, jfleet.validate_router_timeline)):
        assert validate_fleet(snaps[0]) == [] == validate_fleet(snaps[2])
        assert validate_tl(snaps[1]) == [] == validate_tl(snaps[3])
        broken = copy.deepcopy(snaps[0])
        del broken["fleet"]["headroom_tokens_per_sec"]
        assert any("headroom_tokens_per_sec" in e
                   for e in validate_fleet(broken))
    assert set(snaps[0]) == set(snaps[2])
    assert set(snaps[0]["fleet"]) == set(snaps[2]["fleet"])
    assert [set(r) for r in snaps[0]["replicas"]] == \
        [set(r) for r in snaps[2]["replicas"]]


# ----------------------------------------------- live (echo replicas)


def test_debug_endpoints_and_heartbeat_blind_spot_live():
    """Echo-replica e2e: the router serves /debug/requests and
    /debug/fleet; a request's timeline lands with placement evidence and
    TTFT; a dead replica's heartbeat failures are counted in both the
    snapshot and the counter, not a silent breaker flip."""
    from generativeaiexamples_tpu_torch.chains.server import create_app

    async def fn():
        replica = TestServer(create_app(EchoExample()))
        await replica.start_server()
        router_app = create_router_app(
            [("r0", f"http://127.0.0.1:{replica.port}"),
             ("dead", "http://127.0.0.1:1")],   # nothing listens there
            policy="affinity", heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            fails0 = _snapshot(
                'router_heartbeat_failures_total{replica="dead"}')
            resp = await client.post(
                "/generate", json={"question": "hello fleet",
                                   "use_knowledge_base": False},
                headers={"X-Request-ID": "obs-live-1",
                         "X-Deadline-Ms": "30000"})
            assert resp.status == 200
            await resp.read()
            snap = await (await client.get(
                "/debug/requests?limit=10")).json()
            tl = next(t for t in snap["completed"]
                      if t["request_id"] == "obs-live-1")
            assert router_fleet.validate_router_timeline(tl) == []
            names = [e["event"] for e in tl["events"]]
            assert "place" in names and "router_ttft" in names
            assert tl["meta"]["outcome"] == "ok"
            assert tl["meta"]["replica"] == "r0"   # dead can't serve
            assert tl["meta"]["ttft_ms"] > 0
            # one heartbeat: the dead replica's failure is COUNTED, not
            # just a silent breaker flip
            await client.post("/control/heartbeat")
            fleet = await (await client.get("/debug/fleet")).json()
            assert router_fleet.validate_fleet_snapshot(fleet) == []
            rows = {r["name"]: r for r in fleet["replicas"]}
            assert rows["dead"]["heartbeat_failures"] >= 1
            assert not rows["dead"]["reachable"]
            assert rows["r0"]["heartbeat_failures"] == 0
            assert _snapshot(
                'router_heartbeat_failures_total{replica="dead"}') \
                - fails0 >= 1
            # ages published for scrape (the /metrics refresh path)
            body = await (await client.get("/metrics")).text()
            assert 'router_heartbeat_age_seconds{replica="r0"}' in body
            assert "router_ttft_seconds_bucket" in body
        finally:
            await client.close()
            await replica.close()

    _run(fn())


def test_router_slo_window_sees_midstream_loss_live():
    """A replica that dies mid-stream lands a midstream_loss outcome in
    the window and the fleet snapshot's rates reflect it."""
    async def fn():
        dying = TestServer(_stub_replica(kill_mid_stream=True))
        await dying.start_server()
        router_app = create_router_app(
            [("r0", f"http://127.0.0.1:{dying.port}")],
            policy="affinity", heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            resp = await client.post("/generate", json={"question": "q"},
                                     headers={"X-Request-ID": "loss-1"})
            assert resp.status == 200
            body = (await resp.read()).decode()
            assert "replica_lost" in body
            snap = await (await client.get("/debug/requests")).json()
            tl = next(t for t in snap["completed"]
                      if t["request_id"] == "loss-1")
            assert tl["meta"]["outcome"] == "midstream_loss"
            assert "midstream_loss" in [e["event"] for e in tl["events"]]
            fleet = (await (await client.get("/debug/fleet")).json())
            row = next(r for r in fleet["replicas"] if r["name"] == "r0")
            assert row["slo"]["midstream_loss_rate"] == 1.0
            assert fleet["fleet"]["midstream_loss_rate"] == 1.0
        finally:
            await client.close()
            await dying.close()

    _run(fn())


# --------------------------------------------- live (engine replicas)


@pytest.fixture(scope="module")
def obs_engines():
    import torch

    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = LlamaConfig(vocab_size=259 + 5, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16,
                      max_position_embeddings=1024)
    params = llama.init_params(cfg, seed=27, dtype=torch.float32,
                               device="cpu")
    ecfg = EngineConfig(
        max_slots=2, max_input_length=1024, max_output_length=32,
        prefill_buckets=(64,), max_prefill_bucket=64,
        dtype="float32", page_size=16, kv_pool_tokens=4096, max_queue=16,
        steps_per_round=4)
    engines = [Engine(params, cfg, ByteTokenizer(), ecfg, device="cpu")
               for _ in range(2)]
    for e in engines:
        e.start()
    yield engines
    for e in engines:
        e.stop()


def _engine_apps(engines):
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import (
        QAChatbot)
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
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


def _gen(question, context, rid=None, deadline_ms=None, num_tokens=6):
    headers = {}
    if rid:
        headers["X-Request-ID"] = rid
    if deadline_ms:
        headers["X-Deadline-Ms"] = str(deadline_ms)
    return ({"question": question, "context": context,
             "use_knowledge_base": False, "num_tokens": num_tokens},
            headers)


def test_acceptance_trace_join_and_partition_fleet_view(obs_engines,
                                                        monkeypatch):
    """(a) Trace join: one X-Request-ID appears in
    the router's /debug/requests, the replica's /debug/requests, and the
    engine round-record grant list. (b) Chaos: FAULT_PLAN partitions the
    busier replica — within one heartbeat /debug/fleet shows it
    breaker-open with window attainment dropping while fleet totals stay
    consistent; after recovery, a request's router timeline records the
    placement decision, the retry, and a router-observed TTFT that
    reconciles with the replica recorder's TTFT for the same ID."""
    engines = obs_engines
    # The window must comfortably cover the whole CPU-paced scenario.
    monkeypatch.setenv("ROUTER_SLO_WINDOW_S", "600")

    async def fn():
        servers = [TestServer(app) for app in _engine_apps(engines)]
        for s in servers:
            await s.start_server()
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        # Short breaker cooldown so recovery fits the test; everything
        # else production-default.
        table = ReplicaTable(breaker_failures=3, breaker_cooldown_s=2.0)
        router_app = create_router_app(
            [(f"r{i}", u) for i, u in enumerate(urls)], table=table,
            policy="affinity", heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        router = router_app[ROUTER]
        try:
            # Warm every geometry on BOTH replicas (compiles happen
            # here, not under measurement).
            async with aiohttp.ClientSession() as s:
                for url in urls:
                    for t in range(2):
                        body, _ = _gen(f"warm q{t} " + "w" * 30,
                                       "warm ctx " + "c" * 150)
                        async with s.post(f"{url}/generate",
                                          json=body) as resp:
                            assert resp.status == 200, await resp.text()
                            await resp.read()

            def session_ctx(i: int) -> str:
                return f"fleet-obs session {i} " + chr(97 + i) * 160

            # ---------------- (a) trace join
            body, headers = _gen("join question " + "q" * 30,
                                 session_ctx(0),
                                 rid="join-fleet-1", deadline_ms=60000)
            resp = await client.post("/generate", json=body,
                                     headers=headers)
            assert resp.status == 200
            join_rep = resp.headers["X-Routed-Replica"]
            join_i = int(join_rep[1])
            await resp.read()
            # router timeline, by the SAME id
            rsnap = await (await client.get(
                "/debug/requests?limit=20")).json()
            rtl = next(t for t in rsnap["completed"]
                       if t["request_id"] == "join-fleet-1")
            assert router_fleet.validate_router_timeline(rtl) == []
            assert rtl["meta"]["replica"] == join_rep
            # replica timeline, same id (the GLOBAL recorder serves the
            # in-process replicas' /debug/requests)
            async with aiohttp.ClientSession() as s:
                async with s.get(f"{urls[join_i]}/debug/requests") as r:
                    repl = await r.json()
            repl_tl = next(t for t in repl["completed"]
                           if t["request_id"] == "join-fleet-1")
            assert repl_tl["meta"]["generated"] > 0
            # engine round grants, same id — the JOIN contract, not
            # just header forwarding
            grant_ids = {rid for rec in obs_rounds.RECORDER.records()
                         for rid, _ in rec.grants}
            assert "join-fleet-1" in grant_ids

            # Seed 6 DISTINCT sessions (one turn each): the placement
            # tie-break rotation spreads them, and by pigeonhole one
            # replica homes >= 3. That side is the partition target —
            # each of its sessions' NEXT turn insists on it (their
            # prefix lives only in its sketch), so the partition's
            # connect failures are deterministic even after a retried
            # turn teaches the sibling one session's blocks.
            homes: dict = {}
            for i in range(6):
                body, headers = _gen(f"seed q{i} " + "q" * 30,
                                     session_ctx(i), deadline_ms=60000)
                resp = await client.post("/generate", json=body,
                                         headers=headers)
                assert resp.status == 200
                homes.setdefault(resp.headers["X-Routed-Replica"],
                                 []).append(i)
                await resp.read()
            home = max(homes, key=lambda k: len(homes[k]))
            home_i = int(home[1])
            sibling = f"r{1 - home_i}"
            assert len(homes[home]) >= 3

            # ---------------- (b) partition the home replica
            att0 = router.flight.slo.snapshot([home])[home]
            assert att0["attainment"] == 1.0  # every turn so far attained
            faults.set_plan(f"router.forward[{home}]=fail:conn; "
                            f"replica.heartbeat[{home}]=fail:conn")
            for i in homes[home]:
                body, headers = _gen(f"part q{i} " + "q" * 30,
                                     session_ctx(i), deadline_ms=60000)
                resp = await client.post("/generate", json=body,
                                         headers=headers)
                # the partition is invisible to callers: connect-phase
                # failures retry onto the sibling
                assert resp.status == 200
                assert resp.headers["X-Routed-Replica"] == sibling
                await resp.read()
            # within ONE heartbeat the fleet view shows the truth
            await client.post("/control/heartbeat")
            fleet = await (await client.get("/debug/fleet")).json()
            assert router_fleet.validate_fleet_snapshot(fleet) == []
            rows = {r["name"]: r for r in fleet["replicas"]}
            dead = rows[home]
            assert dead["breaker"] == "open" and not dead["placeable"]
            assert not dead["reachable"]
            assert dead["heartbeat_failures"] >= 1
            # attainment DROPPED: the connect_fail attempt rows count
            # against the partitioned replica's window
            att1 = dead["slo"]
            assert att1["outcomes"].get("connect_fail", 0) >= 3
            assert att1["attainment"] < (att0["attainment"] or 1.0)
            assert rows[sibling]["slo"]["attainment"] == 1.0
            # fleet totals stay CONSISTENT: the totals row aggregates
            # exactly the per-replica rows (no outcome lost or double-
            # counted by the retries), and the fleet attainment is
            # request-level — every retried request completed ok within
            # its deadline on the sibling, so CALLERS saw a perfect SLO
            # even while the partitioned replica's own window dropped
            per_rep = [r["slo"] for r in fleet["replicas"]]
            assert fleet["fleet"]["window_requests"] == sum(
                s["requests"] for s in per_rep)
            attained_sum = sum(s["attained"] for s in per_rep)
            terminal = sum(
                s["requests"] - s["outcomes"].get("connect_fail", 0)
                - s["outcomes"].get("disconnect", 0) for s in per_rep)
            assert fleet["fleet"]["slo_attainment"] == round(
                attained_sum / terminal, 4)
            assert fleet["fleet"]["slo_attainment"] == 1.0
            # engine-backed rows carry the heartbeat telemetry blocks
            sib = rows[sibling]
            assert sib["capacity"] is not None \
                and sib["capacity"]["capacity_tokens_per_sec"] > 0
            assert sib["rounds"] is not None \
                and sib["rounds"]["rounds_completed"] > 0
            assert sib["headroom_tokens_per_sec"] is not None

            # ---------------- recovery + TTFT reconciliation
            faults.clear()
            await asyncio.sleep(2.1)   # breaker cooldown elapses
            await client.post("/control/heartbeat")
            fleet = await (await client.get("/debug/fleet")).json()
            rows = {r["name"]: r for r in fleet["replicas"]}
            assert rows[home]["reachable"]
            assert rows[home]["breaker"] != "open"
            # one-shot connect fault, untagged: whichever replica the
            # next request is placed on fails ONCE at connect, so the
            # timeline deterministically records a retry before success.
            faults.set_plan("router.forward=fail:conn*1")
            body, headers = _gen("recover question " + "q" * 30,
                                 session_ctx(9),
                                 rid="recover-fleet-1",
                                 deadline_ms=60000)
            resp = await client.post("/generate", json=body,
                                     headers=headers)
            faults.clear()
            assert resp.status == 200
            served = resp.headers["X-Routed-Replica"]
            served_i = int(served[1])
            await resp.read()
            rsnap = await (await client.get(
                "/debug/requests?limit=20")).json()
            rtl = next(t for t in rsnap["completed"]
                       if t["request_id"] == "recover-fleet-1")
            events = [e["event"] for e in rtl["events"]]
            # placement decision, the retry, and the router TTFT are
            # all on ONE record
            assert events.count("place") == 2, events
            assert "retry" in events
            retry = next(e for e in rtl["events"]
                         if e["event"] == "retry")
            assert retry["value"]["reason"] == "connect"
            assert rtl["meta"]["outcome"] == "ok"
            router_ttft = rtl["meta"]["ttft_ms"]
            assert router_ttft and router_ttft > 0
            # ... and it reconciles with the replica flight recorder's
            # TTFT for the SAME request id: the router observes the
            # replica's TTFT plus edge overhead (never less), and on a
            # warmed engine that overhead is bounded.
            async with aiohttp.ClientSession() as s:
                async with s.get(
                        f"{urls[served_i]}/debug/requests") as r:
                    repl = await r.json()
            repl_tl = next(t for t in repl["completed"]
                           if t["request_id"] == "recover-fleet-1")
            replica_ttft = repl_tl["meta"]["ttft_ms"]
            assert replica_ttft and replica_ttft > 0
            assert router_ttft >= replica_ttft - 5.0, \
                (router_ttft, replica_ttft)
        finally:
            await client.close()
            for s in servers:
                await s.close()

    _run(fn())
