"""The port's autoscaler and surge admission (``router/autoscale.py``) on
the CPU: the scenarios of the reference's ``tests/test_autoscale.py`` over
port replicas.

Unit: the control law's leading indicators, cooldowns and min/max clamps
over synthetic evidence (the port's decisions equal the reference's); the
surge gate's bounded queue (measured Retry-After, the fast 429 for an
unmeetable deadline, wait grants); the decision-record and ``GET
/debug/autoscale`` contracts (and that the validator fails on doctored
payloads); an executor fault (``autoscale.execute``) lands in the record.
``LocalExecutor`` scales down only through the drain protocol and never
drains the prefill pool; ``KubeOperatorExecutor`` refuses at
construction until the operator is ported.

Chaos (port engine replicas behind the router): a burst over a
one-replica fleet scales up before the first shed and the activated
replica takes traffic (with ``ROUTER_KV_TRANSFER`` its first placement
carries the donor hint); a rolling restart under load loses no stream.
"""

import asyncio
import threading
import time

import pytest

import torch

import aiohttp  # noqa: F401 — skip cleanly where aiohttp is absent
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.router import autoscale as rauto
from generativeaiexamples_tpu_torch.router.flight import SloWindow
from generativeaiexamples_tpu_torch.router.server import (ROUTER, FleetRouter,
                                                    create_router_app)
from generativeaiexamples_tpu_torch.router.table import ReplicaTable
from generativeaiexamples_tpu_torch.utils import faults, resilience


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    resilience.reset_breakers()
    yield
    faults.clear()
    resilience.reset_breakers()


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


def _evidence(**over) -> dict:
    ev = {
        "snapshot_unix_ms": 0, "replicas_total": 2,
        "replicas_placeable": 2, "in_flight": 0, "queue_depth": 0,
        "queue_per_replica": 0.0, "queue_trend": 0.0,
        "utilization": 0.5, "tokens_per_sec": 1000.0,
        "capacity_tokens_per_sec": 2000.0,
        "headroom_tokens_per_sec": 1000.0, "shed_rate": 0.0,
        "slo_attainment": 1.0, "ttft_p50_ms": 100.0,
        "surge_queue_depth": 0,
    }
    ev.update(over)
    return ev


def _controller(policy=None, **kw) -> rauto.AutoscaleController:
    table = ReplicaTable()
    router = FleetRouter(table)
    return rauto.AutoscaleController(
        router, policy=policy or rauto.AutoscalePolicy(
            min_replicas=1, max_replicas=4),
        slo_ttft_ms=2000.0, **kw)


# ----------------------------------------------------------- control law


def test_decide_scale_up_on_each_leading_indicator():
    for over, needle in [
        ({"utilization": 0.9}, "utilization"),
        ({"queue_per_replica": 5.0, "queue_depth": 10}, "queue/replica"),
        ({"queue_per_replica": 2.5, "queue_depth": 5,
          "queue_trend": 1.5}, "queue rising"),
        ({"ttft_p50_ms": 1800.0}, "slack exhaustion"),
        ({"shed_rate": 0.2}, "late"),
    ]:
        ctl = _controller()
        action, reason, target = ctl._decide(_evidence(**over))
        assert action == "scale_up", (over, action, reason)
        assert needle in reason
        assert target >= 3    # at least current + 1


def test_decide_demand_model_sizes_to_target_util():
    ctl = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=1, max_replicas=10, target_util=0.5))
    # 2 replicas, 1900 of 2000 tok/s consumed: per-replica cap 1000,
    # demand = ceil(1900 / (1000 * 0.5)) = 4.
    action, _, target = ctl._decide(_evidence(
        utilization=0.95, tokens_per_sec=1900.0))
    assert action == "scale_up" and target == 4
    # ... and the max clamps it.
    ctl2 = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=1, max_replicas=3, target_util=0.5))
    action, _, target = ctl2._decide(_evidence(
        utilization=0.95, tokens_per_sec=1900.0))
    assert action == "scale_up" and target == 3


def test_decide_below_min_and_cooldown_and_surge_transitions():
    ctl = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=2, max_replicas=3, up_cooldown_s=100.0))
    action, reason, target = ctl._decide(_evidence(replicas_total=1))
    assert action == "scale_up" and target == 2
    assert "min_replicas" in reason
    # Cooldown: an overloaded fleet right after a scale-up is blocked.
    ctl._last_up_t = ctl._now()
    action, reason, _ = ctl._decide(_evidence(utilization=0.95))
    assert action == "blocked" and "cooldown" in reason
    # At max: overload flips surge ON (once), then holds.
    ctl2 = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=1, max_replicas=2))
    action, _, _ = ctl2._decide(_evidence(utilization=0.95))
    assert action == "surge_on"
    ctl2.surge.set_active(True)
    action, _, _ = ctl2._decide(_evidence(utilization=0.95))
    assert action == "hold"
    # Overload clears -> surge OFF before anything else.
    action, _, _ = ctl2._decide(_evidence(utilization=0.4))
    assert action == "surge_off"


def test_decide_scale_down_needs_stable_quiet_and_respects_min():
    ctl = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=1, max_replicas=4, down_stable_ticks=3,
        down_util=0.4, down_cooldown_s=0.0))
    quiet = _evidence(utilization=0.1, queue_depth=0,
                      queue_per_replica=0.0)
    assert ctl._decide(quiet)[0] == "hold"
    assert ctl._decide(quiet)[0] == "hold"
    action, _, target = ctl._decide(quiet)
    assert action == "scale_down" and target == 1
    # A busy tick resets the quiet counter.
    ctl2 = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=1, max_replicas=4, down_stable_ticks=2,
        down_cooldown_s=0.0))
    assert ctl2._decide(quiet)[0] == "hold"
    ctl2._decide(_evidence(queue_depth=3, queue_per_replica=1.5))
    assert ctl2._decide(quiet)[0] == "hold"   # counter restarted
    # Never below min.
    ctl3 = _controller(policy=rauto.AutoscalePolicy(
        min_replicas=2, max_replicas=4, down_stable_ticks=1,
        down_cooldown_s=0.0))
    at_min = _evidence(replicas_total=2, replicas_placeable=2,
                       utilization=0.05)
    assert ctl3._decide(at_min)[0] == "hold"


def test_scale_down_candidate_prefers_least_loaded_placeable():
    table = ReplicaTable()
    table.add("busy", "http://a")
    table.add("idle", "http://b")
    table.add("draining", "http://c")
    table.update_health("busy", ok=True, body={
        "load": {"in_flight": 4, "queue_depth": 2, "rejected_total": 0}})
    table.update_health("idle", ok=True, body={
        "load": {"in_flight": 0, "queue_depth": 0, "rejected_total": 0}})
    table.mark_draining("draining")
    assert table.scale_down_candidate() == "idle"
    assert table.scale_down_candidate(exclude=["idle"]) == "busy"
    table.mark_draining("busy")
    table.mark_draining("idle")
    assert table.scale_down_candidate() is None


# ------------------------------------------------------------ surge gate


def test_surge_gate_inactive_is_passthrough_and_counts():
    async def fn():
        gate = rauto.SurgeGate(queue_cap=2, concurrency=1)
        t1, rej = await gate.enter()
        t2, rej2 = await gate.enter()
        assert rej is None and rej2 is None
        assert gate.snapshot()["in_flight"] == 2
        gate.exit(t1)
        gate.exit(t2)
        assert gate.snapshot()["in_flight"] == 0
        # hold times fed the EWMA even while inactive
        assert gate.snapshot()["service_ewma_ms"] < 500.0

    _run(fn())


def test_surge_gate_rejections_and_measured_retry_after():
    async def fn():
        gate = rauto.SurgeGate(queue_cap=1, max_wait_s=0.05,
                               concurrency=1, service_prior_ms=400.0)
        gate.set_active(True)
        ticket, rej = await gate.enter()
        assert rej is None
        # Deadline below the estimate: fast 429 before queueing.
        _, rej = await gate.enter(deadline_ms=100.0)
        assert rej is not None and rej[0] == "deadline_unmeetable"
        # est = (0 waiters + 1) * 400 / 1 = the measured-prior estimate
        assert rej[1] == pytest.approx(400.0)
        # Big-deadline request queues... and times out (slot never freed)
        _, rej = await gate.enter(deadline_ms=60000.0)
        assert rej is not None and rej[0] == "surge_timeout"
        # Fill the queue, then overflow it.
        waiter = asyncio.ensure_future(gate.enter())
        await asyncio.sleep(0)   # let it enqueue
        _, rej = await gate.enter()
        assert rej is not None and rej[0] == "surge_queue_full"
        assert rej[1] > 0
        # Releasing the slot grants the queued waiter.
        gate.exit(ticket)
        t2, rej2 = await waiter
        assert rej2 is None
        gate.exit(t2)
        snap = gate.snapshot()
        assert snap["rejected"] == {"deadline_unmeetable": 1,
                                    "surge_timeout": 1,
                                    "surge_queue_full": 1}
        assert snap["admitted_total"] == 2

    _run(fn())


def test_surge_raised_concurrency_grants_queued_waiters():
    """A scale-up raising the gate's bound must admit queued waiters
    NOW — not leave them timing out against free slots (grants
    otherwise only happen on exit())."""
    async def fn():
        gate = rauto.SurgeGate(queue_cap=4, max_wait_s=5.0, concurrency=1)
        gate.set_active(True)
        ticket, _ = await gate.enter()
        waiter = asyncio.ensure_future(gate.enter())
        await asyncio.sleep(0)
        assert gate.snapshot()["queue_depth"] == 1
        gate.set_concurrency(2)
        t2, rej = await waiter
        assert rej is None
        gate.exit(ticket)
        gate.exit(t2)

    _run(fn())


def test_surge_explicit_concurrency_pins_against_controller():
    router = _seeded_router()
    pinned = rauto.SurgeGate(concurrency=4)
    ctl = rauto.AutoscaleController(
        router, policy=rauto.AutoscalePolicy(min_replicas=1,
                                             max_replicas=3),
        surge=pinned)
    _run(ctl.tick())
    assert pinned.concurrency == 4          # operator bound survives
    tracked = rauto.SurgeGate()             # default: controller-owned
    ctl2 = rauto.AutoscaleController(
        router, policy=rauto.AutoscalePolicy(min_replicas=1,
                                             max_replicas=3),
        surge=tracked)
    _run(ctl2.tick())
    assert tracked.concurrency == 8         # 1 placeable x 8/replica


def test_surge_queued_caller_disconnect_retires_timeline():
    """A caller that hangs up while WAITING in the surge queue — the
    common case during the exact overload the gate exists for — must
    retire its router timeline (outcome=disconnect), or the in-flight
    map grows one ghost per impatient caller for the server's life."""

    class _Req:
        headers: dict = {}
        path = "/generate"

    async def fn():
        router = FleetRouter(ReplicaTable())
        router.surge.set_concurrency(1)
        router.surge.set_active(True)
        slot, rej = await router.surge.enter()   # hold the only slot
        assert rej is None
        task = asyncio.ensure_future(router.forward(_Req()))
        await asyncio.sleep(0.05)                # parked in the queue
        assert router.surge.snapshot()["queue_depth"] == 1
        assert len(router.flight.snapshot()["in_flight"]) == 1
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        snap = router.flight.snapshot(limit=5)
        assert snap["in_flight"] == []
        assert snap["completed"][0]["meta"]["outcome"] == "disconnect"
        # the gate's own accounting is clean too
        assert router.surge.snapshot()["queue_depth"] == 0
        router.surge.exit(slot)
        assert router.surge.snapshot()["in_flight"] == 0

    _run(fn())


def test_surge_gate_deactivation_drains_waiters():
    async def fn():
        gate = rauto.SurgeGate(queue_cap=4, max_wait_s=5.0, concurrency=1)
        gate.set_active(True)
        ticket, _ = await gate.enter()
        waiter = asyncio.ensure_future(gate.enter())
        await asyncio.sleep(0)
        assert gate.snapshot()["queue_depth"] == 1
        gate.set_active(False)   # overload over: everyone queued admitted
        t2, rej = await waiter
        assert rej is None
        gate.exit(ticket)
        gate.exit(t2)

    _run(fn())


# -------------------------------------------- tick / record / contract


def _seeded_router(queue_depth=12, util_tps=3800.0) -> FleetRouter:
    table = ReplicaTable()
    table.add("r0", "http://r0:1")
    table.update_health("r0", ok=True, body={
        "load": {"in_flight": 4, "queue_depth": queue_depth,
                 "rejected_total": 0},
        "rounds": {"rounds_completed": 9, "tokens_per_sec": 4000.0,
                   "wall_tokens_per_sec": util_tps, "avg_device_ms": 5.0,
                   "avg_bw_util": 0.6, "avg_drift_ratio": 1.0,
                   "interleaved_share": 0.2},
        "capacity": {"slots": 8, "decode_step_ms": 2.0,
                     "model_source": "test",
                     "capacity_tokens_per_sec": 4000.0},
    })
    return FleetRouter(table)


def test_tick_records_decision_with_fleet_joined_evidence():
    router = _seeded_router()
    ctl = rauto.AutoscaleController(
        router, policy=rauto.AutoscalePolicy(min_replicas=1,
                                             max_replicas=3),
        executor=None, surge=router.surge)
    rec = _run(ctl.tick())
    # Wanted a scale-up (overloaded) but has no executor: blocked, with
    # the evidence still carrying exactly what /debug/fleet showed.
    assert rec["action"] == "blocked" and "no executor" in rec["reason"]
    assert rec["target_replicas"] == 2
    assert rec["evidence"]["queue_depth"] == 12
    assert rec["evidence"]["utilization"] == pytest.approx(0.95)
    fleet = router.refresh_fleet()["fleet"]
    assert rec["evidence"]["capacity_tokens_per_sec"] == \
        fleet["capacity_tokens_per_sec"]
    snap = ctl.snapshot()
    assert rauto.validate_autoscale_snapshot(snap) == []
    assert snap["decisions_total"]["blocked"] == 1
    assert snap["target_replicas"] == 2


def test_tick_not_leader_blocks_execution():
    router = _seeded_router()

    class Boom:
        async def scale_to(self, *a, **kw):  # pragma: no cover
            raise AssertionError("a non-leader must never execute")

    ctl = rauto.AutoscaleController(
        router, policy=rauto.AutoscalePolicy(min_replicas=1,
                                             max_replicas=3),
        executor=Boom(), surge=router.surge, leader=lambda: False)
    rec = _run(ctl.tick())
    assert rec["action"] == "blocked" and "not leader" in rec["reason"]
    assert not rec["executed"] and rec["leader"] is False


def test_tick_executor_fault_lands_in_record_and_retries():
    router = _seeded_router()

    class Flaky:
        calls = 0

        async def scale_to(self, target, **kw):
            Flaky.calls += 1
            return {"ok": True, "added": ["rX"], "removed": [],
                    "error": None, "detail": "t"}

    ctl = rauto.AutoscaleController(
        router, policy=rauto.AutoscalePolicy(
            min_replicas=1, max_replicas=3, up_cooldown_s=0.0),
        executor=Flaky(), surge=router.surge)
    faults.set_plan("autoscale.execute=fail*1")
    rec = _run(ctl.tick())
    assert rec["action"] == "scale_up" and not rec["executed"]
    assert rec["executor"]["ok"] is False
    assert "injected fault" in rec["executor"]["error"]
    assert Flaky.calls == 0
    # The loop survives and the next cycle retries the executor.
    rec2 = _run(ctl.tick())
    assert rec2["executed"] and rec2["executor"]["ok"]
    assert Flaky.calls == 1


def test_validator_actually_fails_on_doctored_payloads():
    router = _seeded_router()
    ctl = rauto.AutoscaleController(
        router, policy=rauto.AutoscalePolicy(min_replicas=1,
                                             max_replicas=3),
        surge=router.surge)
    _run(ctl.tick())
    import copy
    snap = ctl.snapshot()
    broken = copy.deepcopy(snap)
    del broken["decisions"][0]["evidence"]["queue_depth"]
    assert any("queue_depth" in e
               for e in rauto.validate_autoscale_snapshot(broken))
    broken = copy.deepcopy(snap)
    broken["decisions"][0]["action"] = "panic"
    assert any("panic" in e
               for e in rauto.validate_autoscale_snapshot(broken))
    broken = copy.deepcopy(snap)
    del broken["surge"]["queue_cap"]
    assert any("queue_cap" in e
               for e in rauto.validate_autoscale_snapshot(broken))


def test_slo_window_forget_drops_only_that_replica():
    win = SloWindow(window_s=600.0)
    win.record(replica="r0", outcome="error")
    win.record(replica="r0", outcome="ok", ttft_ms=5.0, duration_ms=9.0)
    win.record(replica="r1", outcome="ok", ttft_ms=5.0, duration_ms=9.0)
    assert win.forget("r0") == 2
    snap = win.snapshot(["r0", "r1"])
    assert snap["r0"]["requests"] == 0
    assert snap["r1"]["requests"] == 1


def test_decisions_equal_the_reference_over_a_grid():
    """The port's control law decides as the reference's on the same
    evidence and state: scale-ups on each leading indicator, the demand
    model, cooldowns, and the quiet-fleet scale-down."""
    from generativeaiexamples_tpu.router import autoscale as jauto
    from generativeaiexamples_tpu.router.server import FleetRouter as JRouter
    from generativeaiexamples_tpu.router.table import ReplicaTable as JTable

    def ctl(mod, router_cls, table_cls):
        return mod.AutoscaleController(
            router_cls(table_cls()), policy=mod.AutoscalePolicy(
                min_replicas=1, max_replicas=4, up_cooldown_s=0.0,
                down_cooldown_s=0.0, down_stable_ticks=2),
            slo_ttft_ms=2000.0)

    ours = ctl(rauto, FleetRouter, ReplicaTable)
    theirs = ctl(jauto, JRouter, JTable)
    grid = [_evidence(), _evidence(queue_per_replica=9.0, queue_depth=18),
            _evidence(utilization=0.97), _evidence(shed_rate=0.2),
            _evidence(ttft_p50_ms=1900.0), _evidence(surge_queue_depth=5),
            _evidence(utilization=0.05, tokens_per_sec=50.0),
            _evidence(utilization=0.05, tokens_per_sec=50.0),
            _evidence(utilization=0.05, tokens_per_sec=50.0),
            _evidence(replicas_placeable=4, replicas_total=4,
                      utilization=0.99),
            _evidence(replicas_total=0, replicas_placeable=0),
            _evidence(queue_per_replica=2.5, queue_depth=5,
                      queue_trend=1.5)]
    got = []
    for ev in grid:
        a, b = ours._decide(ev), theirs._decide(ev)
        assert a == b, (ev, a, b)
        got.append(a[0])
    assert {"scale_up", "scale_down", "surge_on"} <= set(got), got


def test_kube_operator_executor_refuses_until_the_operator_is_ported():
    from generativeaiexamples_tpu_torch.utils.errors import ConfigError
    with pytest.raises(ConfigError, match="A18"):
        rauto.KubeOperatorExecutor(object(), namespace="ns",
                                   pipeline="p", release="r")


def test_local_executor_scales_down_only_through_drain_never_prefill():
    """Scale-down picks the least-loaded placeable replica outside the
    prefill pool, drains it over the drain protocol (its /health turns
    503 draining, admission closes) before it leaves the table, and
    parks it; scale-up reopens and re-probes it. The prefill replica is
    never drained, even when it is all that is left."""
    from generativeaiexamples_tpu_torch.chains.server import (DRAIN_STATE,
                                                              create_app)

    class RoleExample(EchoExample):
        def __init__(self, role):
            import types
            self.llm = types.SimpleNamespace(engine=types.SimpleNamespace(
                role=role, stats={}, stalled=False))

    apps = {"p0": create_app(RoleExample("prefill")),
            "d0": create_app(RoleExample("decode")),
            "d1": create_app(RoleExample("decode"))}

    async def fn():
        servers = {n: TestServer(a) for n, a in apps.items()}
        for srv in servers.values():
            await srv.start_server()
        urls = {n: f"http://127.0.0.1:{srv.port}"
                for n, srv in servers.items()}
        table = ReplicaTable()
        router = FleetRouter(table, heartbeat_s=30)
        await router.start(run_heartbeat=False, run_autoscale=False)
        try:
            for n, u in urls.items():
                table.add(n, u)
            await router.heartbeat_once(force=True)
            assert {r["name"]: r["role"] for r in table.snapshot()} == \
                {"p0": "prefill", "d0": "decode", "d1": "decode"}
            table.update_health("p0", ok=True, body={
                "role": "prefill", "load": {"in_flight": 0}})
            table.update_health("d1", ok=True, body={
                "role": "decode", "load": {"in_flight": 2,
                                           "queue_depth": 3}})
            ex = rauto.LocalExecutor(router, drain_wait_s=5.0)
            out = await ex.scale_to(2, current=3, action="scale_down")
            assert out["ok"] and out["removed"] == ["d0"]
            assert apps["d0"][DRAIN_STATE].draining
            assert not apps["p0"][DRAIN_STATE].draining
            assert table.get("d0") is None and ex.parked == \
                [("d0", urls["d0"])]
            # Down to one replica: the decode replica goes, the prefill
            # replica stays; asked for none, nothing but prefill is left
            # and nothing is drained.
            out = await ex.scale_to(1, current=2, action="scale_down")
            assert out["removed"] == ["d1"]
            out = await ex.scale_to(0, current=1, action="scale_down")
            assert out["removed"] == []
            assert table.get("p0") is not None
            assert not apps["p0"][DRAIN_STATE].draining
            out = await ex.scale_to(3, current=len(table.replicas()),
                                    action="scale_up")
            assert "d0" in out["added"]
            assert not apps["d0"][DRAIN_STATE].draining
            assert table.get("d0").placeable()
        finally:
            await router.stop()
            for srv in servers.values():
                await srv.close()

    _run(fn())


# --------------------------------------------------- live (engine fleet)


@pytest.fixture(scope="module")
def scale_engines():
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

    cfg = LlamaConfig(vocab_size=259 + 5, hidden_size=64,
                      intermediate_size=128, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16,
                      max_position_embeddings=1024)
    params = llama.init_params(cfg, seed=29, dtype=torch.float32,
                               device="cpu")
    # ONE prefill bucket (compiles happen at warmup, not mid-scenario);
    # host KV tier ON so an activated replica can land transferred
    # pages; 2 slots so a burst builds a real dispatch queue.
    ecfg = EngineConfig(
        max_slots=2, max_input_length=1024, max_output_length=48,
        prefill_buckets=(64,), max_prefill_bucket=64,
        dtype="float32", page_size=16, kv_pool_tokens=4096, max_queue=32,
        steps_per_round=4, kv_host_pool_tokens=4096)
    engines = [Engine(params, cfg, ByteTokenizer(), ecfg, device="cpu")
               for _ in range(3)]
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


def _shed_total() -> float:
    return sum(v for k, v in obs_metrics.REGISTRY.snapshot().items()
               if k.startswith("shed_total{"))


def _gen_body(question, context, num_tokens=8, deadline_ms=None):
    headers = {}
    if deadline_ms:
        headers["X-Deadline-Ms"] = str(deadline_ms)
    return ({"question": question, "context": context,
             "use_knowledge_base": False, "num_tokens": num_tokens},
            headers)


@pytest.mark.chaos
def test_chaos_scale_up_during_burst_before_first_shed(scale_engines):
    """A Poisson-ish burst builds queue depth
    on the lone active replica; the controller's tick records scale_up
    with the queue evidence BEFORE any shed_total increment; the
    activated replica takes the next placement immediately and its
    first placement carries the KV-transfer donor hint."""
    engines = scale_engines[:2]

    async def fn():
        servers = [TestServer(app) for app in _engine_apps(engines)]
        for s in servers:
            await s.start_server()
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        table = ReplicaTable()

        def factory(router):
            executor = rauto.LocalExecutor(router, [("r1", urls[1])],
                                           drain_wait_s=10.0)
            policy = rauto.AutoscalePolicy(
                min_replicas=1, max_replicas=2, queue_high=2.0,
                up_cooldown_s=0.0)
            return rauto.AutoscaleController(
                router, policy=policy, executor=executor,
                surge=router.surge, slo_ttft_ms=60000.0)

        router_app = create_router_app(
            [("r0", urls[0])], table=table, policy="affinity",
            heartbeat_s=30, run_heartbeat=False, kv_transfer=True,
            autoscale_factory=factory, run_autoscale=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        try:
            # Warm every geometry on BOTH replicas directly (compiles
            # happen here, not under the measured burst).
            async with aiohttp.ClientSession() as s:
                for url in urls:
                    body, _ = _gen_body("warm q " + "w" * 30,
                                        "warm ctx " + "c" * 200)
                    async with s.post(f"{url}/generate",
                                      json=body) as resp:
                        assert resp.status == 200, await resp.text()
                        await resp.read()
            # Shared session context. ONE seeded turn through the router
            # while the fleet is idle teaches r0's affinity sketch the
            # context prefix — the donor coverage the post-scale hint
            # will point at.
            context = "burst session " + "x" * 240
            body, headers = _gen_body("seed q " + "q" * 30, context,
                                      num_tokens=4, deadline_ms=120000)
            async with client.post("/generate", json=body,
                                   headers=headers) as resp:
                assert resp.status == 200
                await resp.read()
            assert len(table.get("r0").sketch) >= 2
            shed0 = _shed_total()
            hints0 = obs_metrics.REGISTRY.snapshot().get(
                "router_kv_transfer_hints_total", 0.0)

            async def one(i: int):
                body, headers = _gen_body(
                    f"burst q{i} " + "q" * 30, context,
                    num_tokens=16, deadline_ms=120000)
                async with client.post("/generate", json=body,
                                       headers=headers) as resp:
                    assert resp.status == 200, await resp.text()
                    await resp.read()
                    return resp.headers.get("X-Routed-Replica")

            # Each dispatch is held 50 ms, so the burst is still queued on
            # r0 when the heartbeat reads it and when the post-scale
            # request is placed (the port's CPU engine would otherwise
            # finish it first under some loads).
            faults.set_plan("engine.dispatch=delay:0.05")
            burst = [asyncio.ensure_future(one(i)) for i in range(6)]
            # Let the burst hit r0's dispatch queue, then observe it the
            # way the production loop does: heartbeat -> tick.
            await asyncio.sleep(0.25)
            await client.post("/control/heartbeat")
            resp = await client.post("/control/autoscale",
                                     json={"op": "tick"})
            rec = await resp.json()
            # The scale-up decision landed BEFORE any shed: honest
            # leading-indicator scaling, not reaction to drops.
            assert rec["action"] == "scale_up", rec
            assert rec["target_replicas"] == 2
            assert rec["evidence"]["queue_depth"] >= 2
            assert _shed_total() == shed0
            assert rec["executed"] and rec["executor"]["added"] == ["r1"]
            # The activated replica is placeable NOW (probe-on-add).
            assert table.get("r1") is not None
            assert table.get("r1").placeable()
            # The fleet snapshot joins the decision's evidence.
            fleet = await (await client.get("/debug/fleet")).json()
            assert fleet["fleet"]["replicas_total"] == 2
            # While r0 still chews the burst, the next same-session
            # request places on the fresh replica WITH a donor hint
            # (r0's sketch covers the context prefix): the page
            # transfer's warm path instead of a cold prefill.
            body, headers = _gen_body("post-scale q " + "q" * 30,
                                      context, num_tokens=4,
                                      deadline_ms=120000)
            async with client.post("/generate", json=body,
                                   headers=headers) as resp2:
                assert resp2.status == 200
                served = resp2.headers.get("X-Routed-Replica")
                await resp2.read()
            faults.clear()
            assert served == "r1", served
            hints1 = obs_metrics.REGISTRY.snapshot().get(
                "router_kv_transfer_hints_total", 0.0)
            assert hints1 - hints0 >= 1
            routed = set(await asyncio.gather(*burst))
            assert routed == {"r0"}   # the burst itself stayed home
            # /debug/autoscale is live on the endpoint and validates.
            snap = await (await client.get("/debug/autoscale")).json()
            assert rauto.validate_autoscale_snapshot(snap) == []
            assert snap["decisions_total"].get("scale_up", 0) >= 1
        finally:
            await client.close()
            for s in servers:
                await s.close()

    _run(fn())


@pytest.mark.chaos
def test_chaos_rolling_restart_under_load(scale_engines):
    """Drain -> remove -> re-add each replica
    of a 3-replica fleet under continuous open-loop traffic. Zero
    mid-stream losses, zero 5xx — the only tolerated failure is 429
    backpressure — and every replica returns placeable with clean
    state."""
    engines = scale_engines

    async def fn():
        servers = [TestServer(app) for app in _engine_apps(engines)]
        for s in servers:
            await s.start_server()
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        names = [f"r{i}" for i in range(3)]
        table = ReplicaTable()
        router_app = create_router_app(
            list(zip(names, urls)), table=table, policy="affinity",
            heartbeat_s=0.2, run_heartbeat=True)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        rows: list[dict] = []
        stop = asyncio.Event()

        async def traffic(worker: int):
            i = 0
            while not stop.is_set():
                body, headers = _gen_body(
                    f"rr w{worker} q{i} " + "q" * 30,
                    f"rolling ctx {worker} " + "y" * 200,
                    num_tokens=8, deadline_ms=120000)
                row = {"status": None, "body": "", "worker": worker}
                try:
                    async with client.post("/generate", json=body,
                                           headers=headers) as resp:
                        row["status"] = resp.status
                        row["body"] = (await resp.read()).decode(
                            "utf-8", errors="replace")
                except aiohttp.ClientError as exc:
                    row["status"] = f"exc:{exc}"
                rows.append(row)
                i += 1
                await asyncio.sleep(0.02)

        try:
            # Warm all three replicas through the router first.
            async with aiohttp.ClientSession() as s:
                for url in urls:
                    body, _ = _gen_body("warm q " + "w" * 30,
                                        "warm ctx " + "c" * 200)
                    async with s.post(f"{url}/generate",
                                      json=body) as resp:
                        assert resp.status == 200
                        await resp.read()
            workers = [asyncio.ensure_future(traffic(w))
                       for w in range(3)]
            async def until(pred, timeout_s=60.0):
                """Wait on traffic by counting requests, not by the clock
                (the port's CPU engines run at the suite's load)."""
                deadline = time.monotonic() + timeout_s
                while not pred() and time.monotonic() < deadline:
                    await asyncio.sleep(0.02)
                assert pred(), len(rows)

            await until(lambda: len(rows) >= 3)
            for name, url in zip(names, urls):
                n0 = len(rows)
                resp = await client.post(
                    "/control/replicas",
                    json={"op": "remove", "name": name, "drain": True,
                          "wait_s": 30})
                assert resp.status == 200
                assert (await resp.json())["drained"]
                # Traffic keeps flowing while this replica is out.
                await until(lambda: len(rows) >= n0 + 2)
                # The pod "restarts": the in-process stand-in for a
                # fresh process is reopening its admission.
                async with aiohttp.ClientSession() as s:
                    await (await s.post(f"{url}/control/undrain")).read()
                resp = await client.post(
                    "/control/replicas",
                    json={"op": "add", "name": name, "url": url})
                assert resp.status == 200
                added = await resp.json()
                # ... and returns CLEAN: fresh sketch, closed breaker.
                assert added["replica"]["sketch_blocks"] == 0
                assert added["replica"]["breaker"] == "closed"
                assert added["replica"]["placeable"]
            await until(lambda: len(rows) >= 10)
            stop.set()
            await asyncio.gather(*workers)
            assert len(rows) >= 10
            statuses = {r["status"] for r in rows}
            # zero 5xx, zero transport errors: rollouts look like
            # backpressure (429) or success, never failure
            assert statuses <= {200, 429}, statuses
            for r in rows:
                if r["status"] == 200:
                    assert "[error]" not in r["body"], r
                    assert "replica_lost" not in r["body"], r
            # no mid-stream loss reached the router's outcome ring
            router = router_app[ROUTER]
            outcomes = router.flight.slo.snapshot()
            for name, stats in outcomes.items():
                if name.startswith("_"):
                    continue
                assert stats["outcomes"].get("midstream_loss", 0) == 0
            # the fleet is whole again
            await client.post("/control/heartbeat")
            fleet = await (await client.get("/debug/fleet")).json()
            assert fleet["fleet"]["replicas_placeable"] == 3
        finally:
            stop.set()
            await client.close()
            for s in servers:
                await s.close()

    _run(fn())


# --------------------------------------------------- heartbeat satellite


def test_heartbeat_stalled_replica_does_not_delay_siblings():
    """One replica's stalled probe (injected delay) must not hold up a
    sibling's health refresh: each probe applies its result the moment
    IT finishes, and the straggler is bounded by its own timeout."""
    from generativeaiexamples_tpu_torch.chains.server import create_app

    async def fn():
        replica = TestServer(create_app(EchoExample()))
        await replica.start_server()
        table = ReplicaTable()
        router_app = create_router_app(
            [("slow", f"http://127.0.0.1:{replica.port}"),
             ("fast", f"http://127.0.0.1:{replica.port}")],
            table=table, heartbeat_s=30, run_heartbeat=False)
        client = TestClient(TestServer(router_app))
        await client.start_server()
        router = router_app[ROUTER]
        try:
            faults.set_plan("replica.heartbeat[slow]=delay:0.8")
            t0 = time.monotonic()
            sweep = asyncio.ensure_future(router.heartbeat_once())
            await asyncio.sleep(0.3)
            fast = table.get("fast")
            # The fast sibling's health landed while the slow probe is
            # still sleeping in its executor thread.
            assert not sweep.done()
            assert fast.last_heartbeat_t >= t0
            assert fast.reachable
            await sweep
            assert table.get("slow").reachable   # delayed, not dead
        finally:
            faults.clear()
            await client.close()
            await replica.close()

    _run(fn())


def test_heartbeat_hung_probe_bounded_by_per_poll_timeout():
    from generativeaiexamples_tpu_torch.chains.server import create_app

    async def fn():
        replica = TestServer(create_app(EchoExample()))
        await replica.start_server()
        table = ReplicaTable()
        router_app = create_router_app(
            [("wedged", f"http://127.0.0.1:{replica.port}"),
             ("ok", f"http://127.0.0.1:{replica.port}")],
            table=table, heartbeat_s=30, run_heartbeat=False)
        router_app[ROUTER].heartbeat_timeout_s = 0.2
        client = TestClient(TestServer(router_app))
        await client.start_server()
        router = router_app[ROUTER]
        try:
            faults.set_plan("replica.heartbeat[wedged]=hang")
            t0 = time.monotonic()
            await router.heartbeat_once()
            # Bounded by timeout + slack, NOT by the 30 s hang cap.
            assert time.monotonic() - t0 < 5.0
            assert not table.get("wedged").reachable
            assert table.get("wedged").heartbeat_failures >= 1
            assert table.get("ok").reachable
        finally:
            faults.clear()
            await client.close()
            await replica.close()

    _run(fn())


def test_heartbeat_sweep_jitter_desynchronizes():
    table = ReplicaTable()
    router = FleetRouter(table, heartbeat_s=2.0, heartbeat_jitter=0.25)
    delays = [router._next_heartbeat_delay() for _ in range(64)]
    assert all(1.5 <= d <= 2.5 for d in delays)
    assert len({round(d, 6) for d in delays}) > 1   # actually jittered
    # jitter 0 pins the period exactly (the bench's determinism knob)
    router0 = FleetRouter(table, heartbeat_s=2.0, heartbeat_jitter=0.0)
    assert router0._next_heartbeat_delay() == 2.0
