"""The port's disaggregated prefill/decode (docs/disaggregation.md) against
the JAX package on the CPU.

- The role model: an unknown role is refused, ``ENGINE_ROLE`` beats the
  config, a prefill-role engine refuses decode-bound work with
  ``RoleMismatchError`` (a retryable 429 ``role_mismatch`` at the chain
  server, never a breaker trip), and the router's table keeps normal
  placements off prefill replicas, rotates among them and protects them
  from scale-down.
- The pricing rules ``handoff_beats_prefill`` and
  ``StepCostModel.handoff_cheaper`` answer as the reference's over a grid
  with the zero edges.
- ``KV_EXPORT_CONCURRENCY`` sheds a donor's export past the cap with 429.
- The acceptance pin: one prefill and one decode port replica behind the
  port router over real HTTP serve a long ``/generate`` through the
  two-leg handoff, token for token as a unified port replica and as the
  JAX engine's chain server on the same weights, over float32 and int8
  pools; and a mixed fleet, a JAX prefill replica pushing to a port decode
  replica, gives the same tokens (the blobs are byte-compatible).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from generativeaiexamples_tpu_torch.chains.examples.developer_rag import \
    QAChatbot
from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
from generativeaiexamples_tpu_torch.chains.server import (GENERATE_BREAKER,
                                                          create_app)
from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine.scheduler import StepCostModel
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.obs import metrics as obs_metrics
from generativeaiexamples_tpu_torch.router.server import create_router_app
from generativeaiexamples_tpu_torch.router.table import (
    ReplicaTable, handoff_beats_prefill)
from generativeaiexamples_tpu_torch.utils import faults, resilience
from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
from generativeaiexamples_tpu_torch.utils.configuration import from_dict
from generativeaiexamples_tpu_torch.utils.errors import (ConfigError,
                                                         RoleMismatchError)

PAGE = 16
CFG_KW = dict(vocab_size=259 + 5, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position_embeddings=1024)
CFG = LlamaConfig(**CFG_KW)
# The reference test's engine: chunked prefill under a 64-token bucket.
ENGINE_KW = dict(max_slots=2, max_input_length=1024, max_output_length=32,
                 prefill_buckets=(64,), max_prefill_bucket=64,
                 page_size=PAGE, dtype="float32", kv_pool_tokens=4096,
                 max_queue=32, steps_per_round=4)
APP = {"embeddings": {"model_engine": "hash", "dimensions": 32}}
APP_CFG = from_dict(AppConfig, APP)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy)."""
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    jparams = jllama.init_params(JL(**CFG_KW), jax.random.key(29),
                                 dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu", torch.float32, cfg=CFG)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # Roles, tiering and calibration are under the test's control.
    for var in ("ENGINE_ROLE", "KV_HOST_POOL_TOKENS", "KV_TRANSFER_ALLOW",
                "ROLE_PREFILL_MAX_TOKENS", "KV_EXPORT_CONCURRENCY",
                "SCHED_PROFILE_JSON", "ENGINE_SPEC_DECODE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")
    faults.clear()
    resilience.reset_breakers()
    yield
    faults.clear()
    resilience.reset_breakers()


def build_engine(params, role="unified", kv_quant="", host_tokens=16384):
    return Engine(params[1], CFG, ByteTokenizer(), EngineConfig(
        **ENGINE_KW, kv_quant=kv_quant, kv_host_pool_tokens=host_tokens,
        role=role), device="cpu")


def build_jax_engine(params, role="unified", kv_quant="",
                     host_tokens=16384):
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    return JEngine(params[0], JL(**CFG_KW), JTok(), JConfig(
        **ENGINE_KW, kv_quant=kv_quant, kv_host_pool_tokens=host_tokens,
        role=role))


def replica_app(eng):
    return create_app(QAChatbot(llm=EngineLLM(eng),
                                embedder=HashEmbedder(dim=32),
                                config=APP_CFG, fused_rag=False),
                      config=APP_CFG)


def jax_replica_app(eng):
    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JLLM
    from generativeaiexamples_tpu.chains.server import create_app as japp
    from generativeaiexamples_tpu.embed.encoder import HashEmbedder as JHash
    from generativeaiexamples_tpu.utils.app_config import AppConfig as JApp
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom
    cfg = jfrom(JApp, {**APP, "llm": {"model_engine": "tpu-jax"}})
    return japp(JBot(llm=JLLM(eng), embedder=JHash(dim=32), config=cfg,
                     fused_rag=False), config=cfg)


def _words(tag: str, n_chars: int) -> str:
    """Deterministic filler prose, seeded by the tag."""
    import hashlib
    h = int.from_bytes(hashlib.blake2b(tag.encode(),
                                       digest_size=4).digest(), "little")
    rng = np.random.RandomState(h)
    words, total = [], 0
    while total < n_chars:
        words.append("".join(chr(97 + c) for c in rng.randint(0, 26, 5)))
        total += 6
    return " ".join(words)[:n_chars]


def long_body(tag: str, n_chars: int = 550, num_tokens: int = 12) -> dict:
    return {"question": "What does the passage describe? " + tag,
            "context": _words(tag, n_chars),
            "use_knowledge_base": False, "num_tokens": num_tokens}


def _snap(name: str) -> float:
    return obs_metrics.REGISTRY.snapshot().get(name, 0.0)


def _fallbacks() -> float:
    return sum(_snap(f'router_disagg_fallbacks_total{{reason="{r}"}}')
               for r in ("prefill_error", "prefill_timeout", "no_pages"))


def _run(coro):
    loop = asyncio.get_event_loop_policy().new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ------------------------------------------------------------ role model

def test_engine_config_rejects_unknown_role():
    with pytest.raises(ConfigError, match="role"):
        EngineConfig(role="prefix")


def test_engine_role_env_beats_config(params, monkeypatch):
    monkeypatch.setenv("ENGINE_ROLE", "prefill")
    assert build_engine(params, role="unified").role == "prefill"
    monkeypatch.setenv("ENGINE_ROLE", "bogus")
    with pytest.raises(ConfigError, match="ENGINE_ROLE"):
        build_engine(params)


def test_prefill_role_engine_rejects_decode_bound_work(params, monkeypatch):
    """A prefill-role engine admits prefill-shaped requests and refuses
    decode-bound ones at submit, before any queue or slot state changes;
    a unified engine never hits the cap."""
    monkeypatch.setenv("ROLE_PREFILL_MAX_TOKENS", "2")
    eng = build_engine(params, role="prefill")
    prompt = [7] * (2 * PAGE)
    with eng:
        ok = eng.submit(prompt, SamplingParams(max_tokens=1, top_k=1,
                                               ignore_eos=True))
        ok.text()
        assert ok.finish_reason == "length"
        requests = eng.stats["requests"]
        with pytest.raises(RoleMismatchError, match="prefill-role"):
            eng.submit(prompt, SamplingParams(max_tokens=8, top_k=1))
        assert eng.stats["requests"] == requests
    uni = build_engine(params, role="unified")
    with uni:
        stream = uni.submit(prompt, SamplingParams(max_tokens=4, top_k=1,
                                                   ignore_eos=True))
        stream.text()
        assert stream.finish_reason == "length"


def test_role_mismatch_is_a_retryable_429_never_a_breaker_trip(params):
    eng = build_engine(params, role="prefill")

    async def fn():
        app = replica_app(eng)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            health = await (await client.get("/health")).json()
            assert health["role"] == "prefill"
            for _ in range(8):
                resp = await client.post("/generate", json={
                    "question": "q", "use_knowledge_base": False,
                    "num_tokens": 16})
                assert resp.status == 429
                body = await resp.json()
                assert body["error"]["type"] == "role_mismatch"
                assert "Retry-After" in resp.headers
            assert app[GENERATE_BREAKER].state == "closed"
        finally:
            await client.close()

    with eng:
        _run(fn())


def _table_with_roles(mod):
    table = mod.ReplicaTable()
    for name, role in (("p0", "prefill"), ("d0", "decode"),
                       ("d1", "decode")):
        table.add(name, f"http://{name}")
        table.update_health(name, ok=True, ready=True, body={"role": role})
    return table


def _tables():
    from generativeaiexamples_tpu.router import table as jtable
    from generativeaiexamples_tpu_torch.router import table as ptable
    return ptable, jtable


def test_prefill_replicas_never_take_normal_placements():
    """Short decode-bound requests never land on a prefill replica, even
    with the decode pool loaded and the prefill replica idle; the port's
    table decides as the reference's."""
    out = []
    for mod in _tables():
        table = _table_with_roles(mod)
        for rep in ("d0", "d1"):
            table.update_health(rep, ok=True, ready=True, body={
                "role": "decode", "load": {"in_flight": 5,
                                           "queue_depth": 9}})
        picks = []
        for _ in range(16):
            rep, decision = table.place_explained(())
            assert rep is not None and rep.name != "p0"
            assert all(c["replica"] != "p0" for c in decision["candidates"])
            picks.append(rep.name)
        assert table.place((), exclude=("d0", "d1")) is None
        out.append(picks)
    assert out[0] == out[1]


def test_prefill_candidate_selection_rotation_and_scale_down():
    for mod in _tables():
        table = _table_with_roles(mod)
        assert table.prefill_candidate().name == "p0"
        table.add("p1", "http://p1")
        table.update_health("p1", ok=True, ready=True,
                            body={"role": "prefill"})
        assert {table.prefill_candidate().name
                for _ in range(4)} == {"p0", "p1"}
        table.update_health("p0", ok=True, ready=True, body={
            "role": "prefill", "load": {"queue_depth": 7, "in_flight": 2}})
        assert table.prefill_candidate().name == "p1"
        table.mark_unreachable("p1")
        table.mark_draining("p0")
        assert table.prefill_candidate() is None
        table.update_health("d0", ok=True, ready=True, body={})
        table.update_health("d1", ok=True, ready=True, body={"role": "wat"})
        snap = {r["name"]: r["role"] for r in table.snapshot()}
        assert snap["d0"] == "unified" and snap["d1"] == "unified"

        table = _table_with_roles(mod)
        table.update_health("d0", ok=True, ready=True, body={
            "role": "decode", "load": {"in_flight": 1, "queue_depth": 0}})
        table.update_health("d1", ok=True, ready=True, body={
            "role": "decode", "load": {"in_flight": 3, "queue_depth": 2}})
        assert table.scale_down_candidate() == "p0"
        assert table.scale_down_candidate(exclude_roles=("prefill",)) == "d0"
        assert table.scale_down_candidate(
            exclude=("d0",), exclude_roles=("prefill",)) == "d1"
        assert table.scale_down_candidate(
            exclude=("d0", "d1"), exclude_roles=("prefill",)) is None


def test_roleless_fleet_places_byte_for_byte():
    """A fleet that never advertises a role places exactly as one
    advertising ``unified`` everywhere: the same replicas and the same
    decision evidence, request for request."""
    ptable, _ = _tables()
    bare, tagged = ptable.ReplicaTable(), ptable.ReplicaTable()
    for t in (bare, tagged):
        t.add("r0", "http://r0")
        t.add("r1", "http://r1")
    for name in ("r0", "r1"):
        tagged.update_health(name, ok=True, ready=True,
                             body={"role": "unified"})
    blocks = bare.affinity_blocks("x" * 400)
    bare.record_placement(bare._replicas["r1"], blocks)
    tagged.record_placement(tagged._replicas["r1"], blocks)
    for probe in (blocks, (), blocks[:1]):
        rep_a, dec_a = bare.place_explained(probe)
        rep_b, dec_b = tagged.place_explained(probe)
        assert rep_a.name == rep_b.name and dec_a == dec_b
    assert bare.prefill_candidate() is None
    assert tagged.prefill_candidate() is None


# ---------------------------------------------------------------- pricing

_LEGS = (0.0, 0.25, 0.5, 2.0)
_PREFILL = (0.0, 0.001, 0.125, 1.0)


@pytest.mark.parametrize("page_size", [None, 16, 128])
def test_handoff_beats_prefill_matches_the_reference(page_size):
    from generativeaiexamples_tpu.router.table import \
        handoff_beats_prefill as ref
    assert handoff_beats_prefill(None, 8192) is ref(None, 8192) is True
    assert handoff_beats_prefill({}, 8192) is ref({}, 8192) is True
    seen = set()
    for d2h in _LEGS:
        for h2d in _LEGS:
            for pf in _PREFILL:
                cap = {"d2h_ms_per_page": d2h, "h2d_ms_per_page": h2d,
                       "prefill_ms_per_token": pf}
                if page_size is not None:
                    cap["page_size"] = page_size
                for nbytes in (0, 1, 511, 4096, 8192, 100_000):
                    for bpt in (1.0, 4.0):
                        got = handoff_beats_prefill(cap, nbytes, bpt)
                        assert got == ref(cap, nbytes, bpt)
                        seen.add(got)
    assert seen == {True, False}
    cap = {"page_size": 128, "d2h_ms_per_page": 0.5,
           "h2d_ms_per_page": 0.5, "prefill_ms_per_token": 1.0}
    assert handoff_beats_prefill(cap, 8192)   # 16 ms vs 2048 ms
    assert not handoff_beats_prefill(dict(cap, prefill_ms_per_token=0.001),
                                     8192)
    assert not handoff_beats_prefill(
        {"d2h_ms_per_page": 0.5, "h2d_ms_per_page": 0.5}, 8192)


def test_step_cost_handoff_cheaper_matches_the_reference():
    from generativeaiexamples_tpu.engine.scheduler import \
        StepCostModel as JModel
    seen = set()
    for d2h in _LEGS:
        for h2d in _LEGS:
            for pf in _PREFILL:
                kw = dict(prefill_ms_per_token=pf, h2d_ms_per_page=h2d,
                          d2h_ms_per_page=d2h)
                ours, theirs = StepCostModel(**kw), JModel(**kw)
                for pages in (-1, 0, 1, 4, 64):
                    for page in (16, 128):
                        got = ours.handoff_cheaper(pages, page)
                        assert got == theirs.handoff_cheaper(pages, page)
                        seen.add(got)
    assert seen == {True, False}
    model = StepCostModel(prefill_ms_per_token=0.125)
    assert not model.handoff_cheaper(0, PAGE)
    assert model.handoff_cheaper(4, PAGE)        # unmeasured legs
    model = StepCostModel(prefill_ms_per_token=0.01, h2d_ms_per_page=0.5,
                          d2h_ms_per_page=0.5)
    assert not model.handoff_cheaper(4, PAGE)    # 4 ms > 0.64 ms


# ------------------------------------------------------ donor export bound

def test_kv_export_concurrency_bound_sheds_429(params, monkeypatch):
    """Past KV_EXPORT_CONCURRENCY exports at once the donor answers a
    retryable 429 (kv_export_busy, Retry-After) and counts
    kv_export_shed; once the slot frees, the retry succeeds."""
    monkeypatch.setenv("KV_EXPORT_CONCURRENCY", "1")
    eng = build_engine(params)
    release = asyncio.Event()

    async def fn():
        import threading
        gate = threading.Event()

        def slow_export(hashes):
            gate.wait(10)
            return b"", 0

        eng.export_blob = slow_export
        client = TestClient(TestServer(replica_app(eng)))
        await client.start_server()
        try:
            q = "/control/kv_pages?hashes=" + "ab" * 16
            first = asyncio.ensure_future(client.get(q))
            for _ in range(200):       # until the first holds the slot
                await asyncio.sleep(0.01)
                if eng.stats["kv_export_shed"] or first.done():
                    break
                resp = await client.get(q)
                if resp.status == 429:
                    body = await resp.json()
                    assert body["error"]["type"] == "kv_export_busy"
                    assert "Retry-After" in resp.headers
                    break
            gate.set()
            assert (await first).status == 200
            resp = await client.get(q)
            assert resp.status == 200
            release.set()
        finally:
            gate.set()
            await client.close()

    with eng:
        _run(fn())
    assert release.is_set()
    assert eng.stats["kv_export_shed"] == 1


# ----------------------------------------- the acceptance pin: the handoff

async def _text(client, body, **kw):
    resp = await client.post("/generate", json=body, **kw)
    assert resp.status == 200, await resp.text()
    out = (await resp.read()).decode()
    assert out and "[error]" not in out
    return out, resp


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_disagg_handoff_token_identical_over_real_http(params, monkeypatch,
                                                       kv_quant):
    """One prefill and one decode port replica behind the port router: a
    long prompt goes through the handoff (the prefill leg on p0, its pages
    pushed over HTTP into d0's host tier, d0's admission a prefix hit) and
    the text out equals, byte for byte, the same request on a unified port
    replica and on the JAX engine's chain server on the same weights. The
    pages d0 holds equal p0's bit for bit. Short requests never touch
    p0."""
    monkeypatch.setenv("ROUTER_DISAGG_MIN_PROMPT_BYTES", "400")
    prefill_eng = build_engine(params, "prefill", kv_quant)
    decode_eng = build_engine(params, "decode", kv_quant)
    unified_eng = build_engine(params, "unified", kv_quant)
    jax_eng = build_jax_engine(params, "unified", kv_quant)
    body = long_body("parity")

    async def fn():
        servers = [TestServer(replica_app(e))
                   for e in (unified_eng, prefill_eng, decode_eng)]
        servers.append(TestServer(jax_replica_app(jax_eng)))
        for s in servers:
            await s.start_server()
        ref_client, jax_client = TestClient(servers[0]), \
            TestClient(servers[3])
        client = TestClient(TestServer(create_router_app(
            [("p0", f"http://127.0.0.1:{servers[1].port}"),
             ("d0", f"http://127.0.0.1:{servers[2].port}")],
            policy="affinity", heartbeat_s=30, run_heartbeat=False)))
        await client.start_server()
        try:
            reference, _ = await _text(ref_client, body)
            jax_text, _ = await _text(jax_client, body)
            assert jax_text == reference

            await client.post("/control/heartbeat")
            snap = await (await client.get("/router/replicas")).json()
            assert {r["name"]: r["role"] for r in snap["replicas"]} == \
                {"p0": "prefill", "d0": "decode"}
            fleet = await (await client.get("/debug/fleet")).json()
            assert fleet["fleet"]["roles"] == {"prefill": 1, "decode": 1}

            h0, f0 = _snap("router_disagg_handoffs_total"), _fallbacks()
            computed0 = decode_eng.stats["sched_prefill_tokens"]
            answer, resp = await _text(client, body,
                                       headers={"X-Request-ID": "dis-1"})
            assert resp.headers["X-Routed-Replica"] == "d0"
            assert answer == reference
            assert _snap("router_disagg_handoffs_total") == h0 + 1
            assert _fallbacks() == f0

            # The handoff was real: exported on p0, pushed into d0's host
            # tier, restored at d0's admission, which computed at most one
            # page plus the tail.
            n_pages = prefill_eng.stats["kv_tier_export_pages"]
            assert n_pages > 0 and prefill_eng.stats["prefills"] >= 1
            assert decode_eng.stats["kv_tier_resumed_blocks"] == n_pages
            assert decode_eng.stats["kv_tier_restore_pages"] >= n_pages - 1
            prompt_len = len(prefill_eng.tokenizer.encode(
                APP_CFG.prompts.chat_template.format(
                    context_str=body["context"],
                    query_str=body["question"])))
            computed = decode_eng.stats["sched_prefill_tokens"] - computed0
            assert computed <= prompt_len - (n_pages - 1) * PAGE
            _assert_pages_equal(prefill_eng, decode_eng)

            dbg = await (await client.get("/debug/requests?limit=10")).json()
            tl = next(t for t in dbg["completed"]
                      if t["request_id"] == "dis-1")
            names = [e["event"] for e in tl["events"]]
            assert "router_disagg_prefill" in names
            assert "disagg_handoff" in names

            prefills = prefill_eng.stats["prefills"]
            _, resp = await _text(client, {
                "question": "short one?", "use_knowledge_base": False,
                "num_tokens": 4})
            assert resp.headers["X-Routed-Replica"] == "d0"
            assert _snap("router_disagg_handoffs_total") == h0 + 1
            assert prefill_eng.stats["prefills"] == prefills
        finally:
            for c in (client, ref_client, jax_client):
                await c.close()

    with prefill_eng, decode_eng, unified_eng, jax_eng:
        _run(fn())


def _assert_pages_equal(src, dst):
    """Every block the donor's prefix cache holds that the receiver holds
    too has the same pool bytes on both."""
    n = 0
    for h in list(src._prefix_cache._entries):
        a, b = src._prefix_cache.page_of(h), dst._prefix_cache.page_of(h)
        if a is None or b is None:
            continue
        for name, pool in src._state["cache"].items():
            assert torch.equal(pool[:, a], dst._state["cache"][name][:, b])
        n += 1
    assert n > 0


@pytest.mark.parametrize("kv_quant", ["", "int8"])
def test_mixed_fleet_jax_prefill_pushes_to_port_decode(params, monkeypatch,
                                                       kv_quant):
    """A JAX prefill replica hands off to a port decode replica behind the
    port router: the JAX package's blob lands in the port's host tier and
    the text equals the unified port replica's."""
    monkeypatch.setenv("ROUTER_DISAGG_MIN_PROMPT_BYTES", "400")
    jax_prefill = build_jax_engine(params, "prefill", kv_quant)
    decode_eng = build_engine(params, "decode", kv_quant)
    unified_eng = build_engine(params, "unified", kv_quant)
    body = long_body("mixed")

    async def fn():
        servers = [TestServer(replica_app(unified_eng)),
                   TestServer(jax_replica_app(jax_prefill)),
                   TestServer(replica_app(decode_eng))]
        for s in servers:
            await s.start_server()
        ref_client = TestClient(servers[0])
        client = TestClient(TestServer(create_router_app(
            [("p0", f"http://127.0.0.1:{servers[1].port}"),
             ("d0", f"http://127.0.0.1:{servers[2].port}")],
            policy="affinity", heartbeat_s=30, run_heartbeat=False)))
        await client.start_server()
        try:
            reference, _ = await _text(ref_client, body)
            await client.post("/control/heartbeat")
            h0 = _snap("router_disagg_handoffs_total")
            answer, resp = await _text(client, body)
            assert resp.headers["X-Routed-Replica"] == "d0"
            assert answer == reference
            assert _snap("router_disagg_handoffs_total") == h0 + 1
            assert jax_prefill.stats["kv_tier_export_pages"] > 0
            assert decode_eng.stats["kv_tier_resumed_blocks"] == \
                jax_prefill.stats["kv_tier_export_pages"]
            assert decode_eng.stats["kv_tier_restore_pages"] > 0
            assert decode_eng.stats["kv_restore_corrupt"] == 0
        finally:
            await client.close()
            await ref_client.close()

    with jax_prefill, decode_eng, unified_eng:
        _run(fn())


def test_roleless_fleet_never_enters_disagg_path(params, monkeypatch):
    """With no prefill-role replica the same long prompt takes the plain
    placement path: no handoff, no fallback, no prefill-leg event."""
    monkeypatch.setenv("ROUTER_DISAGG_MIN_PROMPT_BYTES", "400")
    eng = build_engine(params)

    async def fn():
        server = TestServer(replica_app(eng))
        await server.start_server()
        client = TestClient(TestServer(create_router_app(
            [("r0", f"http://127.0.0.1:{server.port}")],
            policy="affinity", heartbeat_s=30, run_heartbeat=False)))
        await client.start_server()
        try:
            await client.post("/control/heartbeat")
            h0, f0 = _snap("router_disagg_handoffs_total"), _fallbacks()
            await _text(client, long_body("roleless"),
                        headers={"X-Request-ID": "nr-1"})
            assert _snap("router_disagg_handoffs_total") == h0
            assert _fallbacks() == f0
            dbg = await (await client.get("/debug/requests?limit=10")).json()
            tl = next(t for t in dbg["completed"]
                      if t["request_id"] == "nr-1")
            assert "router_disagg_prefill" not in \
                [e["event"] for e in tl["events"]]
        finally:
            await client.close()
            await server.close()

    with eng:
        _run(fn())
